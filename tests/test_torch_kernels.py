"""The Hopper kernels K1-K4 and the level loop against their plain
PyTorch versions, on the card. These are the checks chip_smoke.py runs
(its check functions, its tolerances). Without a card every test skips:
a CUDA kernel has no CPU interpret mode, and the CPU tests hold the plain
versions to the JAX kernels instead."""

import importlib.util
import pathlib

import pytest
import torch

from ripcurrents_tpu_torch.config import FarnebackParams, LKParams

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("hw,preset,iterations", [
    ((40, 300), "legacy", 2),          # ragged tiles, width not /128
    ((480, 640), "legacy", 2),         # the legacy main path, level 0
    ((1080, 1920), "windowed", 1),     # the 1080p windowed level 0
])
def test_kernels_match_plain_versions(card, hw, preset, iterations):
    cs = _chip_smoke()
    devs = cs.check_kernels(*hw, getattr(FarnebackParams, preset)(), card,
                            iterations=iterations)
    assert devs["k1_share"] <= cs.K1_FRAC


def test_legacy_step_on_card_matches_cpu(card):
    out = _chip_smoke().compare_legacy_small(card)
    assert out["mask_iou"] >= 0.99


def test_legacy_main_path_launches_both_kernels(card):
    _, _, launches, _ = _chip_smoke().run_legacy(
        card, frames=40, xdim=320, ydim=240, raw_hw=(360, 640))
    assert launches == (6 * 40, 6 * 40, 2 * 40, 3 * 40, 3 * 40)


@pytest.mark.parametrize("hw,preset", [((480, 640), "legacy"),
                                       ((1080, 1920), "windowed"),
                                       ((75, 107), "legacy")])
def test_resize_kernel_matches_plain_and_dense(card, hw, preset):
    cs = _chip_smoke()
    devs = cs.check_resize(*hw, getattr(FarnebackParams, preset)(), card)
    assert devs["k4_vs_plain"] <= cs.K4_TOL


@pytest.mark.parametrize("n,streams,preset", [(201, 1, "particles"),
                                              (1280, 1, "particles"),
                                              (201, 2, "particles"),
                                              (192, 1, "red_points")])
def test_lk_kernel_matches_plain_version(card, n, streams, preset):
    cs = _chip_smoke()
    res = cs.check_lk(card, n, streams=streams,
                      p=getattr(LKParams, preset)())
    assert res["share_within"] >= cs.LK_SHARE


def test_timelines_on_card_matches_cpu_and_launches_the_kernel(card):
    cs = _chip_smoke()
    out = cs.compare_timelines_small(card)
    assert out["vertex_max_px"] <= cs.MODE_VERTEX_PX
    _, _, launches, _, _ = cs.run_mode(card, "timelines", 6)
    assert launches == 6
