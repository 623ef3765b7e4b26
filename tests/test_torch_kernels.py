"""The Hopper kernels K1-K4 and the level loop against their plain
PyTorch versions, on the card (K1, K2 and K4 at every pyramid level, K3
with points that cross the image edge and move past its J patch). These
are the checks chip_smoke.py runs (its check functions, its tolerances).
Without a card every test skips: a CUDA kernel has no CPU interpret mode,
and the CPU tests hold the plain versions to the JAX kernels instead."""

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


@pytest.mark.parametrize("hw,preset", [
    ((480, 640), "legacy"),            # 2, 6 and 15 base blocks
    ((1080, 1920), "windowed"),        # 4, 16 and 27
    ((40, 300), "legacy"),             # 1, 2 and 3, ragged
])
def test_update_kernel_matches_plain_at_every_level(card, hw, preset):
    """K1 (one cluster of S CTAs per base block) against its plain version
    at every level of the pyramid, the 1- and 2-block coarse levels
    included; update_levels raises past K1_REL / K1_FRAC."""
    rows, _ = _chip_smoke().update_levels(*hw, getattr(FarnebackParams,
                                                       preset)(), card,
                                          reps=0)
    assert len(rows) == 3
    for r in rows:
        assert r["differing_share"] <= _chip_smoke().K1_FRAC
        assert r["ctas"] == r["blocks"] * r["S"]
    if hw == (480, 640):
        assert rows[-1]["ctas"] >= 120
    if hw == (40, 300):
        assert [r["blocks"] for r in rows[:2]] == [1, 2]


def test_lk_kernel_refreshes_its_patch_and_matches_plain(card):
    """Points that move farther than the J patch's margin inside one level
    (the kernel copies its patch again) agree with the plain version."""
    res = _chip_smoke().check_lk_far(card)
    assert res["share_within"] >= _chip_smoke().LK_SHARE


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


@pytest.mark.parametrize("hw,preset", [
    ((480, 640), "legacy"),            # box 3
    ((480, 640), "windowed"),          # Gaussian 10, the dense modes
    ((480, 640), "subtract_average"),  # Gaussian 20
    ((1080, 1920), "windowed"),        # the 1080p stream
    ((480, 640), "android"),           # 4 levels, box 5
    ((75, 107), "legacy"),             # ragged
    ((40, 300), "legacy"),
    ((40, 300), "subtract_average"),   # levels shorter than the window
])
def test_blur_and_upsample_kernels_match_plain_at_every_level(card, hw,
                                                              preset):
    """K2 at every level (pads zeroed; at level 0 also not) and K4 at
    every level change, bit for bit with their plain versions; the checks
    raise on a nonzero pad."""
    cs = _chip_smoke()
    p = getattr(FarnebackParams, preset)()
    assert cs.check_blur(*hw, p, card)["k2_vs_plain"] == 0.0
    assert cs.check_resize(*hw, p, card)["k4_vs_plain"] == 0.0


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
