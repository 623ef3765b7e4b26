"""The Hopper kernels K1 and K2 and the level loop against their plain
PyTorch versions, on the card. These are the checks chip_smoke.py runs
(its check functions, its tolerances). Without a card every test skips:
a CUDA kernel has no CPU interpret mode, and the CPU tests hold the plain
versions to the JAX kernels instead."""

import importlib.util
import pathlib

import pytest
import torch

from ripcurrents_tpu_torch.config import FarnebackParams

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
    assert launches == (6 * 40, 6 * 40)
