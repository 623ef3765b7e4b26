"""The Hopper kernels K5 (prep_y), K6 (prep_x3) and K7 (warp5_shift)
against their plain PyTorch versions, and the dense Farneback modes, on
the card. These are the checks chip_smoke.py runs (its check functions,
its tolerances: K5, K6 and K7 bit for bit). Without a card every test
skips: a CUDA kernel has no CPU interpret mode, and the CPU tests hold the
plain versions to the JAX kernels instead."""

import dataclasses
import importlib.util
import pathlib

import pytest
import torch

from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.pipelines.common import ModeConfig

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


@pytest.mark.parametrize("hw,preset,channels_first", [
    ((480, 640), "legacy", True),              # the legacy main path
    ((1080, 1920), "windowed", True),          # the 1080p windowed stream
    ((480, 640), "subtract_average", False),   # the portable engine
    ((75, 107), "legacy", True),               # ragged, width not /128
])
def test_prep_kernels_match_plain_versions(card, hw, preset, channels_first):
    cs = _chip_smoke()
    p = dataclasses.replace(getattr(FarnebackParams, preset)(),
                            warp_impl="fused" if channels_first else "pallas")
    devs = cs.check_prep(*hw, p, card)
    assert devs["k5_vs_plain"] <= cs.PREP_TOL
    assert devs["k6_vs_plain"] <= cs.PREP_TOL


@pytest.mark.parametrize("hw,budget,flow_px", [((480, 640), 16, 24.0),
                                               ((75, 107), 4, 7.0)])
def test_warp_kernel_matches_plain_version(card, hw, budget, flow_px):
    cs = _chip_smoke()
    devs = cs.check_warp(*hw, card, budget=budget, flow_px=flow_px)
    assert devs["max_all"] <= cs.WARP_TOL


def test_portable_engine_launches_the_warp_kernel(card):
    """subtructAverageVector on the portable engine: K7 9 times a frame
    (3 levels x 3 iterations), K5 and K6 3 times, no fused-engine
    kernel."""
    n = 4
    _, _, launches, _ = _chip_smoke().run_dense_mode(
        card, "subtructAverageVector", n,
        ModeConfig(xdim=320, ydim=240, warp_impl="pallas"), raw_hw=(360, 640))
    assert launches == {"K1": 0, "K2": 0, "K3": 0, "K4": 0,
                        "K5": 3 * (n + 1), "K6": 3 * (n + 1), "K7": 9 * n}


@pytest.mark.parametrize("mode", ["subtructAverageVectorWithWindow",
                                  "timelinesFarne", "averageVector"])
def test_dense_mode_runs_on_card(card, mode):
    n = 4
    _, _, launches, out = _chip_smoke().run_dense_mode(
        card, mode, n, ModeConfig(xdim=320, ydim=240, average_buffer=300),
        raw_hw=(360, 640))
    assert out.shape == (240, 320, 3)
    assert launches["K5"] == launches["K6"] == 3 * (n + 1)
    assert launches["K1"] == launches["K2"] == 9 * n


def test_dense_mode_on_card_matches_cpu(card):
    cs = _chip_smoke()
    out = cs.compare_dense_small(card)
    assert out["ring_mean_median_px"] <= cs.DENSE_MEDIAN_PX
    assert out["ring_mean_p99_px"] <= cs.DENSE_P99_PX
    assert out["pixels_equal"] >= cs.DENSE_PIXEL_SHARE
