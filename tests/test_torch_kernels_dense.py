"""The Hopper kernels K5 (prep_y), K6 (prep_x3), K7 (warp5_shift) and K8
(warp_tiles) against their plain PyTorch versions, and the dense
Farneback modes, on the card. These are the checks chip_smoke.py runs
(its check functions, its tolerances: K5-K8 bit for bit). Without a card every test
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
    ((480, 640), "android", True),             # 4 levels, a 260-tap L3
    ((40, 300), "legacy", True),               # one-tile coarse levels
])
def test_prep_kernels_match_plain_versions(card, hw, preset, channels_first):
    cs = _chip_smoke()
    p = dataclasses.replace(getattr(FarnebackParams, preset)(),
                            warp_impl="fused" if channels_first else "pallas")
    devs = cs.check_prep(*hw, p, card)
    assert devs["k5_vs_plain"] <= cs.PREP_TOL
    assert devs["k6_vs_plain"] <= cs.PREP_TOL


def test_prep_kernels_pair_columns_over_odd_widths(card, monkeypatch):
    """K5 and K6 with two columns a thread forced at every level of the
    75x107 pyramid (level widths 27, 54 and 107: the last K6 pair of an
    odd width holds one real column)."""
    from ripcurrents_tpu_torch.flow import prep_kernel
    monkeypatch.setattr(prep_kernel, "WARPS_PER_SM", 0)
    cs = _chip_smoke()
    cs.fb._prep_windows_on.cache_clear()
    try:
        devs = cs.check_prep(75, 107, FarnebackParams.legacy(), card)
    finally:
        cs.fb._prep_windows_on.cache_clear()
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
                        "K5": 3 * (n + 1), "K6": 3 * (n + 1), "K7": 9 * n,
                        "K8": 0}


def test_warp_tiles_kernel_matches_plain_version(card):
    """K8 in its halo layout at 1080p (both bench_warp configurations, and
    its no-base instance) and its frame layout at 640x480."""
    cs = _chip_smoke()
    devs = cs.check_tiles(card)
    assert max(max(r["max"], r.get("nobase_max", 0.0))
               for r in devs.values()) <= cs.TILES_TOL


def test_tiled_engine_launches_k8_and_matches_cpu(card):
    """subtructAverageVector on the tiled warp: K8 9 times a frame, K5 and
    K6 3 times, nothing else; at 192x256 the tiled engine's windowed mode
    on the card agrees with the CPU."""
    n = 4
    cs = _chip_smoke()
    _, _, launches, _ = cs.run_dense_mode(
        card, "subtructAverageVector", n,
        ModeConfig(xdim=320, ydim=240, warp_impl="tiled"), raw_hw=(360, 640))
    assert launches == {"K1": 0, "K2": 0, "K3": 0, "K4": 0,
                        "K5": 3 * (n + 1), "K6": 3 * (n + 1), "K7": 0,
                        "K8": 9 * n}
    out = cs.compare_dense_small(card, cfg=cs.TILED_SMALL)
    assert out["ring_mean_median_px"] <= cs.DENSE_MEDIAN_PX
    assert out["ring_mean_p99_px"] <= cs.DENSE_P99_PX
    assert out["pixels_equal"] >= cs.DENSE_PIXEL_SHARE


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
