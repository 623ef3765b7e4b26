"""K8 against its plain version bit for bit on a card (marker ``cuda``;
skipped without one) for C = 1, 3 and 5.

Inputs and what is held: ``tests/_torch_warp_tiles.py``.
"""

import importlib.util
import pathlib

import pytest
import torch

from ripcurrents_tpu_torch.flow import warp_kernel as wk

torch.set_num_threads(1)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("channels,bres", [(1, 2), (3, 6), (5, 2)])
def test_k8_matches_plain_on_card(card, channels, bres):
    """K8 in its frame layout at 640x480 (tile 64 x 256) and at a ragged
    75x107 (its scalar path) equals its plain version bit for bit."""
    cs = _chip_smoke()
    for h, w in ((480, 640), (75, 107)):
        table, flow = cs.frame_tiles_inputs(h, w, channels, bres, card)
        n = wk.warp_tiles.launches
        got = wk.warp_tiles(table, flow, None, 64, 256, bres)
        assert wk.warp_tiles.launches == n + 1
        plain = wk.warp_tiles_plain(table, flow, None, 64, 256, bres)
        assert got.shape == (h, w, channels)
        assert (got - plain).abs().max().item() <= cs.TILES_TOL
