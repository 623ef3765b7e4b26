"""K8's base-sum order emulated on the CPU against ``tile_bases_plain``
bit for bit, and its in-kernel tile count against ``frame_counts``.

Inputs and what is held: ``tests/_torch_warp_tiles.py``.
"""

import numpy as np
import pytest
import torch

from ripcurrents_tpu_torch.flow import warp_kernel as wk

from _torch_warp_tiles import (H100, NO16, _emulated_bases, _flows,
                               _kernel_counts)

torch.set_num_threads(1)


@pytest.mark.parametrize("layout", ["frame", "halo"])
def test_emulated_base_order_matches_plain_bit_for_bit(layout):
    if layout == "frame":
        cases = [((75, 107), (24, 128), 9), ((120, 160), (24, 128), 2),
                 ((72, 136), (24, 128), 6)]
    else:                                 # padded (hp, wp), (th, sw) tiles
        cases = [((96, 256), (24, 128), 30), ((48, 256), (24, 128), 2)]
    for (h, w), (th, tw), lim in cases:
        flow = _flows(h, w, seed=h + w)
        if layout == "frame":
            counts = wk.frame_counts(h, w, th, tw, "cpu")
        else:
            counts = torch.full((h // th, w // tw), float(th * tw))
        want = wk.tile_bases_plain(flow, counts, th, tw, lim, lim).numpy()
        for active in (H100, NO16):
            plan = wk.tiles_plan(h, w, th, tw, active)
            got = _emulated_bases(flow, th, tw, plan, counts, lim, lim,
                                  layout == "halo")
            np.testing.assert_array_equal(got, want)
        assert want[0, 0, 0] == 2 and want[1, 0, 0] == -2   # ties to even
        assert (np.abs(want) == lim).any()                   # clamped


def test_kernel_tile_counts_match_frame_counts():
    for h, w in ((480, 640), (240, 320), (120, 160), (75, 107), (1080, 1920),
                 (7, 9), (72, 136)):
        for th, tw in ((64, 256), (56, 128), (24, 128), (8, 128), (120, 384),
                       (200, 512)):
            np.testing.assert_array_equal(
                _kernel_counts(h, w, th, tw),
                wk.frame_counts(h, w, th, tw, "cpu").numpy())
