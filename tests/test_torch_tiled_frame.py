"""K8's plain version in its frame layout against JAX ``_warp5_tiled``,
and the wrapper's checks.

Inputs and tolerances: ``tests/_torch_tiled.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu_torch.flow import farneback as tfb
from ripcurrents_tpu_torch.flow import warp_kernel as wk

from _torch_tiled import REL, _frame_inputs, jfb


@pytest.mark.parametrize("h,w,bres,tile", [(96, 128, 2, (64, 256)),
                                           (120, 160, 4, (24, 128)),
                                           (120, 160, 2, (32, 128))])
def test_plain_k8_frame_layout_matches_jax_warp5_tiled(h, w, bres, tile):
    _, r1, flow = _frame_inputs(h, w, bres, seed=h + bres)
    th, tw = tile
    want, win = jax.jit(functools.partial(
        jfb._warp5_tiled, bres=bres, th=th, tw=tw))(jnp.asarray(r1),
                                                    jnp.asarray(flow))
    want = np.asarray(want)
    got, inside = tfb._warp5_tiled(torch.from_numpy(r1),
                                   torch.from_numpy(flow), bres=bres, th=th,
                                   tw=tw)
    counts = wk.frame_counts(h, w, th, tw, "cpu")
    direct = wk.warp_tiles_plain(torch.from_numpy(r1), torch.from_numpy(flow),
                                 counts, th, tw, bres)
    assert torch.equal(direct, got)
    got = got.numpy()
    assert got.shape == want.shape == (h, w, 5)
    scale = np.abs(want).reshape(-1, 5).max(0)
    assert (np.abs(got - want) <= REL * scale).all(), \
        (np.abs(got - want) / scale).max()
    np.testing.assert_array_equal(inside.numpy(), np.asarray(win))
    assert 0.5 < inside.numpy().mean() < 1.0      # both sides of the mask


def test_warp_tiles_wrapper_checks_its_inputs():
    _, r1, flow = (torch.from_numpy(a) for a in _frame_inputs(16, 24, 2, 0))
    counts = wk.frame_counts(16, 24, 8, 128, "cpu")
    for bad in (r1.to(torch.float64), r1[:, :-1], r1.transpose(0, 1)):
        with pytest.raises(ValueError):
            wk.warp_tiles(bad, flow, counts, 8, 128, 2)
    with pytest.raises(ValueError):                  # counts of other tiles
        wk.warp_tiles(r1, flow, counts, 16, 128, 2)
    with pytest.raises(ValueError):
        wk.warp_tiles(r1, flow, counts, 8, 128, -1)
    with pytest.raises(ValueError):
        wk.warp_tiles(r1.to("meta"), flow.to("meta"), counts.to("meta"), 8,
                      128, 2)
    table = torch.zeros((5, 16 + 64, 128 + 256), dtype=torch.bfloat16)
    hflow = torch.zeros((2, 16, 128))
    with pytest.raises(ValueError):                  # bres past the halo
        wk.warp_tiles_nobase(table, hflow, 8, 128, 31)
    with pytest.raises(ValueError):                  # tiles must divide
        wk.warp_tiles(table, hflow, torch.ones((2, 1)), 8, 96, 2)
