"""K8's plain version and the port's ``_warp5_tiled`` against JAX's for
1 and 3 channels, and the channel counts K8 refuses.

Inputs and what is held: ``tests/_torch_warp_tiles.py``.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu_torch.flow import farneback as tfb
from ripcurrents_tpu_torch.flow import warp_kernel as wk

from _torch_warp_tiles import REL

jfb = importlib.import_module("ripcurrents_tpu.flow.farneback")

torch.set_num_threads(1)


@pytest.mark.parametrize("channels,bres", [(1, 2), (3, 6)],
                         ids=["dense_lk_gray", "feature_stab_colour"])
def test_plain_and_warp5_tiled_match_jax_for_other_channel_counts(channels,
                                                                  bres):
    h, w, th, tw = 72, 136, 24, 128
    rng = np.random.default_rng(channels)
    r1 = rng.uniform(0, 255, (h, w, channels)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    flow = np.stack([7 * np.sin(yy / 13.0) + 3 * np.cos(xx / 30.0),
                     5 * np.cos(xx / 19.0) - 2], -1)
    flow = (flow + rng.normal(0, 0.5 * bres, (h, w, 2))).astype(np.float32)
    want, win = jax.jit(functools.partial(
        jfb._warp5_tiled, bres=bres, th=th, tw=tw))(jnp.asarray(r1),
                                                    jnp.asarray(flow))
    want = np.asarray(want)
    t1, tf = torch.from_numpy(r1), torch.from_numpy(flow)
    got, inside = tfb._warp5_tiled(t1, tf, bres=bres, th=th, tw=tw)
    direct = wk.warp_tiles_plain(t1, tf, None, th, tw, bres)
    assert torch.equal(direct, got)
    got = got.numpy()
    assert got.shape == want.shape == (h, w, channels)
    scale = np.abs(want).reshape(-1, channels).max(0)
    assert (np.abs(got - want) <= REL * scale).all(), \
        (np.abs(got - want) / scale).max()
    np.testing.assert_array_equal(inside.numpy(), np.asarray(win))
    assert 0.5 < inside.numpy().mean() < 1.0


def test_other_channel_counts_are_refused():
    flow = torch.zeros((8, 136, 2))
    for c in (2, 4):
        table = torch.zeros((8, 136, c))
        with pytest.raises(ValueError):
            wk.warp_tiles(table, flow, None, 8, 128, 2)
        with pytest.raises(ValueError):
            tfb._warp5_tiled(table, flow, bres=2, th=8, tw=128)
    # the halo layout keeps its 5 channels and needs its counts
    hflow = torch.zeros((2, 16, 128))
    with pytest.raises(ValueError):
        wk.warp_tiles(torch.zeros((3, 16 + 64, 128 + 256),
                                  dtype=torch.bfloat16), hflow,
                      torch.ones((2, 1)), 8, 128, 2)
    with pytest.raises(ValueError):
        wk.warp_tiles(torch.zeros((5, 16 + 64, 128 + 256),
                                  dtype=torch.bfloat16), hflow, None, 8, 128,
                      2)
