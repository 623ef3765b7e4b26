"""K8 (warp_tiles)'s plain version in its halo layout against the
tool's TPU kernel, and the tiled update and tile choice against
JAX.

Inputs and tolerances: ``tests/_torch_tiled.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu.flow.fused_update import _block_base
from ripcurrents_tpu_torch.flow import farneback as tfb
from ripcurrents_tpu_torch.flow import warp_kernel as wk

from _torch_tiled import (REL, _frame_inputs, _halo_inputs, _run_tool, _tool,
                          jfb)


@pytest.mark.parametrize("bres", [1, 2])
def test_plain_k8_halo_layout_matches_the_tool_kernel(bres):
    hp, wp, th, sw = 192, 384, 96, 128
    tool = _tool()
    tbl, dx, dy, counts = _halo_inputs(hp, wp, th, sw, bres, seed=bres)
    want_a = _run_tool(tool, "A", tbl, dx, dy, counts, th, sw, bres)
    want_z = _run_tool(tool, "Z", tbl, dx, dy, counts, th, sw, bres)
    table = torch.from_numpy(tbl).to(torch.bfloat16)
    flow = torch.from_numpy(np.stack([dx, dy]))
    tcounts = torch.from_numpy(counts)
    got_a = wk.warp_tiles(table, flow, tcounts, th, sw, bres).numpy()
    got_z = wk.warp_tiles_nobase(table, flow, th, sw, bres).numpy()
    scale = np.abs(tbl).max()
    for got, want in ((got_a, want_a), (got_z, want_z)):
        assert got.shape == want.shape == (5, hp, wp)
        assert np.abs(got - want).max() <= REL * scale, \
            np.abs(got - want).max() / scale
    # every block's base as the TPU's _block_base computes it
    bases = wk.tile_bases_plain(flow, tcounts, th, sw, 128 - bres - 1,
                                32 - bres - 1).numpy()
    for i in range(hp // th):
        for s in range(wp // sw):
            blk = (slice(i * th, (i + 1) * th), slice(s * sw, (s + 1) * sw))
            bx, by = _block_base(jnp.asarray(dx[blk]), jnp.asarray(dy[blk]),
                                 counts[i, s], bres)
            assert (bases[0, i, s], bases[1, i, s]) == (int(bx), int(by))
    assert np.abs(bases).max() >= 2               # the bases are exercised
    assert wk.warp_tiles.launches == wk.warp_tiles_nobase.launches == 0


def test_update_matrices_tiled_matches_jax():
    r0, r1, flow = _frame_inputs(48, 80, 2, seed=7)
    want = jax.jit(lambda a, b, f: jfb.update_matrices(
        a, b, f, 16, "tiled", 2, (16, 128)))(
            jnp.asarray(r0), jnp.asarray(r1), jnp.asarray(flow))
    got = tfb.update_matrices(torch.from_numpy(r0), torch.from_numpy(r1),
                              torch.from_numpy(flow), 16, "tiled", 2,
                              (16, 128)).numpy()
    scale = np.abs(np.asarray(want)).reshape(-1, 5).max(0)
    assert (np.abs(got - np.asarray(want)) <= REL * scale).all()


def test_adaptive_tile_matches_jax():
    for lh, lw in ((24, 32), (120, 160), (240, 320), (480, 640), (75, 107),
                   (1080, 1920)):
        for tile in ((64, 256), (32, 128), (200, 512)):
            assert tfb._adaptive_tile(lh, lw, tile) == \
                jfb._adaptive_tile(lh, lw, tile)
