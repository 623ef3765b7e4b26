"""K8 (warp_tiles) and the portable engine's tiled warp against the JAX
package, on the CPU.

- K8's plain version in its halo layout against the TPU kernel of
  ``tools/bench_warp_variants.py`` (``make_kernel("A")``, the fused
  engine's ``_warp_subcols``, and ``"Z"``, the same taps with no base) run
  by ``pl.pallas_call(..., interpret=True)`` at 192x384: every block's
  base equal to ``_block_base``'s, values within 1e-5 of the table's
  scale (the TPU sums (2*bres+1)^2 taps, the port the two nonzero ones per
  axis: float32 sums in another order).
- K8's plain version in its frame layout, and ``_warp5_tiled``, against
  JAX ``_warp5_tiled``: values within 1e-5 of the channel's scale,
  ``inside`` identical.
- the portable engine with ``warp_impl="tiled"`` end to end at 96x128
  against the JAX tiled engine on the TPU's prep (``_pallas_ok`` True):
  median within 1e-3 px, 99% of pixels within 0.05 px (the portable
  engine's bounds in ``test_torch_warp.py``); and from the JAX CPU path's
  own tables, against what JAX runs for a ``"fused"`` preset off the TPU.
"""

import dataclasses
import functools
import importlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.config import FarnebackParams as JaxParams
from ripcurrents_tpu.flow.fused_update import _block_base
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb
from ripcurrents_tpu_torch.flow import warp_kernel as wk

jfb = importlib.import_module("ripcurrents_tpu.flow.farneback")

torch.set_num_threads(1)

REL = 1e-5


def _tool():
    path = (pathlib.Path(__file__).resolve().parents[1] / "tools" /
            "bench_warp_variants.py")
    spec = importlib.util.spec_from_file_location("bench_warp_variants",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _halo_inputs(hp, wp, th, sw, bres, seed):
    """A halo'd bf16 table (values ~N(0, 1)) and a flow whose block means
    move the bases off zero, as the tool's run() makes them."""
    rng = np.random.default_rng(seed)
    tbl = rng.normal(0, 1, (5, hp + 64, wp + 256)).astype(np.float32)
    tbl = np.array(jnp.asarray(tbl).astype(jnp.bfloat16)
                   .astype(jnp.float32))
    yy, xx = np.mgrid[0:hp, 0:wp].astype(np.float32)
    dx = (rng.normal(0, 3, (hp, wp)) + 9 * np.sin(xx / 70.0)
          ).astype(np.float32)
    dy = (rng.normal(0, 3, (hp, wp)) - 6 * np.cos(yy / 50.0)
          ).astype(np.float32)
    counts = np.full((hp // th, wp // sw), float(th * sw), np.float32)
    return tbl, dx, dy, counts


def _run_tool(tool, variant, tbl, dx, dy, counts, th, sw, bres):
    hp, wp = dx.shape
    tool.BRES = bres
    kern = tool.make_kernel(variant, th, sw, hp, wp)
    out = pl.pallas_call(
        kern, grid=(hp // th,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec((th, wp), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((th, wp), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((5, th, wp), lambda i: (0, i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((5, hp, wp), jnp.float32),
        interpret=True,
    )(jnp.asarray(counts), jnp.asarray(dx), jnp.asarray(dy),
      jnp.asarray(tbl).astype(jnp.bfloat16))
    return np.asarray(jax.block_until_ready(out))


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


def _frame_inputs(h, w, bres, seed):
    """A channels-last table and a smooth flow of up to ~+-14 px plus
    noise: tile bases of several px, and residuals past +-bres."""
    rng = np.random.default_rng(seed)
    r0 = rng.uniform(-1, 1, (h, w, 5)).astype(np.float32)
    r1 = rng.uniform(-1, 1, (h, w, 5)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    flow = np.stack([9 * np.sin(yy / 17.0) + 4 * np.cos(xx / 40.0),
                     7 * np.cos(xx / 23.0) - 3], -1)
    flow = (flow + rng.normal(0, 1.5, (h, w, 2))).astype(np.float32)
    return r0, r1, flow


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


H, W = 96, 128


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    yy = np.mgrid[0:H, 0:W][0].astype(np.float32)
    base = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    out = []
    for t in range(2):
        wave = 60 * np.sin(2 * np.pi * (yy / 24.0 - t * 0.11)) * (yy / H)
        out.append(np.clip(np.roll(base, t, axis=1) * 0.7 + wave + 60,
                           0, 255).astype(np.uint8))
    return out


def _flow_dev(got, want):
    d = np.sqrt(((got - want) ** 2).sum(-1))
    return np.median(d), (d <= 0.05).mean()


@pytest.mark.parametrize("preset", ["legacy", "windowed", "subtract_average"])
def test_portable_tiled_farneback_matches_jax(preset, monkeypatch):
    """The JAX tiled engine on the TPU's blocked bf16 prep (_pallas_ok
    True, warp_impl "tiled": the portable loop and _warp5_tiled, what JAX
    runs for a "fused" preset wherever its Pallas engine cannot run)."""
    f0, f1 = _frames()
    monkeypatch.setattr(jfb, "_pallas_ok",
                        functools.lru_cache(maxsize=1)(lambda: True))
    jp = dataclasses.replace(getattr(JaxParams, preset)(), warp_impl="tiled")
    # one jit: the eager tiled warp dispatches (2*bres+1)^2 taps per tile
    want = np.asarray(jax.jit(lambda a, b: jfb.farneback(a, b, jp))(
        jnp.asarray(f0), jnp.asarray(f1)))
    tp = dataclasses.replace(getattr(FarnebackParams, preset)(),
                             warp_impl="tiled")
    got = tfb.farneback(torch.from_numpy(f0), torch.from_numpy(f1),
                        tp).numpy()
    assert got.shape == want.shape == (H, W, 2) and np.isfinite(got).all()
    med, share = _flow_dev(got, want)
    assert med <= 1e-3 and share >= 0.99, (med, share)
    assert np.abs(want).mean() > 0.5                 # real motion


def test_tiled_engine_matches_jax_fused_preset_off_tpu():
    """The subtract_average preset as JAX runs it on the CPU (its "fused"
    preset falls back to the tiled XLA path, dense float32 prep); the
    port's tiled engine from the same expansion tables."""
    f0, f1 = _frames()
    jp = JaxParams.subtract_average()
    e0, e1, want = jax.jit(lambda a, b: (
        jfb.farneback_precompute(a, jp), jfb.farneback_precompute(b, jp),
        jfb.farneback(a, b, jp)))(jnp.asarray(f0), jnp.asarray(f1))
    want = np.asarray(want)
    tp = dataclasses.replace(FarnebackParams.subtract_average(),
                             warp_impl="tiled")
    got = tfb.farneback_from_expansions(
        [torch.from_numpy(np.array(e)) for e in e0],
        [torch.from_numpy(np.array(e)) for e in e1], (H, W), tp).numpy()
    med, share = _flow_dev(got, want)
    assert med <= 1e-3 and share >= 0.99, (med, share)


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


def test_tiled_mode_runs_through_fb_preset(monkeypatch):
    """ModeConfig(warp_impl="tiled") reaches the engine unchanged: a dense
    mode at 96x128 warps through K8's path 9 times a frame (3 levels x 3
    iterations of subtract_average) and equals the stream stepped by
    hand."""
    from ripcurrents_tpu_torch.pipelines import runner
    from ripcurrents_tpu_torch.pipelines.common import (ModeConfig,
                                                        fb_preset,
                                                        prep_frame)
    from ripcurrents_tpu_torch.synthetic import moving_frames
    cfg = ModeConfig(xdim=W, ydim=H, warp_impl="tiled")
    fb = fb_preset(FarnebackParams.subtract_average(), cfg)
    assert fb == dataclasses.replace(FarnebackParams.subtract_average(),
                                     warp_impl="tiled")
    calls = []
    real = tfb.warp_tiles
    monkeypatch.setattr(tfb, "warp_tiles",
                        lambda *a, **k: calls.append(a[3:5]) or real(*a, **k))
    raw = moving_frames(3, 144, 192, "cpu")
    stats = runner.RunStats()
    outs = list(runner.run_frames("subtructAverageVector", raw, cfg,
                                  device="cpu", stats=stats))
    assert len(outs) == 2 and outs[-1].shape == (H, W, 3)
    assert len(calls) == 18 and (24, 128) in calls and (8, 128) in calls
    grays = [prep_frame(raw[t], cfg, first=t == 0)[1] for t in range(3)]
    exp = tfb.farneback_precompute(grays[0], fb)
    for t in (1, 2):
        flow, exp = tfb.farneback_stream(exp, grays[t], fb)
    assert all(torch.equal(a, b)
               for a, b in zip(stats.state.fstream.exp, exp))
