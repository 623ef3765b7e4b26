"""Inputs, bounds and helpers shared by ``test_torch_tiled.py``,
``test_torch_tiled_frame.py``, ``test_torch_tiled_engine.py``,
``test_torch_tiled_mode.py``. The tests are split into files of at most
4 collected tests, so that xdist's ``--dist loadfile`` starts each after
``tests/test_spatial.py``.

K8 (warp_tiles) and the portable engine's tiled warp against the JAX
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

import importlib
import importlib.util
import pathlib

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu


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
