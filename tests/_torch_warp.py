"""Inputs, bounds and helpers shared by ``test_torch_warp.py``,
``test_torch_warp_update.py``, ``test_torch_warp_engine.py``. The tests
are split into files of at most 4 collected tests, so that xdist's
``--dist loadfile`` starts each after ``tests/test_spatial.py``.

K7 (warp5_shift) and the portable Farneback engine against the JAX
package, on the CPU.

- K7's plain version against ``warp5_shift_pallas`` in interpret mode (the
  TPU's (2b+2)^2-tap sum) at small budgets, everywhere, displacements
  beyond the budget included: the same function, whose extra terms are
  exact zeros, summed by XLA with its own roundings (|d| <= 1e-6,
  measured 1.2e-7); and against the exact bilinear
  gather on the pixels the mask keeps (<= 5e-5, the JAX package's bound).
- ``update_matrices`` ("gather", "shift", and "pallas" against the JAX
  "shift", the same function in XLA), ``_blur_m`` and ``_solve_flow``
  against JAX on the same float32 inputs: within 1e-5 relative to the
  channel's scale (float32 sums in another order).
- the portable ``farneback`` end to end at 96x128 against JAX on its
  TPU prep (``_pallas_ok`` True: the blocked bf16 prep): median within
  1e-3 px, 99% of pixels within 0.05 px. Measured: median <= 1.8e-6 px,
  worst pixel 2.6e-4 px.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.config import FarnebackParams as JaxParams
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb

jfb = importlib.import_module("ripcurrents_tpu.flow.farneback")

torch.set_num_threads(1)

REL = 1e-5


def _inputs(h, w, flow_px, seed=0):
    rng = np.random.default_rng(seed)
    r0 = rng.uniform(-1, 1, (h, w, 5)).astype(np.float32)
    r1 = rng.uniform(-1, 1, (h, w, 5)).astype(np.float32)
    flow = rng.uniform(-flow_px, flow_px, (h, w, 2)).astype(np.float32)
    flow[::7, ::5] = np.round(flow[::7, ::5])         # integer displacements
    return r0, r1, flow


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).reshape(-1, want.shape[-1]).max(0) + 1e-30
    assert (np.abs(got - want) <= rel * scale).all(), \
        (np.abs(got - want) / scale).max()


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


@functools.lru_cache(maxsize=None)
def _jax_flow(preset, impl):
    f0, f1 = _frames()
    jp = dataclasses.replace(getattr(JaxParams, preset)(), warp_impl=impl)
    mp = pytest.MonkeyPatch()
    mp.setattr(jfb, "_pallas_ok", functools.lru_cache(maxsize=1)(lambda: True))
    try:
        return np.asarray(jfb.farneback(jnp.asarray(f0), jnp.asarray(f1), jp))
    finally:
        mp.undo()


def _port_flow(preset, impl):
    f0, f1 = _frames()
    tp = dataclasses.replace(getattr(FarnebackParams, preset)(),
                             warp_impl=impl)
    return tfb.farneback(torch.from_numpy(f0), torch.from_numpy(f1),
                         tp).numpy()
