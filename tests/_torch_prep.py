"""Inputs, helpers and bounds shared by the ``test_torch_prep*.py``
files (not the geometry ones): K5 (prep_y) and K6 (prep_x3), the
per-level Farneback expansion prep, against the TPU's expansion prep, on
the CPU.

On CPU tensors the wrappers run their plain versions, which sum each
output over its source window in the order the kernels do. The JAX side
is what the TPU runs: ``poly_exp_level_pallas`` (its y and x3 kernels) in
interpret mode, and the blocked bf16 path it replaces. All apply the same
composed matrices, rounded to bf16, to the bf16-rounded frame with float32
accumulation, and store the y-pass result as bf16; the summation order is
the only difference, and it can flip a stored bf16 value by one ULP.

Bound, for every comparison: within one bf16 ULP (2^-7 of the reference
value, or 2^-7 of the channel's scale below it) on >= 99.9% of entries,
and mean |d| <= 1e-4 of the channel's scale. Measured on the legacy levels
at 192x256: against the kernels at most 0.003% of entries beyond one ULP
and mean |d| <= 5.3e-8 of the scale; against the blocked path 0.009% and
3.3e-7.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.config import FarnebackParams as JaxParams
from ripcurrents_tpu.flow.prep_pallas import poly_exp_level_pallas
from ripcurrents_tpu_torch.flow import farneback as tfb

jfb = importlib.import_module("ripcurrents_tpu.flow.farneback")

H, W = 192, 256
ULP = 2.0 ** -7
SHARE = 0.999
MEAN = 1e-4


def _frame(seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    k = np.ones(3) / 3
    for ax in (0, 1):
        img = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, img)
    return np.round(img).astype(np.float32)


def _port(img, args, channels_first=True, out_dtype=torch.bfloat16):
    _, _, lh, lw, n, sig, ss, bs, ph, pw, off = args
    out = tfb.poly_exp_level(torch.from_numpy(img), lh, lw, n, sig, ss, bs,
                             channels_first=channels_first, pad_hw=(ph, pw),
                             pad_off=off, out_dtype=out_dtype)
    return out.to(torch.float32).numpy()


def _pallas(img, args, out_dtype=jnp.bfloat16):
    n, sig, ph = args[4], args[5], args[8]
    _, _, _, i11, i03, i33, i55 = jfb._poly_exp_consts(n, sig)
    return np.asarray(poly_exp_level_pallas(
        jnp.asarray(img), args, i11, i03, i33, i55, jfb._y_section_stride(ph),
        out_dtype, interpret=True)).astype(np.float32)


def _blocked(img, args, channels_first=True, out_dtype=jnp.bfloat16):
    _, _, lh, lw, n, sig, ss, bs, ph, pw, off = args
    mp = pytest.MonkeyPatch()
    mp.setattr(jfb, "_pallas_ok", functools.lru_cache(maxsize=1)(lambda: True))
    try:
        out = jfb.poly_exp_level(jnp.asarray(img), lh, lw, n, sig, ss, bs,
                                 channels_first=channels_first,
                                 pad_hw=(ph, pw), pad_off=off,
                                 out_dtype=out_dtype)
    finally:
        mp.undo()
    return np.asarray(out).astype(np.float32)


def _check(got, want, chan_axis):
    assert got.shape == want.shape
    axes = tuple(a for a in range(3) if a != chan_axis % 3)
    scale = np.abs(want).max(axis=axes, keepdims=True)
    d = np.abs(got - want)
    within = d <= ULP * np.maximum(np.abs(want), ULP * scale)
    assert within.mean() >= SHARE, within.mean()
    assert (d / scale).mean() <= MEAN, (d / scale).mean()


def _legacy_args(k):
    return jfb._prep_level_args(H, W, JaxParams.legacy(), k)
