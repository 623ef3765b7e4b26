"""The port's expansion prep against the TPU's blocked bf16 prep.

Inputs and tolerances: ``tests/_torch_farneback.py``.
"""

import functools

import numpy as np
import pytest

from _torch_farneback import _frames, _jax_poly, _level_args, _port_poly, jfb


@pytest.mark.parametrize("level", [2, 1, 0])
def test_poly_exp_level_vs_tpu_blocked_bf16(level, monkeypatch):
    """With its default bf16 operands, against the blocked path the TPU
    runs (bf16 matmul inputs, f32 accumulation): the bound of the TPU's
    own prep kernel against that path (tests/test_fused_update.py), mean
    |d| < 1e-4 and under 0.1% of entries off by more than 0.01. Measured
    at 192x256: mean 2e-7 to 3.4e-6, 5e-6 to 6e-5 above 0.01 (one-ULP bf16
    flips from the summation order). Pads exactly zero."""
    monkeypatch.setattr(jfb, "_pallas_ok",
                        functools.lru_cache(maxsize=1)(lambda: True))
    img = _frames(1)[0]
    args = _level_args(level)
    want, got = _jax_poly(img, args), _port_poly(img, args)
    d = np.abs(got - want)
    assert d.mean() < 1e-4, d.mean()
    assert (d > 0.01).mean() < 1e-3, (d > 0.01).mean()
    _, _, lh, lw, *_ = args
    pad = np.ones(got.shape[1:], bool)
    pad[32:32 + lh, 128:128 + lw] = False
    assert not got[:, pad].any()
