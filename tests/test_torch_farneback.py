"""The port's expansion prep against JAX's dense path, and the
engine's refusal of the warps it does not port.

Inputs and tolerances: ``tests/_torch_farneback.py``.
"""

import functools

import numpy as np
import pytest
import torch

from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb

from _torch_farneback import (H, W, _frames, _jax_poly, _level_args,
                              _port_poly, jfb)


@pytest.mark.parametrize("level", [2, 1, 0])
def test_poly_exp_level_matches_jax_dense(level, monkeypatch):
    """With float32 operands, the dense f32 form (the JAX CPU path): within
    one bf16 ULP (measured identical)."""
    monkeypatch.setattr(jfb, "_pallas_ok",
                        functools.lru_cache(maxsize=1)(lambda: False))
    img = _frames(1)[0]
    args = _level_args(level)
    want = _jax_poly(img, args)
    got = _port_poly(img, args, operand_dtype=torch.float32)
    assert got.shape == want.shape == (5, args[8], args[9])
    assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7).all()


def test_engine_rejects_unported_warps():
    """Every warp and expansion of the JAX package is ported: "tiled" and
    "shifted" are accepted, a name the JAX package does not know raises."""
    import dataclasses
    for kw in ({"warp_impl": "tiled"}, {"poly_impl": "shifted"}):
        tfb._check_params(dataclasses.replace(FarnebackParams.legacy(), **kw))
    for kw in ({"warp_impl": "tile"}, {"poly_impl": "shift"}):
        p = dataclasses.replace(FarnebackParams.legacy(), **kw)
        with pytest.raises(ValueError, match="unknown"):
            tfb.farneback_precompute(torch.zeros((H, W)), p)
