"""The portable engine with ``warp_impl="tiled"`` end to end against
the JAX tiled engine, and against JAX's fused preset off the TPU.

Inputs and tolerances: ``tests/_torch_tiled.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu.config import FarnebackParams as JaxParams
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb

from _torch_tiled import H, W, _flow_dev, _frames, jfb


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
