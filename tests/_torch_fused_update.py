"""Inputs, bounds and the update test's body shared by
``test_torch_fused_update.py``, ``test_torch_fused_update_plain.py``,
``test_torch_fused_update_clamp.py``, ``test_torch_fused_level.py`` and
``test_torch_fused_level_loop.py``: the port's Farneback matrix update
(K1), window blur + solve (K2) and level loop against the JAX fused
kernels.

The plain PyTorch versions of K1 (farneback_update), K2
(farneback_blur_solve) and the level loop run on the CPU; the JAX
kernels run in Pallas interpret mode. Both sides get the same bf16
expansion tables (prepare_expansions on numpy inputs) and the same
flows.

Tolerances, on identical inputs: M (bf16) at most one bf16 ULP per
element (2^-7 relative), on under 0.1% of elements. The TPU kernel and
the port round the same f32 value to bf16; the f32 value can differ in
its last bit where the two sum in another order, and a bf16 rounding
tie then flips. The flow of K2 and of the level loop: rtol = atol =
2e-3, the JAX package's own bound between its whole-level kernel and its
3-kernel chain (test_fused_update.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.flow import fused_update as jfu
from ripcurrents_tpu_torch.flow import fused_update as tfu

H, W = 40, 300          # not a multiple of 128; TH=24 gives ragged tiles
TH = 24
# (subcol, bres, offset) of test_update_plain_matches_jax_kernel: the
# residual-clamp cases, then the base-clamp ones
UPDATE_CASES = [pytest.param(subcol, bres, offset,
                             id=f"{name}-{bres}-{subcol}")
                for offset, name in (((0.0, 0.0), "residual-clamp"),
                                     ((150.0, -40.0), "base-clamp"))
                for bres in (1, 4) for subcol in (128, 384)]


def _expansions(seed):
    rng = np.random.default_rng(seed)
    e0 = rng.normal(0.0, 1.0, (5, H, W)).astype(np.float32)
    e1 = (np.roll(e0, 2, axis=2) * 0.9 +
          rng.normal(0.0, 0.05, (5, H, W))).astype(np.float32)
    return e0, e1


def _preps(e0, e1, subcol):
    jp = jfu.prepare_expansions(jnp.asarray(e0), jnp.asarray(e1), TH,
                                subcol=subcol)
    tp = tfu.prepare_expansions(torch.from_numpy(e0), torch.from_numpy(e1),
                                TH, subcol=subcol)
    return jp, tp


def _padded(flow, hpwp):
    out = np.zeros((2,) + tuple(hpwp), np.float32)
    out[:, :flow.shape[1], :flow.shape[2]] = flow
    return out


def _assert_m_close(got, want):
    d = np.abs(got - want)
    assert (d <= np.abs(want) * 2.0 ** -7 + 1e-6).all(), d.max()
    assert (d > 0).mean() < 1e-3, (d > 0).mean()


def update_plain_matches_jax_kernel(subcol, bres, offset):
    """Flows up to +-(bres + 3) px around the block base pass the residual
    clamp; the offset run also pushes the base past its halo clamp
    (+-(HALO - bres - 1)) in both axes, so the (2b+1)^2 tap sum of the TPU
    and the clamped bilinear sample of the port must agree there too."""
    e0, e1 = _expansions(1)
    jp, tp = _preps(e0, e1, subcol)
    rng = np.random.default_rng(100 * bres + subcol)
    flow = rng.uniform(-(bres + 3), bres + 3, (2, H, W)).astype(np.float32)
    flow[0] += offset[0]
    flow[1] += offset[1]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfu.fused_update_prepped(jp, jnp.asarray(flow),
                                                   bres=bres))
    got = tfu.farneback_update(tp, torch.from_numpy(_padded(flow,
                                                            tp["hpwp"])),
                               bres)
    assert got.dtype == torch.bfloat16
    _assert_m_close(got.to(torch.float32).numpy(), want.astype(np.float32))
