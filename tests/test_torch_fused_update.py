"""The port's Farneback matrix update (K1) against the JAX fused kernels.

The plain PyTorch version of K1 (farneback_update) runs on the CPU; the
JAX kernels run in Pallas interpret mode (K2 and the level loop:
test_torch_fused_level.py). Both sides get the same bf16 expansion tables
(prepare_expansions on numpy inputs) and the same flows.

Tolerance, on identical inputs: M (bf16) at most one bf16 ULP per element
(2^-7 relative), on under 0.1% of elements. The TPU kernel and the port
round the same f32 value to bf16; the f32 value can differ in its last
bit where the two sum in another order, and a bf16 rounding tie then
flips.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.flow import fused_update as jfu
from ripcurrents_tpu_torch.flow import fused_update as tfu

torch.set_num_threads(1)

H, W = 40, 300          # not a multiple of 128; TH=24 gives ragged tiles
TH = 24


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


@pytest.mark.parametrize("subcol", [128, 384])
def test_prepare_expansions_matches_jax(subcol):
    e0, e1 = _expansions(0)
    jp, tp = _preps(e0, e1, subcol)
    for k in ("p0", "p1"):
        np.testing.assert_array_equal(
            tp[k].to(torch.float32).numpy(),
            np.asarray(jp[k]).astype(np.float32))
    np.testing.assert_array_equal(tp["counts"].numpy(),
                                  np.asarray(jp["counts"]))
    assert (tp["hw"], tp["hpwp"], tp["th"], tp["sw"]) == \
        (tuple(jp["hw"]), tuple(jp["hpwp"]), jp["th"], jp["sw"])


@pytest.mark.parametrize("offset", [(0.0, 0.0), (150.0, -40.0)],
                         ids=["residual-clamp", "base-clamp"])
@pytest.mark.parametrize("bres", [1, 4])
@pytest.mark.parametrize("subcol", [128, 384])
def test_update_plain_matches_jax_kernel(subcol, bres, offset):
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


def test_wrappers_reject_bad_inputs():
    e0, e1 = _expansions(6)
    _, tp = _preps(e0, e1, 128)
    hp, wp = tp["hpwp"]
    good = torch.zeros((2, hp, wp))
    with pytest.raises(ValueError):
        tfu.farneback_update(tp, good.double(), 2)             # dtype
    with pytest.raises(ValueError):
        tfu.farneback_update(tp, good[:, :, :-1], 2)           # shape
    with pytest.raises(ValueError):
        tfu.farneback_update(tp, torch.zeros((2, wp, hp)).transpose(1, 2),
                             2)                                # layout
    with pytest.raises(ValueError):
        tfu.farneback_update(tp, good, tfu.HALO_Y)             # bres
    m = torch.zeros((5, hp, wp), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfu.farneback_blur_solve(m.float(), (H, W), 3, False, True)
    with pytest.raises(ValueError):
        tfu.farneback_blur_solve(m, (H, W), 2 * tfu.MHALO_Y + 3, False,
                                 True)
    with pytest.raises(ValueError):                            # no kernel
        tfu.farneback_blur_solve(m.to("meta"), (H, W), 3, False, True)
    launches = (tfu.farneback_update.launches,
                tfu.farneback_blur_solve.launches)
    tfu.fused_level(tp, good, 3, False, 2, 2)
    # the plain versions on CPU tensors are not kernel launches
    assert (tfu.farneback_update.launches,
            tfu.farneback_blur_solve.launches) == launches
