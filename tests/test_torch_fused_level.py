"""The port's window blur + solve (K2) and level loop against the JAX
fused kernels.

The plain PyTorch versions of K2 (farneback_blur_solve) and the level
loop run on the CPU; the JAX kernels run in Pallas interpret mode, on the
inputs of test_torch_fused_update.py.

Tolerance, on identical inputs: flow rtol = atol = 2e-3, the JAX
package's own bound between its whole-level kernel and its 3-kernel
chain (test_fused_update.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.flow import fused_update as jfu
from ripcurrents_tpu_torch.flow import fused_update as tfu
from test_torch_fused_update import H, W, _expansions, _padded, _preps

torch.set_num_threads(1)


@pytest.mark.parametrize("winsize,gaussian", [(3, False), (10, True)])
def test_blur_solve_plain_matches_jax_kernel(winsize, gaussian):
    e0, e1 = _expansions(2)
    jp, tp = _preps(e0, e1, 128)
    flow = np.random.default_rng(3).uniform(
        -2, 2, (2, H, W)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        m = jfu.fused_update_prepped(jp, jnp.asarray(flow), bres=2)
        want = np.asarray(jfu.fused_final_solve(jp, m, winsize, gaussian))
    m_t = torch.from_numpy(np.asarray(m).astype(np.float32)).to(
        torch.bfloat16)
    got = tfu.farneback_blur_solve(m_t, (H, W), winsize, gaussian,
                                   zero_pads=True)
    hp, wp = tp["hpwp"]
    assert got.shape == (2, hp, wp)
    assert not got[:, H:, :].any() and not got[:, :, W:].any()
    np.testing.assert_allclose(got[:, :H, :W].numpy(), want,
                               rtol=2e-3, atol=2e-3)
    # without zeroing, the pads hold the replicate-border solve and the
    # real region is unchanged
    kept = tfu.farneback_blur_solve(m_t, (H, W), winsize, gaussian,
                                    zero_pads=False)
    np.testing.assert_array_equal(kept[:, :H, :W].numpy(),
                                  got[:, :H, :W].numpy())
    assert kept[:, H:, :].abs().sum() > 0


def test_blur_weights_round_like_the_band_matrices():
    """Box 1/3 rounds to 0.333984375 in bf16; at the replicate border the
    two taps on row 0 merge before rounding (2/3 -> 0.66796875)."""
    wy, wx = tfu._blur_weights(8, 5, tfu._blur_taps(3, False))
    np.testing.assert_array_equal(wx, np.float32([0.333984375] * 3))
    np.testing.assert_array_equal(wy[0], np.float32([0.66796875, 0.0,
                                                     0.333984375]))
    # rows 5.. of the pad replicate row 4 only: one merged weight
    assert wy[6, 0] == np.float32(1.0) and not wy[6, 1:].any()


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_level_loop_matches_jax_level_kernel(iterations):
    """The level as a host loop of K1 and K2 == the TPU whole-level kernel
    (padded flow in and out, zero pads), at the legacy preset's box 3 /
    bres 4 / 128-wide subcolumns."""
    e0, e1 = _expansions(4)
    jp, tp = _preps(e0, e1, 128)
    flow = _padded(np.random.default_rng(5).uniform(
        -3, 3, (2, H, W)).astype(np.float32), tp["hpwp"])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfu.fused_level_prepped(
            jp, jnp.asarray(flow), winsize=3, gaussian=False, bres=4,
            iterations=iterations, padded_io=True))
    got = tfu.fused_level(tp, torch.from_numpy(flow), 3, False, 4,
                          iterations).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
