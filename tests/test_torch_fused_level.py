"""The port's window blur + solve (K2) and its weights against the JAX
fused kernel.

Inputs and tolerances: ``tests/_torch_fused_update.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.flow import fused_update as jfu
from ripcurrents_tpu_torch.flow import fused_update as tfu
from _torch_fused_update import H, W, _expansions, _preps

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
