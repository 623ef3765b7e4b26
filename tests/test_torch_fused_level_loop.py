"""The port's level loop (K1 and K2 on the host) against the JAX
whole-level kernel.

Inputs and tolerances: ``tests/_torch_fused_update.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.flow import fused_update as jfu
from ripcurrents_tpu_torch.flow import fused_update as tfu
from _torch_fused_update import H, W, _expansions, _padded, _preps

torch.set_num_threads(1)


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
