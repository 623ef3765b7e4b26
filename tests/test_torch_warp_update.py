"""The portable engine's ``update_matrices``, ``_blur_m`` and
``_solve_flow`` against JAX.

Inputs and tolerances: ``tests/_torch_warp.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu_torch.flow import farneback as tfb

from _torch_warp import _close, _inputs, jfb


@pytest.mark.parametrize("impl", ["gather", "shift", "pallas"])
def test_update_matrices_matches_jax(impl):
    r0, r1, flow = _inputs(48, 80, 9.0, seed=7)
    want = jfb.update_matrices(jnp.asarray(r0), jnp.asarray(r1),
                               jnp.asarray(flow), 8,
                               "shift" if impl == "pallas" else impl)
    got = tfb.update_matrices(torch.from_numpy(r0), torch.from_numpy(r1),
                              torch.from_numpy(flow), 8, impl)
    _close(got.numpy(), want)
    if impl == "gather":            # warp_budget None is the gather too
        same = tfb.update_matrices(torch.from_numpy(r0),
                                   torch.from_numpy(r1),
                                   torch.from_numpy(flow), None, "shift")
        assert torch.equal(same, got)


def test_blur_and_solve_match_jax():
    rng = np.random.default_rng(11)
    m = rng.uniform(-2, 2, (37, 53, 5)).astype(np.float32)
    m[..., 0] += 4.0
    m[..., 2] += 4.0
    for winsize, gaussian in ((20, True), (10, True), (3, False)):
        _close(tfb._blur_m(torch.from_numpy(m), winsize, gaussian).numpy(),
               jfb._blur_m(jnp.asarray(m), winsize, gaussian))
    _close(tfb._solve_flow(torch.from_numpy(m)).numpy(),
           jfb._solve_flow(jnp.asarray(m)))
