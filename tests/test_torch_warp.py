"""K7 (warp5_shift)'s plain version against the Pallas kernel and the
bilinear gather, and the wrapper's checks.

Inputs and tolerances: ``tests/_torch_warp.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.flow.warp_pallas import warp5_shift_pallas
from ripcurrents_tpu_torch.flow import farneback as tfb
from ripcurrents_tpu_torch.flow import warp_kernel

from _torch_warp import _close, _inputs, jfb


@pytest.mark.parametrize("budget,flow_px", [(4, 7.0), (8, 11.0)])
def test_plain_k7_matches_pallas_kernel(budget, flow_px):
    _, r1, flow = _inputs(40, 200, flow_px, seed=budget)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(warp5_shift_pallas(
            jnp.asarray(r1), jnp.asarray(flow), budget, th=32, tw=128))
    got = warp_kernel.warp5_shift(torch.from_numpy(r1),
                                  torch.from_numpy(flow), budget).numpy()
    assert got.shape == want.shape == (40, 200, 5)
    assert np.abs(got - want).max() <= 1e-6, np.abs(got - want).max()
    beyond = (np.abs(flow) > budget).any(-1)
    assert beyond.mean() > 0.1                 # the mask's other side is hit


def test_plain_k7_matches_gather_where_the_mask_keeps():
    _, r1, flow = _inputs(64, 256, 20.0, seed=3)
    r1t, ft = torch.from_numpy(r1), torch.from_numpy(flow)
    got = warp_kernel.warp5_shift(r1t, ft, 16)
    _, inside = tfb._warp5_shift_mask(64, 256, ft, 16)
    want, inside_g = tfb._warp5_gather(r1t, ft)
    m = inside.numpy()
    assert 0.3 < m.mean() < 0.9
    assert not (m & ~inside_g.numpy()).any()
    np.testing.assert_allclose(got.numpy()[m], want.numpy()[m], atol=5e-5)
    jwant, jinside = jfb._warp5_gather(jnp.asarray(r1), jnp.asarray(flow))
    np.testing.assert_array_equal(inside_g.numpy(), np.asarray(jinside))
    _close(want.numpy(), jwant)


def test_warp_wrapper_checks_its_inputs():
    _, r1, flow = (torch.from_numpy(a) for a in _inputs(16, 24, 3.0))
    for bad in (r1.to(torch.float64), r1[:, :-1], r1.transpose(0, 1)):
        with pytest.raises(ValueError):
            warp_kernel.warp5_shift(bad, flow, 4)
    with pytest.raises(ValueError):
        warp_kernel.warp5_shift(r1, flow, -1)
    with pytest.raises(ValueError):
        warp_kernel.warp5_shift(r1.to("meta"), flow.to("meta"), 4)
