"""The portable Farneback engine end to end against JAX, and its
"pallas" warp against "shift" in the port.

Inputs and tolerances: ``tests/_torch_warp.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb
from ripcurrents_tpu_torch.flow import warp_kernel

from _torch_warp import H, W, _frames, _inputs, _jax_flow, _port_flow


@pytest.mark.parametrize("preset,impl", [("subtract_average", "shift"),
                                         ("windowed", "gather"),
                                         ("subtract_average", "pallas")])
def test_portable_farneback_matches_jax(preset, impl):
    got = _port_flow(preset, impl)
    want = _jax_flow(preset, "shift" if impl == "pallas" else impl)
    assert got.shape == want.shape == (H, W, 2) and np.isfinite(got).all()
    d = np.sqrt(((got - want) ** 2).sum(-1))
    assert np.median(d) <= 1e-3 and (d <= 0.05).mean() >= 0.99, \
        (np.median(d), (d <= 0.05).mean())
    assert np.abs(want).mean() > 0.5                 # real motion


def test_pallas_equals_shift_in_the_port_on_the_cpu():
    """On CPU tensors the "pallas" warp is K7's plain version, the same
    function as "shift": equal update matrices and equal flow. The
    portable precompute gives (lh, lw, 5) float32 tables."""
    r0, r1, flow = (torch.from_numpy(a) for a in _inputs(40, 64, 20.0))
    assert torch.equal(tfb.update_matrices(r0, r1, flow, 16, "pallas"),
                       tfb.update_matrices(r0, r1, flow, 16, "shift"))
    assert warp_kernel.warp5_shift.launches == 0
    np.testing.assert_array_equal(_port_flow("windowed", "pallas"),
                                  _port_flow("windowed", "shift"))
    p = dataclasses.replace(FarnebackParams.subtract_average(),
                            warp_impl="pallas")
    tables = tfb.farneback_precompute(torch.from_numpy(_frames()[0]), p)
    assert [tuple(t.shape) for t in tables] == [(24, 32, 5), (48, 64, 5),
                                               (96, 128, 5)]
    assert all(t.dtype == torch.float32 for t in tables)
