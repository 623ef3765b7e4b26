"""The port's Farneback matrix update (K1) against the JAX fused kernel:
the residual-clamp cases.

Inputs and tolerances: ``tests/_torch_fused_update.py``.
"""

import pytest
import torch

from _torch_fused_update import UPDATE_CASES, update_plain_matches_jax_kernel

torch.set_num_threads(1)


@pytest.mark.parametrize("subcol,bres,offset", UPDATE_CASES[:4])
def test_update_plain_matches_jax_kernel(subcol, bres, offset):
    update_plain_matches_jax_kernel(subcol, bres, offset)
