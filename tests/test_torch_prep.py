"""K5 (prep_y) and K6 (prep_x3) against the TPU's expansion prep kernels
(``poly_exp_level_pallas`` in interpret mode) at every legacy level,
and the portable engine's channels-last layout, on the CPU.

Inputs and tolerances: ``tests/_torch_prep.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.config import FarnebackParams as JaxParams
from _torch_prep import (H, W, _blocked, _check, _frame, _legacy_args,
                         _pallas, _port, jfb)

torch.set_num_threads(1)


@pytest.mark.parametrize("level", [2, 1, 0])
def test_halo_bf16_matches_pallas_kernels(level):
    """The fused engine's layout: (5, Ph, Pw) bf16, level at the halo."""
    img, args = _frame(level), _legacy_args(level)
    _check(_port(img, args), _pallas(img, args), 0)


def test_channels_last_float32_matches_tpu():
    """The portable engine's layout: (lh, lw, 5) float32 with no padding,
    at level 1 of the subtract_average preset at 192x256, against the
    blocked path; and the unpadded level 0 against the kernels (which
    write channels first)."""
    img = _frame(5)
    for k in (1, 0):
        _, lh, lw, sig, ss = jfb._level_geometry(H, W,
                                                 JaxParams.subtract_average(),
                                                 k)
        args = (H, W, lh, lw, 15, 1.2, ss, sig, lh, lw, (0, 0))
        got = _port(img, args, channels_first=False, out_dtype=torch.float32)
        assert got.shape == (lh, lw, 5)
        _check(got, _blocked(img, args, channels_first=False,
                             out_dtype=None), -1)
        if k == 0:
            _check(np.moveaxis(got, -1, 0),
                   _pallas(img, args, jnp.float32), 0)
