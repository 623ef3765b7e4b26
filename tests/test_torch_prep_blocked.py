"""K5 and K6 against the blocked bf16 path the TPU kernels replace, with
zero pads, at every legacy level, on the CPU.

Inputs and tolerances: ``tests/_torch_prep.py``.
"""

import numpy as np
import pytest
import torch

from _torch_prep import _blocked, _check, _frame, _legacy_args, _port

torch.set_num_threads(1)


@pytest.mark.parametrize("level", [2, 1, 0])
def test_halo_bf16_matches_blocked_path_and_pads_are_zero(level):
    img, args = _frame(level), _legacy_args(level)
    got = _port(img, args)
    _check(got, _blocked(img, args), 0)
    _, _, lh, lw, *_ = args
    oy, ox = args[10]
    pad = np.ones(got.shape[1:], bool)
    pad[oy:oy + lh, ox:ox + lw] = False
    assert (got[:, pad] == 0.0).all()
