"""K5's and K6's windows rebuild the composed matrices, and their
wrappers check their inputs, on the CPU.

Inputs and tolerances: ``tests/_torch_prep.py``.
"""

import numpy as np
import pytest
import torch

from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb
from ripcurrents_tpu_torch.flow import prep_kernel

from _torch_prep import H, W, _frame, _legacy_args

torch.set_num_threads(1)


@pytest.mark.parametrize("level", [2, 0])
def test_windows_rebuild_the_composed_matrices(level):
    """Each output's window [lo, lo + len) and weights give back the
    bf16-rounded composed matrices exactly, pad rows and columns have
    len 0, and every nonzero lies inside its window."""
    args = tfb._prep_level_args(H, W, FarnebackParams.legacy(), level)
    assert args == _legacy_args(level)           # the TPU's level geometry
    by3, bx_g, bx_xg, bx_xxg = tfb._level_prep_matrices(*args)
    win = prep_kernel.band_windows(by3, bx_g, bx_xg, bx_xxg)

    def rebuild(lo, ln, wts, n_src):
        out = np.zeros((wts.shape[0], len(lo), n_src), np.float32)
        for o in range(len(lo)):
            assert (wts[:, ln[o]:, o] == 0).all()
            out[:, o, lo[o]:lo[o] + ln[o]] = wts[:, :ln[o], o]
        return out

    bf = prep_kernel._bf16_values
    y = rebuild(win["y_lo"], win["y_len"], win["wy"].T[None], H)
    np.testing.assert_array_equal(y[0], bf(by3).T)
    x = rebuild(win["x_lo"], win["x_len"], win["wx"], W)
    for i, m in enumerate((bx_g, bx_xg, bx_xxg)):
        np.testing.assert_array_equal(x[i], bf(m).T)
    lh, lw, ph, pw, (oy, ox) = args[2], args[3], args[8], args[9], args[10]
    assert (win["x_len"][:ox] == 0).all() and \
        (win["x_len"][ox + lw:] == 0).all()
    assert (win["y_len"][:oy] == 0).all() and \
        (win["y_len"][oy + lh:ph] == 0).all()
    assert len(win["y_len"]) == 3 * ph           # no rows past the canvas
    assert win["x_len"][ox:ox + lw].max() < 3 * 15 * 2 ** level


def test_wrappers_check_their_inputs():
    """The wrappers take float32 frames and bf16 y-pass results of the
    window's shape, run the plain versions on CPU tensors only, and raise
    for any other device."""
    args = (H, W) + _legacy_args(1)[2:]
    win = prep_kernel.windows_on(prep_kernel.band_windows(
        *tfb._level_prep_matrices(*args)), torch.device("cpu"))
    img = torch.from_numpy(_frame())
    with pytest.raises(ValueError):
        prep_kernel.prep_y(img.to(torch.float64), win)
    with pytest.raises(ValueError):
        prep_kernel.prep_y(img[:, :-1].contiguous(), win)
    t = prep_kernel.prep_y(img, win)
    assert t.dtype == torch.bfloat16 and prep_kernel.prep_y.launches == 0
    ph = args[8]
    ig = tfb._poly_exp_consts(15, 1.2)[3:]
    with pytest.raises(ValueError):
        prep_kernel.prep_x3(t.to(torch.float32), win, ph, ig,
                            torch.bfloat16, True)
    with pytest.raises(ValueError):
        prep_kernel.prep_x3(t, win, ph, ig, torch.float16, True)
    out = prep_kernel.prep_x3(t, win, ph, ig, torch.float32, False)
    assert out.shape == (ph, args[9], 5) and prep_kernel.prep_x3.launches == 0
    with pytest.raises(ValueError):
        prep_kernel.prep_y(img.to("meta"), win)
