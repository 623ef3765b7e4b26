"""K5 (prep_y) and K6 (prep_x3), the per-level Farneback expansion prep,
against the TPU's expansion prep, on the CPU.

On CPU tensors the wrappers run their plain versions, which sum each
output over its source window in the order the kernels do. The JAX side
is what the TPU runs: ``poly_exp_level_pallas`` (its y and x3 kernels) in
interpret mode, and the blocked bf16 path it replaces. All apply the same
composed matrices, rounded to bf16, to the bf16-rounded frame with float32
accumulation, and store the y-pass result as bf16; the summation order is
the only difference, and it can flip a stored bf16 value by one ULP.

Bound, for every comparison: within one bf16 ULP (2^-7 of the reference
value, or 2^-7 of the channel's scale below it) on >= 99.9% of entries,
and mean |d| <= 1e-4 of the channel's scale. Measured on the legacy levels
at 192x256: against the kernels at most 0.003% of entries beyond one ULP
and mean |d| <= 5.3e-8 of the scale; against the blocked path 0.009% and
3.3e-7.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.config import FarnebackParams as JaxParams
from ripcurrents_tpu.flow.prep_pallas import poly_exp_level_pallas
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb
from ripcurrents_tpu_torch.flow import prep_kernel

jfb = importlib.import_module("ripcurrents_tpu.flow.farneback")

torch.set_num_threads(1)

H, W = 192, 256
ULP = 2.0 ** -7
SHARE = 0.999
MEAN = 1e-4


def _frame(seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    k = np.ones(3) / 3
    for ax in (0, 1):
        img = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, img)
    return np.round(img).astype(np.float32)


def _port(img, args, channels_first=True, out_dtype=torch.bfloat16):
    _, _, lh, lw, n, sig, ss, bs, ph, pw, off = args
    out = tfb.poly_exp_level(torch.from_numpy(img), lh, lw, n, sig, ss, bs,
                             channels_first=channels_first, pad_hw=(ph, pw),
                             pad_off=off, out_dtype=out_dtype)
    return out.to(torch.float32).numpy()


def _pallas(img, args, out_dtype=jnp.bfloat16):
    n, sig, ph = args[4], args[5], args[8]
    _, _, _, i11, i03, i33, i55 = jfb._poly_exp_consts(n, sig)
    return np.asarray(poly_exp_level_pallas(
        jnp.asarray(img), args, i11, i03, i33, i55, jfb._y_section_stride(ph),
        out_dtype, interpret=True)).astype(np.float32)


def _blocked(img, args, channels_first=True, out_dtype=jnp.bfloat16):
    _, _, lh, lw, n, sig, ss, bs, ph, pw, off = args
    mp = pytest.MonkeyPatch()
    mp.setattr(jfb, "_pallas_ok", functools.lru_cache(maxsize=1)(lambda: True))
    try:
        out = jfb.poly_exp_level(jnp.asarray(img), lh, lw, n, sig, ss, bs,
                                 channels_first=channels_first,
                                 pad_hw=(ph, pw), pad_off=off,
                                 out_dtype=out_dtype)
    finally:
        mp.undo()
    return np.asarray(out).astype(np.float32)


def _check(got, want, chan_axis):
    assert got.shape == want.shape
    axes = tuple(a for a in range(3) if a != chan_axis % 3)
    scale = np.abs(want).max(axis=axes, keepdims=True)
    d = np.abs(got - want)
    within = d <= ULP * np.maximum(np.abs(want), ULP * scale)
    assert within.mean() >= SHARE, within.mean()
    assert (d / scale).mean() <= MEAN, (d / scale).mean()


def _legacy_args(k):
    return jfb._prep_level_args(H, W, JaxParams.legacy(), k)


@pytest.mark.parametrize("level", [2, 1, 0])
def test_halo_bf16_matches_pallas_kernels(level):
    """The fused engine's layout: (5, Ph, Pw) bf16, level at the halo."""
    img, args = _frame(level), _legacy_args(level)
    _check(_port(img, args), _pallas(img, args), 0)


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
