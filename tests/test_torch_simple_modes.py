"""The port's five simple modes and the functions under them against the
JAX package, on the CPU, on the same numpy inputs made from a seed.

The modes are ``averageHSV``, ``timex``, ``brightColor``,
``phaseCorrelate`` and ``globalOrientation``. Tolerances, as measured:

- HSV conversions (uint8 and float, BGR and RGB), ``bright_color_reduce``
  (options 0, 1, 2, with V ties), ``timex_update``,
  ``average_hsv_update``, ``bilinear_sample``, ``translate`` and the
  motion-history step: equal (the same operations in the same order);
- ``subtract_mean_magnitude`` and ``stabilize_flow``: within 1e-5 px (a
  mean over the frame sums in another order);
- ``hanning_window`` within 1e-6 (float32 sin); ``phase_correlate``'s
  shift within PC_PX px and its response within 1e-5 (another FFT);
- the global orientation angle within 1e-3 degrees (a weighted mean);
- each mode over 3 steps at 96x128 from the converted JAX state: its
  output frames and carried state equal, except ``phaseCorrelate``,
  whose corrected frame (its carried state) may differ by one uint8
  level on at most MODE_PIXEL_SHARE of pixels, through its shift.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu.analysis import meanflow as jmeanflow
from ripcurrents_tpu.analysis import motion as jmotion
from ripcurrents_tpu.flow import phasecorr as jphasecorr
from ripcurrents_tpu.ops import color as jcolor
from ripcurrents_tpu.ops import warp as jwarp
from ripcurrents_tpu.pipelines import modes as jmodes  # noqa: F401
from ripcurrents_tpu.pipelines.common import MODES as JAX_MODES
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.analysis import meanflow, motion
from ripcurrents_tpu_torch.flow import phasecorr
from ripcurrents_tpu_torch.ops import color, warp
from ripcurrents_tpu_torch.pipelines import runner  # noqa: F401
from ripcurrents_tpu_torch.pipelines.common import MODES, ModeConfig

torch.set_num_threads(1)

T = torch.from_numpy
J = jnp.asarray
RH, RW = 144, 192          # raw frames; the modes work at 96x128
# the ROI of phaseCorrelate inside the 96x128 frame, on moving texture
KW = dict(xdim=128, ydim=96, average_buffer=3, bright_window=3,
          phase_roi=(60, 30, 48, 40))
PC_PX = 1e-4
MODE_PIXEL_SHARE = 1e-3
CARRY = {"averageHSV": convert.average_hsv_state_from_numpy,
         "timex": convert.timex_state_from_numpy,
         "brightColor": convert.bright_color_state_from_numpy,
         "phaseCorrelate": convert.phase_correlate_state_from_numpy,
         "globalOrientation": convert.global_orientation_state_from_numpy}


def _frames(n):
    """Moving texture under wave bands, with a camera shake of a few px
    (what phaseCorrelate undoes)."""
    rng = np.random.default_rng(0)
    yy = np.mgrid[0:RH, 0:RW][0].astype(np.float32)
    base = rng.uniform(0, 255, (RH + 16, RW + 16)).astype(np.float32)
    k = np.ones(7) / 7
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    out = []
    for t in range(n):
        dy, dx = rng.integers(0, 6, 2)
        g = base[dy:dy + RH, dx:dx + RW] * 0.7 + 50 + \
            50 * np.sin(2 * np.pi * (yy / 30.0 - t * 0.11)) * (yy / RH)
        g = np.clip(g, 0, 255)
        out.append(np.stack([g * 0.9, g, np.clip(g * 1.1, 0, 255)],
                            -1).astype(np.uint8))
    return out


FRAMES = _frames(4)


def _image(seed=0, h=96, w=128):
    """Random uint8 BGR with gray pixels (C == 0) and channel ties."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    img[:8] = img[:8, :, :1]
    img[8:16, :, 1] = img[8:16, :, 0]
    img[16:24, :, 2] = img[16:24, :, 1]
    return img


def test_hsv_conversions_exact():
    """bgr_to_hsv / rgb_to_hsv (uint8 and float) and hsv_to_bgr /
    hsv_to_rgb equal the JAX functions, at the sector edges included."""
    img = _image()
    for name in ("bgr_to_hsv", "rgb_to_hsv"):
        for x in (img, img.astype(np.float32) / 255.0):
            want = np.asarray(getattr(jcolor, name)(J(x)))
            got = getattr(color, name)(T(x)).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(1)
    hsv_f = np.stack([rng.uniform(0, 360, (96, 128)),
                      rng.uniform(0, 1, (96, 128)),
                      rng.uniform(0, 1, (96, 128))], -1).astype(np.float32)
    hsv_f[:4, :, 0] = np.arange(4)[:, None] * 60.0      # sector edges
    hsv_u8 = np.asarray(jcolor.bgr_to_hsv(J(img)))
    for name in ("hsv_to_bgr", "hsv_to_rgb"):
        for x in (hsv_u8, hsv_f):
            np.testing.assert_array_equal(
                getattr(color, name)(T(x)).numpy(),
                np.asarray(getattr(jcolor, name)(J(x))))


def test_bright_color_reduce_with_ties():
    """Options 0 (mean), 1 (pixel of max V), 2 (pixel of min V) equal JAX
    on a buffer whose V takes 4 values, so most pixels tie; on a tie both
    take the first frame."""
    rng = np.random.default_rng(2)
    buf = rng.integers(0, 256, (5, 96, 128, 3)).astype(np.uint8)
    buf[..., 2] = buf[..., 2] // 64 * 64
    for option in (0, 1, 2):
        got = meanflow.bright_color_reduce(T(buf), option).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jmeanflow.bright_color_reduce(J(buf), option)))
    v = buf[..., 2].astype(np.int32)
    first = np.argmax(v == v.max(0), axis=0)
    np.testing.assert_array_equal(
        meanflow.bright_color_reduce(T(buf), 1).numpy(),
        np.take_along_axis(buf, first[None, ..., None], 0)[0])
    assert (v == v.max(0)).sum(0).max() > 1             # ties present


def test_timex_and_average_hsv_updates():
    """timex_update and average_hsv_update over 4 frames into a 3-slot
    ring (it wraps) equal JAX."""
    jsum = jnp.zeros((96, 128, 3), jnp.float32)
    tsum = torch.zeros((96, 128, 3))
    jring = jmeanflow.ring_init(3, (96, 128, 3))
    tring = meanflow.ring_init(3, (96, 128, 3))
    for seed in range(4):
        img = _image(seed)
        jsum = jmeanflow.timex_update(jsum, J(img))
        tsum = meanflow.timex_update(tsum, T(img))
        jring = jmeanflow.average_hsv_update(jring, J(img))
        tring = meanflow.average_hsv_update(tring, T(img))
    np.testing.assert_array_equal(tsum.numpy(), np.asarray(jsum))
    for got, want in zip(tring, jring):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_subtract_mean_magnitude_and_stabilize_flow():
    rng = np.random.default_rng(3)
    flow = rng.normal(0, 2, (96, 128, 2)).astype(np.float32)
    flow[:4, :4] = 0.0                                 # zero vectors
    flow[-5:, -8:, 0] = 0.0                            # zero components
    for jf, tf in ((jmeanflow.subtract_mean_magnitude,
                    meanflow.subtract_mean_magnitude),
                   (jmeanflow.stabilize_flow, meanflow.stabilize_flow)):
        np.testing.assert_allclose(tf(T(flow)).numpy(),
                                   np.asarray(jf(J(flow))), rtol=0,
                                   atol=1e-5)
    out = meanflow.stabilize_flow(T(flow)).numpy()
    assert (out[-5:, -8:, 0] == 0).all() and (out[:4, :4] == 0).all()


def test_translate_and_bilinear_sample_exact():
    img = _image(4)
    for dx, dy in ((1.3, -2.7), (0.0, 0.0), (-5.5, 3.25), (140.0, 0.0)):
        np.testing.assert_array_equal(
            warp.translate(T(img), torch.tensor(dx), torch.tensor(dy)).numpy(),
            np.asarray(jwarp.translate(J(img), dx, dy)))
    rng = np.random.default_rng(5)
    gray = img[..., 1].astype(np.float32)
    xs = rng.uniform(-3, 131, (7, 9)).astype(np.float32)
    ys = rng.uniform(-3, 99, (7, 9)).astype(np.float32)
    for border in ("clamp", "zero"):
        for im in (gray, img.astype(np.float32)):
            np.testing.assert_array_equal(
                warp.bilinear_sample(T(im), T(xs), T(ys), border).numpy(),
                np.asarray(jwarp.bilinear_sample(J(im), J(xs), J(ys),
                                                 border)))


def test_phase_correlate_shift():
    """A (3, -2) px translation of random texture: the port's shift within
    PC_PX of JAX's and within 0.1 px of the truth."""
    base = np.random.default_rng(6).uniform(0, 255, (120, 120)).astype(
        np.float32)
    moved = np.roll(np.roll(base, 3, axis=1), -2, axis=0)
    a, b = base[30:80, 30:80], moved[30:80, 30:80]
    win = phasecorr.hanning_window(50, 50)
    np.testing.assert_allclose(win.numpy(),
                               np.asarray(jphasecorr.hanning_window(50, 50)),
                               rtol=0, atol=1e-6)
    for w in (None, win.numpy()):
        want = jphasecorr.phase_correlate(J(a), J(b),
                                          None if w is None else J(w))
        got = phasecorr.phase_correlate(T(a), T(b),
                                        None if w is None else T(w))
        np.testing.assert_allclose(got.shift.numpy(), np.asarray(want.shift),
                                   rtol=0, atol=PC_PX)
        assert abs(float(got.response) - float(want.response)) < 1e-5
        assert np.abs(got.shift.numpy() - [3.0, -2.0]).max() < 0.1


def test_global_orientation_step():
    """A block of texture moved 5 px right: the motion-history image,
    gradient orientation and validity mask equal JAX; the global angle
    within 1e-3 degrees."""
    g0 = _image(7)[..., 1]
    g1 = g0.copy()
    g1[20:60, 30:90] = np.roll(g0, 5, axis=1)[20:60, 30:90]
    want = jmotion.global_orientation_step(J(g0), J(g1))
    got = motion.global_orientation_step(T(g0), T(g1))
    np.testing.assert_array_equal(got.mhi_norm.numpy(),
                                  np.asarray(want.mhi_norm))
    np.testing.assert_array_equal(got.orientation.mask.numpy(),
                                  np.asarray(want.orientation.mask))
    np.testing.assert_array_equal(
        got.orientation.orientation_deg.numpy(),
        np.asarray(want.orientation.orientation_deg))
    assert abs(float(got.angle_deg) - float(want.angle_deg)) < 1e-3
    assert got.orientation.mask.numpy().sum() > 100


def _leaves(state) -> dict:
    return {k: np.asarray(v) for k, v in
            convert.state_to_numpy(state).items()}


def _jax_leaves(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in state._fields}


@pytest.mark.parametrize("mode", sorted(CARRY))
def test_mode_matches_jax_over_three_steps(mode):
    jinit, jstep = JAX_MODES[mode](JaxModeConfig(**KW))
    if mode == "globalOrientation":
        # its many small draw ops are slow eagerly; jit leaves its numbers
        # as they are (XLA rewrites the divisions of the others)
        jstep = jax.jit(jstep)
    jstate = jinit(J(FRAMES[0]))
    _, tstep = MODES[mode](ModeConfig(**KW), device="cpu")
    tstate = CARRY[mode](jax.tree.map(np.asarray, jstate))
    outs = []
    for raw in FRAMES[1:]:
        jstate, jout = jstep(jstate, J(raw))
        tstate, tout = tstep(tstate, raw)
        jout, tout = np.asarray(jout), tout.numpy()
        outs.append(tout)
        assert tout.dtype == np.uint8 and tout.shape == jout.shape == \
            (96, 128, 3)
        if mode == "phaseCorrelate":
            levels = np.abs(tout.astype(int) - jout).max(-1)
            assert levels.max() <= 1 and (levels > 0).mean() <= \
                MODE_PIXEL_SHARE, ((levels > 0).mean(), levels.max())
        else:
            np.testing.assert_array_equal(tout, jout)
    want, got = _jax_leaves(jstate), _leaves(tstate)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        if mode == "phaseCorrelate" and k == "prev_resized":
            assert (got[k] != w).mean() <= MODE_PIXEL_SHARE
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    if "framecount" in want:
        assert int(want["framecount"]) == 3
    assert (outs[0] != outs[-1]).any()       # the output moves


def test_bright_color_replays_from_a_held_state():
    """brightColor stepped twice from the same held state gives the same
    frame and state both times, as JAX does; the held buffer is not
    written."""
    cfg = dict(KW, bright_option=1)
    jinit, jstep = JAX_MODES["brightColor"](JaxModeConfig(**cfg))
    jheld = jinit(J(FRAMES[0]))
    jheld, _ = jstep(jheld, J(FRAMES[1]))
    _, tstep = MODES["brightColor"](ModeConfig(**cfg), device="cpu")
    held = convert.bright_color_state_from_numpy(
        jax.tree.map(np.asarray, jheld))
    before = held.buffer.clone()
    first = tstep(held, FRAMES[2])
    again = tstep(held, FRAMES[2])
    assert torch.equal(held.buffer, before)
    jfirst = jstep(jheld, J(FRAMES[2]))
    for (s, out) in (first, again):
        np.testing.assert_array_equal(out.numpy(), np.asarray(jfirst[1]))
        np.testing.assert_array_equal(s.buffer.numpy(),
                                      np.asarray(jfirst[0].buffer))
        assert int(s.idx) == int(jfirst[0].idx) == 2
