"""``subtract_mean_magnitude``, ``stabilize_flow``, ``translate``,
``bilinear_sample``, ``phase_correlate`` and the global orientation
step against the JAX package.

Inputs and tolerances: ``tests/_torch_simple_modes.py``.
"""

import numpy as np
import torch

from ripcurrents_tpu.analysis import meanflow as jmeanflow
from ripcurrents_tpu.analysis import motion as jmotion
from ripcurrents_tpu.flow import phasecorr as jphasecorr
from ripcurrents_tpu.ops import warp as jwarp
from ripcurrents_tpu_torch.analysis import meanflow, motion
from ripcurrents_tpu_torch.flow import phasecorr
from ripcurrents_tpu_torch.ops import warp

from _torch_simple_modes import J, PC_PX, T, _image


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
