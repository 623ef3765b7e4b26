"""Inputs, bounds and helpers shared by ``test_torch_simple_modes.py``,
``test_torch_simple_modes_flow.py``, ``test_torch_simple_modes_jax.py``,
``test_torch_simple_modes_jax_rest.py``. The tests are split into files
of at most 4 collected tests, so that xdist's ``--dist loadfile`` starts
each after ``tests/test_spatial.py``.

The port's five simple modes and the functions under them against the
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
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu.pipelines import modes as jmodes  # noqa: F401
from ripcurrents_tpu.pipelines.common import MODES as JAX_MODES
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch import convert
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


def _leaves(state) -> dict:
    return {k: np.asarray(v) for k, v in
            convert.state_to_numpy(state).items()}


def _jax_leaves(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in state._fields}


def mode_matches_jax_over_three_steps(mode):
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
