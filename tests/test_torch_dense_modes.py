"""The port's dense Farneback modes against the JAX modes, on the CPU.

Seven modes consume the Farneback flow stream: ``streamlines``,
``timelinesOnSubtractAverageVector``, ``timelinesFarne``,
``subtructAverageVector``, ``subtructAverageVectorWithWindow``,
``shearRate`` and ``averageVector``. They are checked in two parts:

- the flow stream of each of their three presets (streamlines,
  subtract_average, windowed), 3 frames from the JAX tables of frame 0,
  with the JAX engine run as the TPU runs it (fused Pallas kernels in
  interpret mode, blocked bf16 prep). The tables differ by one-ULP bf16
  flips and the level loop sums in another order, so the flows differ by
  ~1e-7 px at most pixels and by up to a few hundredths of a pixel at a
  few (bounds below);
- each mode over the same 3 frames from the carried JAX state, both sides
  fed the JAX flows: the mode's analysis, colouring and drawing. A uint8
  colour truncates the flow's angle and magnitude, so a flow difference of
  1e-4 px already moves ~10% of the pixels of a colour mode by one level;
  with the flow shared the outputs must agree on >= 99.9% of pixels.

Frames are 144x192 moving texture under wave bands, worked at 96x128, with
rings of 3-4 frames.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.analysis import meanflow as jmeanflow
from ripcurrents_tpu.analysis.shear import shear_to_color as j_shear_to_color
from ripcurrents_tpu.config import FarnebackParams as JaxParams
from ripcurrents_tpu.dynamics import advect as jadvect
from ripcurrents_tpu.pipelines import legacy as jlegacy  # noqa: F401
from ripcurrents_tpu.pipelines import modes as jmodes
from ripcurrents_tpu.pipelines.common import GRAY_INPUT as JAX_GRAY_INPUT
from ripcurrents_tpu.pipelines.common import MODES as JAX_MODES
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu.pipelines.common import prep_frame as jax_prep_frame
from ripcurrents_tpu.viz import color as jcolor
from ripcurrents_tpu.viz import draw as jdraw
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.analysis import meanflow
from ripcurrents_tpu_torch.analysis.shear import shear_to_color
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.dynamics import advect
from ripcurrents_tpu_torch.flow import farneback as tfb
from ripcurrents_tpu_torch.pipelines import modes as tmodes
from ripcurrents_tpu_torch.pipelines import runner
from ripcurrents_tpu_torch.pipelines.common import (GRAY_INPUT, MODES,
                                                    ModeConfig)
from ripcurrents_tpu_torch.viz import color as tcolor
from ripcurrents_tpu_torch.viz import draw as tdraw

jfb = importlib.import_module("ripcurrents_tpu.flow.farneback")

torch.set_num_threads(1)

RH, RW = 144, 192          # raw frames; the modes work at 96x128
KW = dict(xdim=128, ydim=96, seed=3, total_frames=10, window_size=3,
          shear_window=3, average_buffer=4, n_streamline_seeds=6)
PRESET = {"streamlines": "streamlines",
          "timelinesOnSubtractAverageVector": "streamlines",
          "timelinesFarne": "subtract_average",
          "subtructAverageVector": "subtract_average",
          "subtructAverageVectorWithWindow": "windowed",
          "shearRate": "windowed",
          "averageVector": "subtract_average"}
CARRY = {"streamlines": convert.trails_state_from_numpy,
         "timelinesOnSubtractAverageVector": convert.trails_state_from_numpy,
         "timelinesFarne": convert.trails_state_from_numpy,
         "subtructAverageVector": convert.subtract_average_state_from_numpy,
         "subtructAverageVectorWithWindow": convert.windowed_state_from_numpy,
         "shearRate": convert.shear_state_from_numpy,
         "averageVector": convert.average_vector_state_from_numpy}
# (median px, mean px, share above 0.05 px) of the port's stream flow
# against the JAX stream, on each of 3 frames, ~3x the worst measured (see
# test_flow_stream_matches_jax). The port carries its own tables after
# frame 0, so their one-ULP flips add up over the frames.
STREAM_BOUNDS = {"streamlines": (1e-5, 0.25, 0.18),
                 "subtract_average": (1.5e-3, 2.5e-3, 1e-3),
                 "windowed": (1.2e-3, 5e-3, 1.5e-3)}
# carried floats of a mode, with the flow shared: the state's float
# leaves (seeds, ring entries and mean, running maxima) within FLOAT_TOL
# absolute (float32 rounding of the same operations in another order)
FLOAT_TOL = 1e-4
PIXEL_SHARE = 0.999


def _frames(n):
    rng = np.random.default_rng(0)
    yy = np.mgrid[0:RH, 0:RW][0].astype(np.float32)
    base = rng.uniform(0, 255, (RH, RW)).astype(np.float32)
    k = np.ones(7) / 7
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    out = []
    for t in range(n):
        wave = 50 * np.sin(2 * np.pi * (yy / 30.0 - t * 0.11)) * (yy / RH)
        g = np.clip(np.roll(base, 2 * t, axis=1) * 0.7 + wave + 50, 0, 255)
        out.append(np.stack([g * 0.9, g, np.clip(g * 1.1, 0, 255)],
                            -1).astype(np.uint8))
    return out


FRAMES = _frames(4)


@functools.lru_cache(maxsize=None)
def _streams(preset):
    """The JAX flow stream of a preset over FRAMES, as the TPU runs it,
    beside the port's stream from the JAX tables of frame 0: (JAX flows,
    port flows), 3 each, as numpy."""
    jcfg = JaxModeConfig(**KW)
    grays = [np.asarray(jax_prep_frame(jnp.asarray(f), jcfg, first=i == 0)[1])
             for i, f in enumerate(FRAMES)]
    jp = getattr(JaxParams, preset)()
    tp = getattr(FarnebackParams, preset)()
    mp = pytest.MonkeyPatch()
    mp.setattr(jfb, "_pallas_ok",
               functools.lru_cache(maxsize=1)(lambda: True))
    try:
        with pltpu.force_tpu_interpret_mode():
            e = jfb.farneback_precompute(jnp.asarray(grays[0]), jp)
            te = convert.expansions_from_numpy([np.asarray(t) for t in e])
            step = jax.jit(functools.partial(jfb.farneback_stream, p=jp))
            want, got = [], []
            for g in grays[1:]:
                fl, e = step(e, jnp.asarray(g))
                want.append(np.asarray(fl))
                tfl, te = tfb.farneback_stream(te, torch.from_numpy(g), tp)
                got.append(tfl.numpy())
    finally:
        mp.undo()
    return want, got


@pytest.mark.parametrize("preset", sorted(STREAM_BOUNDS))
def test_flow_stream_matches_jax(preset):
    """Measured at 96x128, worst of the 3 frames (median, mean, share
    above 0.05 px): streamlines (2.4e-7, 0.078, 0.059), subtract_average
    (4.7e-4, 8.0e-4, 0), windowed (3.7e-4, 1.6e-3, 4.9e-4). The winsize-3
    streamlines preset is chaotic where the texture is weak: a few pixels
    jump by tens of px there, as the legacy preset does."""
    want, got = _streams(preset)
    for w, g in zip(want, got):
        assert g.shape == w.shape == (96, 128, 2) and np.isfinite(g).all()
        d = np.sqrt(((g - w) ** 2).sum(-1))
        med, mean, share = np.median(d), d.mean(), (d > 0.05).mean()
        bounds = STREAM_BOUNDS[preset]
        assert med < bounds[0] and mean < bounds[1] and share < bounds[2], \
            (med, mean, share)


def _float_leaves(state) -> dict:
    """A JAX mode state -> {field: float numpy array} of its float leaves
    (the expansion tables left out)."""
    out = {}
    for name, v in zip(state._fields, state):
        if name == "fstream":
            continue
        if hasattr(v, "_fields"):
            out.update(_float_leaves(v))
        else:
            out[name] = np.asarray(v)
    return out


@pytest.mark.parametrize("mode", sorted(CARRY))
def test_mode_matches_jax_over_three_frames(mode, monkeypatch):
    want_flows = _streams(PRESET[mode])[0]
    feeds = {"jax": iter(want_flows), "port": iter(want_flows)}
    monkeypatch.setattr(
        jmodes, "flow_stream_step",
        lambda fs, gray, fb: (jnp.asarray(next(feeds["jax"])), fs))
    monkeypatch.setattr(
        tmodes, "flow_stream_step",
        lambda fs, gray, fb: (torch.from_numpy(next(feeds["port"])), fs))
    jinit, jstep = JAX_MODES[mode](JaxModeConfig(**KW))
    jstate = jinit(jnp.asarray(FRAMES[0]))
    _, tstep = MODES[mode](ModeConfig(**KW), device="cpu")
    tstate = CARRY[mode](jax.tree.map(np.asarray, jstate))
    start = _float_leaves(jax.tree.map(np.asarray, jstate))
    for raw in FRAMES[1:]:
        jstate, jout = jstep(jstate, jnp.asarray(raw))
        tstate, tout = tstep(tstate, raw)
    want = _float_leaves(jax.tree.map(np.asarray, jstate))
    got = convert.state_to_numpy(tstate)
    assert int(got["framecount"]) == int(want["framecount"]) == 3
    moved = 0.0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert np.abs(g.astype(np.float64) - w).max(initial=0) <= FLOAT_TOL, \
            (name, np.abs(g.astype(np.float64) - w).max())
        moved = max(moved, np.abs(w.astype(np.float64) - start[name]).max(
            initial=0))
    assert moved > 0.01                       # the carried state changed
    tout, jout = tout.numpy(), np.asarray(jout)
    assert tout.dtype == np.uint8 and tout.shape == jout.shape == (96, 128, 3)
    assert (tout == jout).all(-1).mean() >= PIXEL_SHARE, \
        (tout == jout).all(-1).mean()


def _flow(h=96, w=128, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((h, w, 2)) *
            scale).astype(np.float32)


def test_colourings_exact():
    """vector_to_color, shear_to_color, average_vector and get_delta on
    the same inputs: the same uint8 images, the same carried floats and
    the same advected points."""
    flow = _flow()
    rng = np.random.default_rng(5)
    pts = rng.uniform(-5, 135, (64, 2)).astype(np.float32)
    for upper in (0.5, 45.0):
        np.testing.assert_array_equal(
            advect.get_delta(torch.from_numpy(pts), torch.from_numpy(flow),
                             2.0, upper).numpy(),
            np.asarray(jadvect.get_delta(jnp.asarray(pts), jnp.asarray(flow),
                                         2.0, upper)))
    for prev in (1e-6, 4.0):
        j = jcolor.vector_to_color(jnp.asarray(flow), jnp.float32(prev))
        t = tcolor.vector_to_color(torch.from_numpy(flow),
                                   torch.tensor(prev))
        np.testing.assert_array_equal(t.bgr_u8.numpy(), np.asarray(j.bgr_u8))
        assert float(t.max_displacement) == float(j.max_displacement)
        j = j_shear_to_color(jnp.asarray(flow), jnp.float32(prev))
        t = shear_to_color(torch.from_numpy(flow), torch.tensor(prev))
        np.testing.assert_array_equal(t.hsv_u8.numpy(), np.asarray(j.hsv_u8))
        assert float(t.max_frobenius) == float(j.max_frobenius)
    js = jmeanflow.average_vector_init(96, 128, capacity=3)
    ts = meanflow.average_vector_init(96, 128, capacity=3)
    for i in range(4):
        f = _flow(seed=i + 1, scale=1.5)
        jo = jmeanflow.average_vector(js, jnp.asarray(f), 45.0)
        to = meanflow.average_vector(ts, torch.from_numpy(f), 45.0)
        js, ts = jo.state, to.state
        np.testing.assert_array_equal(to.hsv_u8.numpy(),
                                      np.asarray(jo.hsv_u8))
        np.testing.assert_array_equal(to.counter_mask.numpy(),
                                      np.asarray(jo.counter_mask))
        np.testing.assert_allclose(to.grid_angle_deg.numpy(),
                                   np.asarray(jo.grid_angle_deg), atol=1e-3)
        assert abs(float(to.global_angle_rad) -
                   float(jo.global_angle_rad)) <= 1e-5
    np.testing.assert_allclose(ts.ring.mean.numpy(),
                               np.asarray(js.ring.mean), atol=1e-6)


def test_legends_and_drawing_exact():
    """color_wheel, shear_color_chart, polar_to_hsv_bgr, draw_frame_count,
    draw_arrows and paste on the same inputs: the same uint8 images."""
    rng = np.random.default_rng(4)
    ang = rng.uniform(0, 360, (16, 24)).astype(np.float32)
    val = rng.uniform(-0.2, 1.2, (16, 24)).astype(np.float32)
    sat = rng.uniform(0, 1, (16, 24)).astype(np.float32)
    for s in (None, sat):
        np.testing.assert_array_equal(
            tcolor.polar_to_hsv_bgr(
                torch.from_numpy(ang), torch.from_numpy(val),
                None if s is None else torch.from_numpy(s)).numpy(),
            np.asarray(jcolor.polar_to_hsv_bgr(
                jnp.asarray(ang), jnp.asarray(val),
                None if s is None else jnp.asarray(s))))
    np.testing.assert_array_equal(tcolor.color_wheel(60).numpy(),
                                  np.asarray(jcolor.color_wheel(60)))
    np.testing.assert_array_equal(tcolor.shear_color_chart(8, 32).numpy(),
                                  np.asarray(jcolor.shear_color_chart(8, 32)))
    img = rng.integers(0, 255, (96, 128, 3)).astype(np.uint8)
    for fc in (7, 38, 12345):
        np.testing.assert_array_equal(
            tdraw.draw_frame_count(torch.from_numpy(img),
                                   torch.tensor(fc, dtype=torch.int32)).numpy(),
            np.asarray(jdraw.draw_frame_count(jnp.asarray(img), fc)))
    starts = rng.uniform(-10, 140, (12, 2)).astype(np.float32)
    ends = starts + rng.uniform(-20, 20, (12, 2)).astype(np.float32)
    valid = rng.uniform(size=12) < 0.7
    for thickness, frac in ((1, 0.4), (2, 0.2)):
        np.testing.assert_array_equal(
            tdraw.draw_arrows(torch.from_numpy(img), torch.from_numpy(starts),
                              torch.from_numpy(ends), torch.from_numpy(valid),
                              (0, 255, 0), thickness, frac).numpy(),
            np.asarray(jdraw.draw_arrows(
                jnp.asarray(img), jnp.asarray(starts), jnp.asarray(ends),
                jnp.asarray(valid), (0, 255, 0), thickness, frac)))
    patch = rng.integers(0, 255, (12, 20, 3)).astype(np.uint8)
    for y, x in ((0, 108), (5, 7), (90, 120)):     # the last one is clamped
        np.testing.assert_array_equal(
            tdraw.paste(torch.from_numpy(img), torch.from_numpy(patch), y,
                        x).numpy(),
            np.asarray(jdraw.paste(jnp.asarray(img), jnp.asarray(patch), y,
                                   x)))


def test_run_frames_equals_stepping_by_hand_and_registry():
    """run_frames over a dense mode (its own init: the port's tables, the
    port's engine) yields what stepping by hand yields; the registry holds
    the eighteen ported modes with the JAX package's gray-input flags."""
    cfg = dataclasses.replace(ModeConfig(**KW), total_frames=len(FRAMES))
    for mode in ("subtructAverageVectorWithWindow", "timelinesFarne"):
        init, step = MODES[mode](cfg, device="cpu")
        state = init(FRAMES[0])
        want = []
        for raw in FRAMES[1:]:
            state, out = step(state, raw)
            want.append(out)
        stats = runner.RunStats()
        got = list(runner.run_frames(mode, FRAMES, ModeConfig(**KW),
                                     device="cpu", stats=stats))
        assert len(got) == 3 and stats.frames == 3
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    dense = set(PRESET)
    assert set(MODES) == dense | {"legacy", "timelines", "streaklines",
                                  "populationMap", "flowRedPoints",
                                  "android", "averageHSV", "timex",
                                  "brightColor", "phaseCorrelate",
                                  "stabilizeTPU", "globalOrientation"}
    assert GRAY_INPUT == JAX_GRAY_INPUT & set(MODES) == \
        {"subtructAverageVector", "averageVector", "globalOrientation"}
    gray = [np.asarray(f)[..., 1] for f in FRAMES]    # 2-D gray frames
    out = list(runner.run_frames("averageVector", gray, ModeConfig(**KW),
                                 device="cpu"))
    assert len(out) == 3 and out[-1].shape == (96, 128, 3)
