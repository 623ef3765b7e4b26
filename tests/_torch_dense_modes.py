"""Inputs, bounds and helpers shared by ``test_torch_dense_modes.py``,
``test_torch_dense_modes_jax.py``,
``test_torch_dense_modes_jax_rest.py``,
``test_torch_dense_modes_runner.py``. The tests are split into files of
at most 4 collected tests, so that xdist's ``--dist loadfile`` starts
each after ``tests/test_spatial.py``.

The port's dense Farneback modes against the JAX modes, on the CPU.

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

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.config import FarnebackParams as JaxParams
from ripcurrents_tpu.pipelines import legacy as jlegacy  # noqa: F401
from ripcurrents_tpu.pipelines import modes as jmodes
from ripcurrents_tpu.pipelines.common import MODES as JAX_MODES
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu.pipelines.common import prep_frame as jax_prep_frame
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb
from ripcurrents_tpu_torch.pipelines import modes as tmodes
from ripcurrents_tpu_torch.pipelines.common import MODES, ModeConfig

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


def mode_matches_jax_over_three_frames(mode, monkeypatch):
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
