"""The port's particle modes (timelines, streaklines, populationMap,
flowRedPoints) against the JAX modes, and the frame runner.

Both sides start from the JAX ``init`` state (its random points come from
``jax.random``, which torch cannot reproduce), carried across with
``convert``, and step over the same 3 frames at 96x128 with a small
tracker (window 15, 2 levels). Bounds: tracked vertices within 0.01 px
(the trackers follow the same arithmetic and differ by float32 summation
order, and by the frame resize's matmul rounding, which can move a uint8
pixel by one level); the output frame equal on >= 99.9% of pixels.
Measured here: vertices at most 3.3e-4 px apart, every output pixel equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from ripcurrents_tpu.config import LKParams as JaxLKParams
from ripcurrents_tpu.pipelines import android as jandroid  # noqa: F401
from ripcurrents_tpu.pipelines import legacy as jlegacy  # noqa: F401
from ripcurrents_tpu.pipelines import modes as jmodes  # noqa: F401
from ripcurrents_tpu.pipelines.common import MODES as JAX_MODES
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.pipelines import runner
from ripcurrents_tpu_torch.pipelines.common import MODES, ModeConfig

torch.set_num_threads(1)

RH, RW = 144, 192          # raw frames; the modes work at 96x128
SMALL = JaxLKParams((15, 15), 2, 10, 0.03, 1e-4)
KW = dict(xdim=128, ydim=96, seed=3, timeline_start=(6.0, 30.0),
          timeline_end=(120.0, 80.0), timeline_vertices=24,
          max_streaklines=3, streakline_capacity=8,
          population_rect=(30, 20, 60, 45), population_vertices=12)
CARRY = {"timelines": convert.timelines_state_from_numpy,
         "streaklines": convert.streaklines_state_from_numpy,
         "populationMap": convert.population_state_from_numpy,
         "flowRedPoints": convert.red_points_state_from_numpy}
VERTS = {"timelines": "vertices", "streaklines": "verts",
         "populationMap": "vertices", "flowRedPoints": "pts"}


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


def _cfg():
    return ModeConfig(lk=convert.lk_params(SMALL), **KW)


@pytest.mark.parametrize("mode", sorted(CARRY))
def test_mode_matches_jax_over_three_frames(mode):
    jinit, jstep = JAX_MODES[mode](JaxModeConfig(lk=SMALL, **KW))
    jstep = jax.jit(jstep)
    jstate = jinit(FRAMES[0])
    _, tstep = MODES[mode](_cfg(), device="cpu")
    tstate = CARRY[mode](jax.tree.map(np.asarray, jstate))
    start = convert.state_to_numpy(tstate)[VERTS[mode]]
    for raw in FRAMES[1:]:
        jstate, jout = jstep(jstate, raw)
        tstate, tout = tstep(tstate, raw)
    want = jax.tree.map(np.asarray, jstate)
    got = convert.state_to_numpy(tstate)
    wv = want
    for name in (("timeline",) if mode == "timelines" else
                 ("pop",) if mode == "populationMap" else ()):
        wv = getattr(wv, name)
    wv = getattr(wv, VERTS[mode])
    gv = got[VERTS[mode]]
    assert gv.shape == wv.shape and np.isfinite(gv).all()
    assert np.abs(gv - wv).max() < 0.01, np.abs(gv - wv).max()
    assert np.abs(gv - start).max() > 0.5            # the points moved
    assert got["framecount"] == want.framecount == 3
    if mode == "streaklines":
        np.testing.assert_array_equal(got["count"], want.count)
    tout, jout = tout.numpy(), np.asarray(jout)
    assert tout.dtype == np.uint8 and tout.shape == jout.shape == (96, 128, 3)
    assert (tout != jout).any(-1).mean() <= 0.001


@pytest.mark.parametrize("mode", ["timelines", "streaklines",
                                  "populationMap", "flowRedPoints"])
def test_run_frames_equals_stepping_by_hand(mode):
    cfg = dataclasses.replace(_cfg(), total_frames=len(FRAMES))
    init, step = MODES[mode](cfg, device="cpu")
    state = init(FRAMES[0])
    want = []
    for raw in FRAMES[1:]:
        state, out = step(state, raw)
        want.append(out)
    stats = runner.RunStats()
    got = list(runner.run_frames(mode, FRAMES, _cfg(), device="cpu",
                                 stats=stats))
    assert len(got) == 3 and stats.frames == 3 and stats.seconds > 0
    assert stats.fps == pytest.approx(3 / stats.seconds)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_run_frames_init_draws_its_own_points():
    """The port's own init (torch generators) gives states of the shapes
    the reference prescribes, inside the frame."""
    cfg = ModeConfig()
    raw = np.zeros((48, 64, 3), np.uint8)
    tl = MODES["timelines"](cfg, device="cpu")[0](raw)
    assert tl.timeline.vertices.shape == (201, 2)
    sk = MODES["streaklines"](cfg, device="cpu")[0](raw)
    assert sk.verts.shape == (5, 256, 2) and sk.count.tolist() == [1] * 5
    assert (sk.gens >= 0).all() and (sk.gens[:, 0] < 640).all() and \
        (sk.gens[:, 1] < 480).all()
    pm = MODES["populationMap"](cfg, device="cpu")[0](raw)
    v = pm.pop.vertices
    assert v.shape == (50, 2) and (v[:, 0] >= 300).all() and \
        (v[:, 0] <= 350).all() and (v[:, 1] >= 200).all()   # rand()+1 bias
    rp = MODES["flowRedPoints"](cfg, device="cpu")[0](raw)
    assert rp.pts.shape == (192, 2) and rp.prev_gray.shape == (480, 640)


def test_run_frames_takes_generators_and_fills_stats_when_closed():
    stats = runner.RunStats()
    it = runner.run_frames("flowRedPoints", iter(FRAMES), _cfg(),
                           device="cpu", stats=stats)
    first, second = next(it), next(it)
    it.close()                                  # the consumer stops early
    assert stats.frames == 2 and stats.seconds > 0
    assert int(stats.state.framecount) == 2
    assert first.shape == second.shape == (96, 128, 3)
    assert list(runner.run_frames("timelines", [], _cfg(),
                                  device="cpu")) == []


def test_run_frames_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError):
        next(runner.run_frames("timelines", FRAMES, _cfg()))
    with pytest.raises(RuntimeError):
        MODES["streaklines"](_cfg())


def test_registry_holds_the_ported_modes():
    assert set(MODES) == {"legacy", "timelines", "streaklines",
                          "populationMap", "flowRedPoints", "streamlines",
                          "timelinesOnSubtractAverageVector",
                          "timelinesFarne", "subtructAverageVector",
                          "subtructAverageVectorWithWindow", "shearRate",
                          "averageVector", "android", "averageHSV", "timex",
                          "brightColor", "phaseCorrelate", "stabilizeTPU",
                          "globalOrientation"}
    assert set(MODES) == set(JAX_MODES)
    with pytest.raises(KeyError):
        next(runner.run_frames("stabilize", FRAMES, _cfg(),
                               device="cpu"))
