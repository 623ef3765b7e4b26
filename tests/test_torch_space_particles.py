"""The space forms of streaklines, populationMap and flowRedPoints
(``--mesh-space 2``: each frame's rows split over 2 gloo ranks,
``pipelines/multirunner.py``) on the CPU, against the port's one-process
run and the JAX package's runner, and the rule that gives each tracked
point to one rank (``modes.owned_points`` / ``modes.track_points``).

The ranks are spawned from ``tests/_torch_space_ranks.py`` (all three
modes in one spawn) and meet through a file:// store under tmp_path.
Written frames are taken before encoding. The clips are those of JAX's
``test_streams_with_space_sharding`` (160x120, 5 frames, chunk 4); the
tracker is small (window 15, 2 levels; flowRedPoints keeps its own
preset), the streaklines hold 16 vertices, and the population's
rectangle puts its points on both sides of the bands' boundary (row
60). Both sides start from the JAX init's random points (``seeded``),
which torch cannot draw.

Tolerances:
- against the one-process run: every written frame and every stream's
  last state (points, counts, the gathered gray) bit for bit;
- against JAX's ``run_videos(..., space=2)`` on the 8 virtual CPU devices
  of ``tests/conftest.py``: fewer than 1% of values differ (JAX's own
  bound for a sharded step);
- the owner rule: each point, at any row (above and below the frame, on
  a band's boundary, NaN), on exactly one of 2 or 3 bands; the summed
  bands' tracks equal one K3 plain call bit for bit, NaN where it gives
  NaN.
"""

import types

import numpy as np
import pytest
import torch

import _torch_space_ranks as ranks
from ripcurrents_tpu.config import LKParams as JaxLKParams
from ripcurrents_tpu.pipelines import multirunner as jmulti
from ripcurrents_tpu.pipelines.common import MODES as JAX_MODES
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.config import LKParams
from ripcurrents_tpu_torch.flow.lucas_kanade import pyr_lk
from ripcurrents_tpu_torch.io import video as io_video
from ripcurrents_tpu_torch.pipelines import modes, multirunner
from ripcurrents_tpu_torch.pipelines.common import ModeConfig

from test_torch_space import _join, _write_clip

torch.set_num_threads(1)

SMALL = JaxLKParams((15, 15), 2, 10, 0.03, 1e-4)
SMALL_PORT = LKParams((15, 15), 2, 10, 0.03, 1e-4)
KW = dict(xdim=160, ydim=120, streakline_capacity=16,
          population_rect=(40, 20, 80, 50))
PARTICLES = ("streaklines", "populationMap", "flowRedPoints")
POINTS = {"streaklines": lambda s: s.gens,
          "populationMap": lambda s: s.pop.vertices}


def _jax_points(mode):
    """The JAX init's random points of `mode` (None for flowRedPoints'
    grid, which both draw alike)."""
    if mode not in POINTS:
        return None
    init, _ = JAX_MODES[mode](JaxModeConfig(lk=SMALL, **KW))
    return np.asarray(POINTS[mode](init(np.zeros((120, 160, 3), np.uint8))))


@pytest.fixture(scope="module")
def particles_two_ranks(tmp_path_factory):
    """JAX's space-test clips through the port's run_videos on 2 ranks,
    the three modes in one spawn."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("particles")
    clips = [str(tmp / "a.mp4"), str(tmp / "b.mp4")]
    _write_clip(clips[0], 5, shift=1, seed=3)
    _write_clip(clips[1], 5, shift=2, seed=4)
    points = {m: _jax_points(m) for m in PARTICLES}
    kw = dict(lk=convert.lk_params(SMALL), **KW)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ranks.particles_rank,
                         args=(r, str(tmp / "store"), str(tmp), points,
                               clips, kw, 4)) for r in range(2)]
    for p in procs:
        p.start()
    _join(procs)
    return tmp, clips, points


def test_particle_modes_two_ranks_equal_one_process(particles_two_ranks,
                                                    monkeypatch):
    """Each mode's frames of both streams, and both ranks' last states,
    equal the one-process run's bit for bit."""
    tmp, clips, points = particles_two_ranks
    cfg = ModeConfig(lk=convert.lk_params(SMALL), **KW)
    for mode in PARTICLES:
        kept = {}
        monkeypatch.setattr(io_video, "VideoWriter",
                            ranks.keeping_writer(kept))
        with ranks.seeded(mode, points[mode]):
            stats = multirunner.run_videos(mode, clips, "ns", cfg, chunk=4,
                                           progress=False, device="cpu")
        want = ranks.final_states(stats.state)
        for i in (0, 1):
            got = np.load(tmp / f"{mode}_s{i}.npy")
            assert got.shape == (4, 120, 160, 3)
            assert np.array_equal(got, np.stack(kept[f"ns_s{i}.mp4"])), \
                (mode, i)
        for r in (0, 1):
            state = np.load(tmp / f"{mode}_state_{r}.npz")
            assert sorted(state.files) == sorted(want), (mode, r)
            for k, v in want.items():
                assert np.array_equal(state[k], v), (mode, r, k)
        moved = want["s0_" + {"streaklines": "verts",
                              "populationMap": "vertices",
                              "flowRedPoints": "pts"}[mode]]
        assert np.isfinite(moved).all()


def test_particle_modes_two_ranks_match_jax(particles_two_ranks,
                                            monkeypatch):
    """The port's 2-rank runs against JAX's run_videos(space=2) of the
    same clips from the same initial points."""
    tmp, clips, _ = particles_two_ranks
    want = {}
    monkeypatch.setattr(jmulti, "VideoWriter", ranks.keeping_writer(want))
    for mode in PARTICLES:
        jmulti.run_videos(mode, clips, f"jx_{mode}",
                          JaxModeConfig(lk=SMALL, **KW), chunk=4, space=2,
                          progress=False)
        for i in (0, 1):
            got = np.load(tmp / f"{mode}_s{i}.npy")
            jax_frames = np.stack(want[f"jx_{mode}_s{i}.mp4"])
            assert got.shape == jax_frames.shape
            assert np.mean(got != jax_frames) < 0.01, (mode, i)


def _pair(seed=0, h=120, w=160):
    """Two uint8 grays: smoothed noise and the same shifted 1 px right."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(lambda m: np.convolve(m, k, "same"), ax,
                                   base)
    return (torch.from_numpy(base.astype(np.uint8)),
            torch.from_numpy(np.roll(base, 1, axis=1).astype(np.uint8)))


def _edge_points(seed=0):
    """Points on every kind of row of a 120-row frame cut into 2 or 3
    bands: above and below the frame, at its last row and at 120, on and
    just above each band boundary (40, 60, 80), NaN and infinite rows, a
    NaN column; then random points over the frame and around it."""
    rows = [-30.0, -3.5, -0.5, 0.0, 39.99, 40.0, 59.999, 60.0, 60.5, 79.5,
            80.0, 119.0, 119.9, 120.0, 121.0, 200.0, float("nan"),
            float("inf"), -float("inf")]
    pts = [[20.0 + 6 * i, y] for i, y in enumerate(rows)]
    pts.append([float("nan"), 50.0])
    rng = np.random.default_rng(seed)
    rand = np.stack([rng.uniform(5, 155, 40), rng.uniform(-10, 130, 40)], -1)
    return torch.from_numpy(np.concatenate([np.array(pts), rand])
                            .astype(np.float32))


def _bands_sum(monkeypatch, pts, prev, gray, k):
    """track_points on each of k bands with the group's sum replaced by
    keeping each rank's part: -> (the summed parts, pyr_lk calls made)."""
    parts, calls = [], []
    monkeypatch.setattr(modes, "space_all_reduce",
                        lambda mesh, t, label: parts.append(t) or t)
    real = modes.pyr_lk
    monkeypatch.setattr(modes, "pyr_lk", lambda *a: calls.append(
        a[2].shape[0]) or real(*a))
    band = 120 // k
    for r in range(k):
        mesh = types.SimpleNamespace(space=k, coords={"space": r})
        modes.track_points(pts, prev, gray, SMALL_PORT, mesh,
                           (r * band, (r + 1) * band))
    return sum(parts[1:], parts[0]), calls



@pytest.mark.parametrize("k", [2, 3])
def test_each_point_goes_to_one_rank(monkeypatch, k):
    """Every point is owned by exactly one of k bands, and the bands'
    summed tracks equal one process's K3 plain call bit for bit; a band
    that owns no point makes no call."""
    prev, gray = _pair()
    pts = _edge_points()
    band = 120 // k
    owned = torch.stack([modes.owned_points(pts, (r * band, (r + 1) * band),
                                            120) for r in range(k)])
    assert (owned.sum(0) == 1).all(), owned.sum(0)
    got, calls = _bands_sum(monkeypatch, pts, prev, gray, k)
    assert sorted(calls) == sorted(owned.sum(1).tolist())
    want = pyr_lk(prev, gray, pts, SMALL_PORT).points
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and nan.any()
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))
    # a point with a NaN row is owned by the first band
    assert owned[0, torch.isnan(pts[:, 1])].all()
    top = pts[(pts[:, 1] >= 0) & (pts[:, 1] < band)]
    got, calls = _bands_sum(monkeypatch, top, prev, gray, k)
    assert calls == [top.shape[0]]
    assert torch.equal(got.view(torch.int32), pyr_lk(
        prev, gray, top, SMALL_PORT).points.view(torch.int32))
