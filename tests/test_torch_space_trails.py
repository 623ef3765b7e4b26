"""The space forms of the trail modes (streamlines,
timelinesOnSubtractAverageVector, timelinesFarne) and the exposure
modes (averageHSV, timex, brightColor) (``--mesh-space K``: each frame's
rows split over K gloo ranks, ``pipelines/multirunner.py``) on the CPU,
against the port's one-process run and the JAX package's runner, and
the band forms of the trail helpers.

The ranks are spawned from ``tests/_torch_space_trails.py`` (all six
modes in one spawn of 2 ranks; two modes in one spawn of 3) and meet
through a file:// store under tmp_path. Written frames are taken before
encoding. The clips are those of JAX's
``test_streams_with_space_sharding`` (160x120, 5 frames, chunk 4); the
rings hold 3 frames, so every ring wraps, and total_frames is 3, so the
trails' shade reaches its clamp. The trail modes start from the same 12
seeds on both sides (``_torch_space_trails.SEEDS``), spread over every
band.

Tolerances:
- against the one-process run, with the engine's flow (the trail modes,
  the first clip) and with one shared flow made from the gray (the
  trail modes, both clips), and for the exposure modes (both clips):
  every written frame and every stream's last state bit for bit, each
  rank holding its rows of the trail canvas, ring or running sum
  (``_torch_space_trails.band_state``) and the rest whole; at K = 2 and
  at K = 3 (bands of 40 rows);
- against JAX's ``run_videos(..., space=2)`` on the 8 virtual CPU devices
  of ``tests/conftest.py``: fewer than 1% of values differ (JAX's own
  bound for a sharded step), the trail modes on the shared flow
  (``tests/test_torch_space_dense.py`` says why);
- the band forms on 2 and 3 bands of a 120-row frame: bit for bit
  against the whole frame's rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_space_ranks as ranks
import _torch_space_trails as trails
from ripcurrents_tpu.pipelines import common as jcommon
from ripcurrents_tpu.pipelines import modes as jmodes
from ripcurrents_tpu.pipelines import multirunner as jmulti
from ripcurrents_tpu.pipelines.common import MODES as JAX_MODES
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch.pipelines import modes
from ripcurrents_tpu_torch.pipelines.common import ModeConfig

from test_torch_space import _join, _write_clip

torch.set_num_threads(1)


def _clips(tmp):
    clips = [str(tmp / "a.mp4"), str(tmp / "b.mp4")]
    _write_clip(clips[0], 5, shift=1, seed=3)
    _write_clip(clips[1], 5, shift=2, seed=4)
    return clips


def _spawn(tmp, clips, world):
    """trails_rank on `world` spawned ranks, started."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=trails.trails_rank,
                         args=(r, str(tmp / "store"), str(tmp), clips,
                               world)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


@pytest.fixture(scope="module")
def trails_two_ranks(tmp_path_factory):
    """JAX's space-test clips through the port's run_videos on 2 ranks,
    the six modes in one spawn (each rank then makes half of the
    one-process runs), and through JAX's run_videos(space=2) while the
    ranks work. -> (the ranks' folder, the clips, {mode: {s<i>: JAX's
    frames}})."""
    tmp = tmp_path_factory.mktemp("trails")
    clips = _clips(tmp)
    procs = _spawn(tmp, clips, 2)
    try:
        with pytest.MonkeyPatch.context() as mp_:
            jax_frames = _jax_runs(mp_, clips)
    finally:
        _join(procs)
    return tmp, clips, jax_frames


def _jax_runs(monkeypatch, clips) -> dict:
    """JAX's run_videos(space=2) of the six modes on the clips, the trail
    modes from SEEDS on the shared flow: {mode: {s<i>: frames}}."""
    want = {}
    monkeypatch.setattr(jmulti, "VideoWriter", ranks.keeping_writer(want))
    monkeypatch.setattr(jmodes, "flow_stream_step", lambda fs, g, fb: (
        jnp.stack([g / 64.0 - 2.0, 1.0 - g / 128.0], -1), fs))
    monkeypatch.setattr(jmodes, "flow_stream_init",
                        lambda g, fb: jcommon.FlowStream(()))
    for mode in trails.TRAILS:
        def seeded(cfg, factory=JAX_MODES[mode]):
            init, step = factory(cfg)
            return (lambda first: init(first)._replace(
                seeds=jnp.asarray(trails.SEEDS))), step
        monkeypatch.setitem(JAX_MODES, mode, seeded)
    # JAX keeps its compiled programs by (mode, config, streams): none
    # compiled before the patches may serve these runs, nor these a later
    # test
    jmulti._multi_program.cache_clear()
    try:
        for mode in trails.TRAILS + trails.EXPOSURE:
            jmulti.run_videos(mode, clips, f"jx_{mode}",
                              JaxModeConfig(**trails.KW),
                              chunk=trails.CHUNK, space=2, progress=False)
    finally:
        jmulti._multi_program.cache_clear()
    return {mode: {f"s{i}": np.stack(want[f"jx_{mode}_s{i}.mp4"])
                   for i in (0, 1)}
            for mode in trails.TRAILS + trails.EXPOSURE}


def _equal_one_process(tmp, todo, k):
    """Each run's frames and each of the k ranks' last states against the
    one-process run's, bit for bit."""
    band = 120 // k
    for mode, tag, videos, _ in todo:
        frames = np.load(tmp / f"{mode}_{tag}_one_frames.npz")
        state = dict(np.load(tmp / f"{mode}_{tag}_one_state.npz"))
        got = np.load(tmp / f"{mode}_{tag}_frames.npz")
        assert sorted(got.files) == sorted(frames.files) == \
            [f"s{i}" for i in range(len(videos))]
        for s in frames.files:
            assert frames[s].shape == (4, 120, 160, 3)
            assert np.array_equal(got[s], frames[s]), (mode, tag, s)
        for r in range(k):
            held = np.load(tmp / f"{mode}_{tag}_state_{r}.npz")
            want = trails.band_state(state, (band * r, band * (r + 1)))
            assert sorted(held.files) == sorted(want), (mode, r)
            for key, v in want.items():
                assert np.array_equal(held[key], v), (mode, tag, r, key)
        if mode in trails.TRAILS:
            # trails were drawn, at the clamped shade, and the seeds moved
            assert state["s0_overlay"].max() == 255
            assert not np.array_equal(state["s0_seeds"], trails.SEEDS)
            assert (tag == "flow") == any(k.startswith("s0_exp")
                                          for k in state)
        else:
            field = {"averageHSV": "buffer", "timex": "sum_rgb",
                     "brightColor": "buffer"}[mode]
            assert np.abs(state[f"s0_{field}"]).max() > 0


def test_trail_and_exposure_modes_two_ranks_equal_one_process(
        trails_two_ranks):
    """Each mode's frames of every stream, and each rank's last state (its
    rows of the trail canvas, ring or sum; the flow stream, the seeds,
    the counts whole), equal the one-process run's bit for bit, the
    trail modes with the engine's flow and with the shared one."""
    tmp, clips, _ = trails_two_ranks
    _equal_one_process(tmp, trails.runs(clips), 2)


def test_trail_and_exposure_modes_two_ranks_match_jax(trails_two_ranks):
    """The port's 2-rank runs (the trail modes on the shared flow) against
    JAX's run_videos(space=2) of the same clips."""
    tmp, _, jax_frames = trails_two_ranks
    for mode, want in jax_frames.items():
        tag = "shared" if mode in trails.TRAILS else "plain"
        got = np.load(tmp / f"{mode}_{tag}_frames.npz")
        for s, w in want.items():
            assert got[s].shape == w.shape
            assert np.mean(got[s] != w) < 0.01, (mode, s)


def test_trail_band_forms_equal_whole_frame_rows():
    """On each of k = 2 and 3 bands of a 120x160 frame, the trail step's
    band forms give the whole frame's rows bit for bit: the advection
    and the trails drawn on the band's canvas
    (``_advect_and_draw_trails(band=)``), the composite on the band
    (``_composite_trails``) and timelinesFarne's vertex line and frame
    count (``draw_vertex_line(band=)``)."""
    h, w = 120, 160
    rng = np.random.default_rng(5)
    cfg = ModeConfig(**trails.KW)
    flow = torch.from_numpy((rng.standard_normal((h, w, 2)) * 3.0)
                            .astype(np.float32))
    frame = torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8))
    canvas = torch.from_numpy(np.where(rng.random((h, w)) < 0.9, 0,
                                       rng.integers(1, 256, (h, w)))
                              .astype(np.uint8))
    seeds = torch.from_numpy(trails.SEEDS)
    fc = torch.tensor(2, dtype=torch.int32)
    moved, whole = modes._advect_and_draw_trails(seeds, canvas, flow, fc,
                                                 cfg, upper=8.0)
    composite = modes._composite_trails(frame, whole)
    line = modes.draw_vertex_line(frame, moved, fc)
    for k in (2, 3):
        band = h // k
        for r in range(k):
            rows = slice(r * band, (r + 1) * band)
            got, got_canvas = modes._advect_and_draw_trails(
                seeds, canvas[rows], flow, fc, cfg, upper=8.0,
                band=(r * band, h))
            assert torch.equal(got, moved), (k, r)
            assert torch.equal(got_canvas, whole[rows]), (k, r)
            # each band gets trails of its own
            assert not torch.equal(got_canvas, canvas[rows]), (k, r)
            assert torch.equal(modes._composite_trails(frame[rows],
                                                       got_canvas),
                               composite[rows]), (k, r)
            assert torch.equal(modes.draw_vertex_line(
                frame[rows], moved, fc, band=(r * band, h)), line[rows]), \
                (k, r)
    assert torch.isfinite(moved).all() and not torch.equal(moved, seeds)


def test_trail_and_exposure_modes_three_ranks_equal_one_process(tmp_path):
    """--mesh-space 3 (bands of 40 rows): timelinesOnSubtractAverageVector
    on the engine's flow and brightColor, frames and each rank's last
    state bit for bit against one process."""
    clips = _clips(tmp_path)
    _join(_spawn(tmp_path, clips, 3))
    _equal_one_process(tmp_path, trails.runs_k3(clips), 3)
