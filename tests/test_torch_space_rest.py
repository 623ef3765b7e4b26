"""The space forms of android, phaseCorrelate, globalOrientation and
stabilizeTPU (``--mesh-space K``: each frame's rows split over K gloo
ranks, ``pipelines/multirunner.py``) on the CPU, against the port's
one-process run and the JAX package's runner, and their band forms.

The ranks are spawned from ``tests/_torch_space_rest.py`` (the four
modes in one spawn of 2 ranks; two modes in one spawn of 3) and meet
through a file:// store under tmp_path. Written frames are taken before
encoding. The clips are those of JAX's
``test_streams_with_space_sharding`` (160x120, 5 frames, chunk 4) and a
240x180 clip that moves down 2 px a frame, resized to 160x120 with the
frame pump and without it (``_torch_space_rest.big_clip``). android
starts from a live state at i = 89 (``_torch_space_rest.ACC``), so its
overlay is drawn from the third step on.

Tolerances:
- against the one-process run: every written frame and every stream's
  last state bit for bit, each rank holding android's accumulator over
  ``modes.android_rows``, phaseCorrelate's previous frame over its
  ROI's rows and the rest whole (``_torch_space_rest.band_state``); at K
  = 2 and at K = 3 (bands of 40 rows);
- against JAX's ``run_videos(..., space=2)`` on the 8 virtual CPU devices
  of ``tests/conftest.py``: fewer than 1% of the values of each stream's
  frames differ (JAX's own bound for a sharded step), each by at most
  one level (measured: android none, phaseCorrelate 0.003-0.007% by one
  level). globalOrientation is the exception: its differing values
  (measured 0.002-0.005%) are 0, 215 or 255 on both sides, a pixel of
  the binary motion-history image that flips by 255 or a grid arrow's
  end drawn one pixel over. android runs on the shared flow of
  the gray (``tests/test_torch_space_dense.py`` says why) from the same
  live state. stabilizeTPU's port run takes the RANSAC noise JAX draws
  (its key split once a step, as ``tests/test_torch_stabilize_mode.py``
  recomputes it) and is held to JAX's one-device steps on the same
  frames: within one level where both warps sample inside the frame
  (measured: equal); where one samples outside (0) and the other not,
  at most FLIP_SHARE of the values, and at most 10% of the pixels
  outside on either side;
- the band forms on 2 and 3 bands of a 120-row frame: bit for bit
  against the whole frame's rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_space_rest as rest
from ripcurrents_tpu.pipelines import android as jandroid
from ripcurrents_tpu.pipelines import common as jcommon
from ripcurrents_tpu.pipelines import multirunner as jmulti
from ripcurrents_tpu.pipelines.common import MODES as JAX_MODES
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch.analysis import classify as cls
from ripcurrents_tpu_torch.io import native
from ripcurrents_tpu_torch.ops.warp import translate
from ripcurrents_tpu_torch.pipelines import modes
from ripcurrents_tpu_torch.viz import draw

import _torch_space_ranks as ranks
from test_torch_space import _join
from test_torch_space_trails import _clips

torch.set_num_threads(1)

# the frame count after android's first step from the live state
I1 = rest.I0 + 1
# stabilizeTPU against JAX: the share of values where one warp samples
# outside the frame and the other not (H's last digits differ; measured
# 1.13% and 1.29% on the two clips)
FLIP_SHARE = 0.025
# globalOrientation's values: the motion-history image's 0 and 255, the
# arrows' gold (0, 215, 255) and green (0, 215, 0)
LEVELS = (0, 215, 255)


def _jax_noise_steps(steps: int) -> np.ndarray:
    """The RANSAC noise of stabilizeTPU's first `steps` steps in JAX's
    runner: the state's key (PRNGKey(seed)) split once a step, 64 trials
    of Gumbel noise over 256 corners from the subkey."""
    key, out = jax.random.PRNGKey(0), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, 64)
        out.append(np.asarray(jax.vmap(
            lambda k: jax.random.gumbel(k, (256,)))(keys)))
    return np.stack(out).astype(np.float32)


def _spawn(tmp, clips, big, noise, world):
    """rest_rank on `world` spawned ranks, started."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rest.rest_rank,
                         args=(r, str(tmp / "store"), str(tmp), clips, big,
                               noise, world)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _inputs(tmp):
    """The clips and the 240x180 clip; the pump built here first, so the
    ranks load it."""
    clips = _clips(tmp)
    big = str(tmp / "big.mp4")
    rest.big_clip(big)
    assert native.available()
    return clips, big


@pytest.fixture(scope="module")
def rest_two_ranks(tmp_path_factory):
    """The four modes through the port's run_videos on 2 ranks in one
    spawn (each rank then makes half of the one-process runs), and JAX's
    run_videos(space=2) while the ranks work. -> (the ranks' folder, the
    clips, {mode: {s<i>: JAX's frames}})."""
    tmp = tmp_path_factory.mktemp("rest")
    clips, big = _inputs(tmp)
    procs = _spawn(tmp, clips, big, _jax_noise_steps(4), 2)
    try:
        with pytest.MonkeyPatch.context() as mp_:
            jax_frames = _jax_runs(mp_, clips)
    finally:
        _join(procs)
    return tmp, (clips, big), jax_frames


def _jax_runs(monkeypatch, clips) -> dict:
    """JAX's run_videos(space=2) of the four modes on the clips, android
    from the live state on the shared flow: {mode: {s<i>: frames}}."""
    want = {}
    monkeypatch.setattr(jmulti, "VideoWriter", ranks.keeping_writer(want))
    monkeypatch.setattr(jandroid, "flow_stream_step", lambda fs, g, fb: (
        jnp.stack([g / 64.0 - 2.0, 1.0 - g / 128.0], -1), fs))
    monkeypatch.setattr(jandroid, "flow_stream_init",
                        lambda g, fb: jcommon.FlowStream(()))

    def live(cfg, factory=JAX_MODES["android"]):
        init, step = factory(cfg)
        return (lambda first: init(first)._replace(
            accumulator=jnp.asarray(rest.ACC),
            i=jnp.array(rest.I0, jnp.int32))), step
    monkeypatch.setitem(JAX_MODES, "android", live)
    # JAX keeps its compiled programs by (mode, config, streams): none
    # compiled before the patches may serve these runs, nor these a later
    # test
    jmulti._multi_program.cache_clear()
    try:
        for mode in rest.REST[:3]:
            jmulti.run_videos(mode, clips, f"jx_{mode}",
                              JaxModeConfig(**rest.KW), chunk=rest.CHUNK,
                              space=2, progress=False)
    finally:
        jmulti._multi_program.cache_clear()
    got = {mode: {f"s{i}": np.stack(want[f"jx_{mode}_s{i}.mp4"])
                  for i in (0, 1)} for mode in rest.REST[:3]}
    got["stabilizeTPU"] = {f"s{i}": _jax_stabilize_steps(c)
                           for i, c in enumerate(clips)}
    return got


def _jax_stabilize_steps(clip) -> np.ndarray:
    """JAX's stabilizeTPU stepped op by op on one device over the clip's
    frames (its own key splits, the draws the port run is given): XLA's
    compile of the runner's program moves H by a last digit, enough to
    flip 0.4-2% of the frames' edge pixels in or out of the frame."""
    import cv2
    cap, frames = cv2.VideoCapture(clip), []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    init, step = JAX_MODES["stabilizeTPU"](JaxModeConfig(**rest.KW))
    state, outs = init(jnp.asarray(frames[0])), []
    for f in frames[1:]:
        state, out = step(state, jnp.asarray(f))
        outs.append(np.asarray(out))
    return np.stack(outs)


def _drawn_near_boundaries(frames, k):
    """Whether android's overlay was drawn within 40 rows of each of the
    k bands' boundaries: rows where more than 10% of the pixels have
    their red channel at 255 (about 0.4% do in the clips' noise)."""
    rows = np.nonzero((frames[..., 2] == 255).mean(axis=(0, 2)) > 0.1)[0]
    return all(np.any(np.abs(rows - 120 // k * b) < 40)
               for b in range(1, k))


def _equal_one_process(tmp, todo, k):
    """Each run's frames and each of the k ranks' last states against the
    one-process run's, bit for bit."""
    band = 120 // k
    for mode, tag, videos in todo:
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
            want = rest.band_state(state, mode, (band * r, band * (r + 1)),
                                   120)
            assert sorted(held.files) == sorted(want), (mode, r)
            for key, v in want.items():
                assert np.array_equal(held[key], v), (mode, tag, r, key)
        assert all(np.isfinite(v).all() for v in state.values()
                   if v.dtype.kind == "f"), (mode, tag)
        if mode == "android":
            assert _drawn_near_boundaries(frames["s0"], k), (tag, k)
        if mode == "phaseCorrelate" and tag != "pump":
            # the clips move, so the corrected frames are not the frames
            # stepped, resized (the pump's resize is another)
            for s, video in zip(frames.files, videos):
                moved = np.mean(frames[s] != rest.area_frames(video)[1:])
                assert moved > 0.5, (tag, s, moved)


def test_rest_modes_two_ranks_equal_one_process(rest_two_ranks):
    """Each mode's frames of every stream, and each rank's last state
    (android's accumulator rows, phaseCorrelate's ROI rows; the flow
    stream, the stable flow, the histogram, the grays and the counts
    whole), equal the one-process run's bit for bit: android on the
    engine's flow and on the shared one, stabilizeTPU with its own and
    with JAX's draws, android and phaseCorrelate resized by the pump and
    on the device."""
    tmp, (clips, big), _ = rest_two_ranks
    _equal_one_process(tmp, rest.runs(clips, big), 2)


def test_rest_modes_two_ranks_match_jax(rest_two_ranks):
    """The port's 2-rank runs (android on the shared flow, stabilizeTPU
    with JAX's draws) against JAX's run_videos(space=2) of the same
    clips."""
    tmp, _, jax_frames = rest_two_ranks
    for mode, want in jax_frames.items():
        tag = {"android": "shared", "stabilizeTPU": "jaxnoise"}.get(
            mode, "plain")
        got = np.load(tmp / f"{mode}_{tag}_frames.npz")
        for s, w in want.items():
            g = got[s]
            assert g.shape == w.shape
            if mode == "stabilizeTPU":
                # where one side's warp sampled outside the frame (0)
                inside = (g.max(-1) > 0) & (w.max(-1) > 0)
                assert np.mean(~inside) < 0.1, (s, np.mean(~inside))
                assert np.mean(g != w) < FLIP_SHARE, (s, np.mean(g != w))
                g, w = g[inside], w[inside]
            assert np.mean(g != w) < 0.01, (mode, s, np.mean(g != w))
            diff = g != w
            if mode == "globalOrientation":
                # a pixel of the binary motion-history image flipped, or a
                # grid arrow's end fell on a neighbouring pixel
                assert np.isin(g[diff], LEVELS).all() and \
                    np.isin(w[diff], LEVELS).all(), (s, set(g[diff]))
            else:
                assert np.abs(g.astype(np.int32) - w).max(initial=0) <= 1, \
                    (mode, s)


def test_rest_band_forms_equal_whole_frame_rows():
    """On each of k = 2 and 3 bands of a 120x160 frame, bit for bit
    against the whole frame's rows: android's local rip windows from
    the live state's duty (``android_local_rip(band=)`` over
    ``modes.android_rows``; rip pixels lie within 40 rows of every
    boundary, and the band's rows alone would give another mask),
    ``draw_circles(band=)`` with discs across the boundaries and
    phaseCorrelate's translation of a band at fractional |dy| > 1."""
    h, w = 120, 160
    duty = cls.android_duty_viz(torch.from_numpy(rest.ACC), I1)
    whole = cls.android_local_rip(duty, 20)
    rng = np.random.default_rng(8)
    centers = torch.from_numpy(rng.uniform((-5, -5), (165, 125), (40, 2))
                               .astype(np.float32))
    canvas = torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8))
    circles = draw.draw_circles(canvas, centers, 4, (100, 0, 0))
    shifts = ((0.4, 1.7), (-2.6, -2.3))
    moved = [translate(canvas, dx, dy) for dx, dy in shifts]
    for k in (2, 3):
        band = h // k
        rip_rows = np.nonzero(whole.numpy().any(axis=1))[0]
        for b in range(1, k):
            assert np.any(np.abs(rip_rows - band * b) < 40), (k, b)
        for r in range(k):
            rows = (r * band, (r + 1) * band)
            k0, k1 = modes.android_rows(rows, h)
            got = cls.android_local_rip(
                cls.android_duty_viz(torch.from_numpy(rest.ACC[k0:k1]), I1),
                20, band=(k0, h))[rows[0] - k0:rows[1] - k0]
            assert torch.equal(got, whole[rows[0]:rows[1]]), (k, r)
            cut = slice(*rows)
            assert torch.equal(draw.draw_circles(
                canvas[cut], centers, 4, (100, 0, 0), band=(rows[0], h)),
                circles[cut]), (k, r)
            for (dx, dy), want in zip(shifts, moved):
                assert torch.equal(translate(canvas, dx, dy, rows=rows),
                                   want[cut]), (k, r, dy)
        # the band's rows alone miss the windows across its boundary
        alone = cls.android_local_rip(
            cls.android_duty_viz(torch.from_numpy(rest.ACC[band:2 * band]),
                                 I1), 20, band=(band, h))
        assert not torch.equal(alone, whole[band:2 * band]), k
    assert 0 < (whole == 255).float().mean() < 0.5


def test_rest_modes_three_ranks_equal_one_process(tmp_path):
    """--mesh-space 3 (bands of 40 rows): android on the engine's flow
    from the live state, and phaseCorrelate on the 240x180 clip resized
    on the device (the whole frame's INTER_AREA resize on every rank),
    frames and each rank's last state bit for bit against one process."""
    clips, big = _inputs(tmp_path)
    _join(_spawn(tmp_path, clips, big, None, 3))
    _equal_one_process(tmp_path, rest.runs_k3(clips, big), 3)
