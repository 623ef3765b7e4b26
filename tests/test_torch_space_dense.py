"""The space forms of subtructAverageVector,
subtructAverageVectorWithWindow, shearRate and averageVector
(``--mesh-space 2``: each frame's rows split over 2 gloo ranks, the
whole frame's flow on every rank, ``pipelines/multirunner.py``) on the
CPU, against the port's one-process run and the JAX package's runner,
and the band forms of the drawing and field helpers they use.

The ranks are spawned from ``tests/_torch_space_dense.py`` (all four
modes in one spawn) and meet through a file:// store under tmp_path.
Written frames are taken before encoding. The clips are those of JAX's
``test_streams_with_space_sharding`` (160x120, 5 frames, chunk 4); each
ring holds 3 frames, so every ring wraps on both ranks.

Tolerances:
- against the one-process run, with the engine's flow (the first clip)
  and with one shared flow (both clips): every written frame and every
  stream's last state bit for bit, each rank holding its rings' rows
  (``_torch_space_dense.band_state``) and the rest whole;
- against JAX's ``run_videos(..., space=2)`` on the 8 virtual CPU devices
  of ``tests/conftest.py``: fewer than 1% of values differ (JAX's own
  bound for a sharded step), both sides stepping on one flow made from
  the gray frame, as ``tests/test_torch_multirunner.py`` does for
  subtructAverageVector (its docstring says why);
- the band forms on 2 and 3 bands of a 120-row frame: bit for bit
  against the whole frame's rows.
"""

import contextlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_space_dense as dense
import _torch_space_ranks as ranks
from ripcurrents_tpu.pipelines import common as jcommon
from ripcurrents_tpu.pipelines import modes as jmodes
from ripcurrents_tpu.pipelines import multirunner as jmulti
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch.analysis.shear import (OFFSET, shear_frobenius,
                                                  shear_to_color)
from ripcurrents_tpu_torch.dynamics.advect import delta_field
from ripcurrents_tpu_torch.pipelines import modes
from ripcurrents_tpu_torch.viz import draw
from ripcurrents_tpu_torch.viz.color import color_wheel, vector_to_color

from test_torch_space import _join, _write_clip

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dense_two_ranks(tmp_path_factory):
    """JAX's space-test clips through the port's run_videos on 2 ranks,
    the four modes in one spawn (each rank then makes half of the
    one-process runs), and through JAX's run_videos(space=2) on the
    shared flow while the ranks work. -> (the ranks' folder, the clips,
    {mode: {s<i>: JAX's frames}})."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("dense")
    clips = [str(tmp / "a.mp4"), str(tmp / "b.mp4")]
    _write_clip(clips[0], 5, shift=1, seed=3)
    _write_clip(clips[1], 5, shift=2, seed=4)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dense.dense_rank,
                         args=(r, str(tmp / "store"), str(tmp), clips))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        with pytest.MonkeyPatch.context() as mp_:
            jax_frames = _jax_runs(mp_, clips)
    finally:
        _join(procs)
    return tmp, clips, jax_frames


def _jax_runs(monkeypatch, clips) -> dict:
    """JAX's run_videos(space=2) of each mode of DENSE on the clips, with
    the shared flow: {mode: {s<i>: frames}}. shearRate's run is eager
    (``jax.disable_jit``): compiled, XLA rounds JAX's own ``hsv_to_bgr``
    otherwise at 59 of the 256 hues of full saturation and value (a
    level of one channel), which is every pixel of that mode, and 3% of
    its values differ from JAX's eager run; eager, JAX's one process
    equals the port's bit for bit."""
    want = {}
    monkeypatch.setattr(jmulti, "VideoWriter", ranks.keeping_writer(want))
    monkeypatch.setattr(jmodes, "flow_stream_step", lambda fs, g, fb: (
        jnp.stack([g / 64.0 - 2.0, 1.0 - g / 128.0], -1), fs))
    monkeypatch.setattr(jmodes, "flow_stream_init",
                        lambda g, fb: jcommon.FlowStream(()))
    # JAX keeps its compiled programs by (mode, config, streams): none
    # compiled before the patch may serve these runs, nor these a later
    # test
    jmulti._multi_program.cache_clear()
    try:
        for mode in dense.DENSE:
            with (jax.disable_jit() if mode == "shearRate"
                  else contextlib.nullcontext()):
                jmulti.run_videos(mode, clips, f"jx_{mode}",
                                  JaxModeConfig(**dense.KW),
                                  chunk=dense.CHUNK, space=2,
                                  progress=False)
    finally:
        jmulti._multi_program.cache_clear()
    return {mode: {f"s{i}": np.stack(want[f"jx_{mode}_s{i}.mp4"])
                   for i in (0, 1)} for mode in dense.DENSE}


def test_dense_modes_two_ranks_equal_one_process(dense_two_ranks):
    """Each mode's frames of every stream, and each rank's last state
    (its rings' rows, the flow stream, the maximum, the count), equal
    the one-process run's bit for bit, with the engine's flow and with
    the shared one."""
    tmp, clips, _ = dense_two_ranks
    for mode, tag, _, _ in dense.runs(clips):
        frames = np.load(tmp / f"{mode}_{tag}_one_frames.npz")
        state = dict(np.load(tmp / f"{mode}_{tag}_one_state.npz"))
        got = np.load(tmp / f"{mode}_{tag}_frames.npz")
        assert sorted(got.files) == sorted(frames.files) == \
            (["s0"] if tag == "flow" else ["s0", "s1"])
        for s in frames.files:
            assert frames[s].shape == (4, 120, 160, 3)
            assert np.array_equal(got[s], frames[s]), (mode, tag, s)
        for r in (0, 1):
            held = np.load(tmp / f"{mode}_{tag}_state_{r}.npz")
            want = dense.band_state(state, mode, (60 * r, 60 * r + 60), 120)
            assert sorted(held.files) == sorted(want), (mode, r)
            for k, v in want.items():
                assert np.array_equal(held[k], v), (mode, tag, r, k)
        if mode != "subtructAverageVector":
            assert state["s0_index"] == 4 % 3 and \
                np.abs(state["s0_buffer"]).max() > 0
        if tag == "flow":
            assert any(k.startswith("s0_exp") for k in state)


def test_dense_modes_two_ranks_match_jax(dense_two_ranks):
    """The port's 2-rank runs on the shared flow against JAX's
    run_videos(space=2) of the same clips on the same flow."""
    tmp, _, jax_frames = dense_two_ranks
    for mode in dense.DENSE:
        got = np.load(tmp / f"{mode}_shared_frames.npz")
        for s, want in jax_frames[mode].items():
            assert got[s].shape == want.shape
            assert np.mean(got[s] != want) < 0.01, (mode, s)


def _flow(seed, h=120, w=160, scale=3.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((h, w, 2)) * scale)
                            .astype(np.float32))


@pytest.mark.parametrize("k", [2, 3])
def test_band_forms_equal_whole_frame_rows(k):
    """On each of k bands of a 120x160 frame, the band forms give the
    whole frame's rows bit for bit: ``draw.paste`` (a legend at the top,
    across the bands' boundaries, clamped at the bottom),
    ``draw_frame_count`` (digits across a boundary), ``draw_arrows``
    (random arrows in and out of the frame), ``shear_frobenius`` and
    ``shear_to_color`` on the band and its ``shear.OFFSET`` rows on each
    side (``modes.shear_rows``), ``delta_field`` and ``vector_to_color``
    on the band."""
    h, w, band = 120, 160, 120 // k
    rng = np.random.default_rng(k)
    img = torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8))
    legend = color_wheel(30)
    pastes = ((0, w - 30), (band - 7, 11), (h - 10, 50))
    counts = ((12345, (30, band - 4)), (7, (100, 30)), (96, (3, h - 8)))
    starts = torch.from_numpy(rng.uniform(-20, 180, (24, 2))
                              .astype(np.float32))
    ends = starts + torch.from_numpy(rng.uniform(-60, 60, (24, 2))
                                     .astype(np.float32))
    valid = torch.from_numpy(rng.random(24) < 0.8)
    flow = _flow(k)
    flow[50:70, 40:60] *= 40.0     # deltas over the bound: frozen there
    mean = _flow(k + 10)
    whole = {
        "paste": [draw.paste(img, legend, y, x) for y, x in pastes],
        "count": [draw.draw_frame_count(img, fc, pos) for fc, pos in counts],
        "arrows": draw.draw_arrows(img, starts, ends, valid, (0, 255, 0),
                                   2, 0.3),
        "shear": shear_frobenius(mean, OFFSET),
        "hue": shear_to_color(mean, 5.0).hsv_u8,
        "delta": delta_field(flow, 2.0, 100.0),
        "color": vector_to_color(flow, 4.0).bgr_u8,
    }
    maxima = []
    for r in range(k):
        rows = (r * band, (r + 1) * band)
        cut, at = img[rows[0]:rows[1]], (rows[0], h)
        s0, s1 = modes.shear_rows(rows, h)
        assert (s0, s1) == (max(rows[0] - 10, 0), min(rows[1] + 10, h))
        sheared = shear_to_color(mean[s0:s1], 5.0, OFFSET,
                                 band=(s0, h), rows=rows)
        maxima.append(sheared.max_frobenius)
        got = {
            "paste": [draw.paste(cut, legend, y, x, band=at)
                      for y, x in pastes],
            "count": [draw.draw_frame_count(cut, fc, pos, row0=rows[0])
                      for fc, pos in counts],
            "arrows": draw.draw_arrows(cut, starts, ends, valid,
                                       (0, 255, 0), 2, 0.3, band=at),
            "shear": shear_frobenius(mean[s0:s1], OFFSET,
                                     band=(s0, h))[rows[0] - s0:
                                                   rows[1] - s0],
            "hue": sheared.hsv_u8,
            "delta": delta_field(flow, 2.0, 100.0, rows),
            "color": vector_to_color(flow, 4.0, rows).bgr_u8,
        }
        for key, want in whole.items():
            pairs = zip(got[key], want) if isinstance(want, list) else \
                [(got[key], want)]
            for g, wnt in pairs:
                assert torch.equal(g, wnt[rows[0]:rows[1]]), (key, r)
    # the group's max of the bands' maxima is the whole frame's
    assert torch.equal(torch.stack(maxima).max(),
                       shear_to_color(mean, 5.0).max_frobenius)
    assert torch.equal(vector_to_color(flow, 4.0, (0, band))
                       .max_displacement,
                       vector_to_color(flow, 4.0).max_displacement)
    # the cases above draw in more than one band, and the shear's zeroed
    # border reaches into the first and last band
    assert all(not torch.equal(p, img) for p in whole["paste"])
    assert (whole["shear"][:10] == 0).all() and \
        (whole["shear"][10:-10, 10:-10] > 0).all()
    assert (whole["delta"][50:70, 40:60] == 0).any() and \
        math.isfinite(float(whole["delta"].abs().max()))
