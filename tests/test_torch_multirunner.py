"""The port's multi-stream runner (``pipelines/multirunner.py``) and the
CLI's ``--videos`` on the CPU, against the JAX package's runner.

Each runner's written frames are taken before encoding (the writer is
swapped for one that keeps them), so the comparison reads the modes'
outputs and not the codec's. Tolerances: the port's streams against
JAX's, the share of differing pixel values below 1% (the bound of JAX's
own ``tests/test_multirunner.py``); the port's streams against the port's
``run_video`` of each clip, bit for bit.

``timelines`` runs both engines (measured: equal). For
``subtructAverageVector`` the engines' known deviation exceeds that
bound: a colour mode moves ~10% of its pixels by a level at 1e-4 px of
flow difference (``tests/test_torch_dense_modes.py``), and on these noise
clips 73% of the values differ against JAX's CPU engine, 17% against its
TPU engine in interpret mode. So both runners step that mode on the same
flow, a function of the uploaded gray frame, as
``tests/test_torch_dense_modes.py`` feeds both sides one flow; what
differs then is the host gray (OpenCV's cvtColor on JAX's side, the
reference's fixed point on the port's): 0.07-0.09% of the values.
"""

import json
import threading

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.pipelines import modes as jmodes
from ripcurrents_tpu.pipelines import multirunner as jmulti
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch import cli
from ripcurrents_tpu_torch.io import video as io_video
from ripcurrents_tpu_torch.pipelines import modes as tmodes
from ripcurrents_tpu_torch.pipelines import multirunner, runner
from ripcurrents_tpu_torch.pipelines.common import ModeConfig

torch.set_num_threads(1)

JAX_KEYS = {"mode", "streams", "frames_total", "seconds", "aggregate_fps",
            "per_stream_fps", "resolution", "gray_upload", "mesh", "device"}


def _write_clip(path, n, shift, size=(160, 120), seed=0):
    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                        size)
    base = rng.uniform(0, 255, (size[1], size[0], 3)).astype(np.float32)
    for t in range(n):
        w.write(np.clip(np.roll(base, shift * t, axis=1), 0, 255)
                .astype(np.uint8))
    w.release()


def _keeping_writer(store: dict):
    """A VideoWriter stand-in that keeps each path's frames."""
    class Writer:
        def __init__(self, path, fps, size_hw, fourcc=None):
            self.frames = store.setdefault(str(path), [])

        def write(self, frame):
            self.frames.append(np.array(frame))

        def write_batch(self, frames):
            for f in frames:
                self.write(f)

        def close(self):
            pass
    return Writer


def test_stream_mesh_matches_jax():
    """The stream axis is the largest divisor of the stream count that
    fits the world: equal to JAX's on its 8 virtual devices for a world
    of 8, 1 for a world of 1; --mesh-space beyond the world or not
    dividing the frame height raises naming the flag."""
    for n in (1, 2, 3, 5, 16):
        want = jmulti._stream_mesh(n).shape
        assert multirunner._stream_mesh(n, world=8).shape == dict(want)
        assert multirunner._stream_mesh(n).shape == {"stream": 1,
                                                     "space": 1}
    assert multirunner._stream_mesh(2, 2, world=8).shape == \
        dict(jmulti._stream_mesh(2, space=2).shape) == {"stream": 2,
                                                        "space": 2}
    for args in ((2, 2), (2, 3, 2), (2, 0)):
        with pytest.raises(ValueError, match="--mesh-space"):
            multirunner._stream_mesh(*args)
    with pytest.raises(ValueError, match="--mesh-space 2 does not divide"):
        multirunner._stream_mesh(2, 2, world=2, ydim=121)


@pytest.mark.parametrize("mode", ["timelines", "subtructAverageVector"])
def test_two_streams_match_jax(tmp_path, monkeypatch, mode):
    """2 clips (160x120, 9 frames, chunk 4) through the port's run_videos
    on the CPU and through JAX's: the same frame count, each stream's
    frames within 1% of differing pixels of JAX's."""
    clips = []
    for i, shift in enumerate((1, 2)):
        clips.append(str(tmp_path / f"{i}.mp4"))
        _write_clip(clips[-1], 9, shift=shift, seed=i + 1)
    got, want = {}, {}
    monkeypatch.setattr(io_video, "VideoWriter", _keeping_writer(got))
    monkeypatch.setattr(jmulti, "VideoWriter", _keeping_writer(want))
    if mode == "subtructAverageVector":
        # both sides stepped on the same flow: a function of the gray frame
        monkeypatch.setattr(jmodes, "flow_stream_step", lambda fs, g, fb: (
            jnp.stack([g / 64.0 - 2.0, 1.0 - g / 128.0], -1), fs))
        monkeypatch.setattr(tmodes, "flow_stream_step", lambda fs, g, fb: (
            torch.stack([g / 64.0 - 2.0, 1.0 - g / 128.0], -1), fs))
    kw = dict(xdim=160, ydim=120)
    stats = multirunner.run_videos(mode, clips, "multi", ModeConfig(**kw),
                                   chunk=4, progress=False, device="cpu")
    # JAX keeps its compiled program by (mode, config, streams): one that
    # an earlier test of this process compiled (tests/test_multirunner.py
    # runs these modes at 160x120) would not step on the patched flow,
    # nor may this test's reach a later one
    jmulti._multi_program.cache_clear()
    try:
        jstats = jmulti.run_videos(mode, clips, "multi",
                                   JaxModeConfig(**kw), chunk=4,
                                   progress=False)
    finally:
        jmulti._multi_program.cache_clear()
    assert stats.frames == jstats.frames == 16
    assert sorted(got) == sorted(want) == ["multi_s0.mp4", "multi_s1.mp4"]
    for path in got:
        a, b = np.stack(got[path]), np.stack(want[path])
        assert a.shape == b.shape == (8, 120, 160, 3)
        assert np.mean(a != b) < 0.01, (path, np.mean(a != b))


def test_streams_equal_run_video_and_cli(tmp_path, monkeypatch):
    """Each stream of run_videos equals the port's run_video of its clip
    bit for bit; unequal lengths stop at the shortest with every producer
    thread joined when run_videos returns; `cli.main --videos a b
    --device cpu` writes <stem>_s0 and _s1 and a metrics JSON with JAX's
    keys."""
    clips = []
    for i, (n, shift) in enumerate(((9, 1), (9, 2), (6, 3))):
        clips.append(str(tmp_path / f"{i}.mp4"))
        _write_clip(clips[-1], n, shift=shift, seed=i + 5)
    cfg = ModeConfig(xdim=128, ydim=96)
    kept = {}
    monkeypatch.setattr(io_video, "VideoWriter", _keeping_writer(kept))
    multirunner.run_videos("timelines", clips[:2], "multi", cfg, chunk=4,
                           progress=False, device="cpu")
    for i, clip in enumerate(clips[:2]):
        runner.run_video("timelines", clip, f"single{i}.mp4", cfg, chunk=4,
                         progress=False, device="cpu")
        np.testing.assert_array_equal(np.stack(kept[f"multi_s{i}.mp4"]),
                                      np.stack(kept[f"single{i}.mp4"]))

    before = set(threading.enumerate())
    stats = multirunner.run_videos("timelines", [clips[0], clips[2]], None,
                                   cfg, chunk=4, progress=False,
                                   device="cpu")
    assert stats.frames == 2 * 5       # the shorter clip scans 5 frames
    assert set(threading.enumerate()) <= before

    monkeypatch.chdir(tmp_path)
    rc = cli.main(["agg", "--videos", clips[0], clips[1], "--mode",
                   "timelines", "--xdim", "128", "--ydim", "96", "--chunk",
                   "4", "--device", "cpu", "--metrics-json", "mm.json"])
    assert rc == 0
    assert len(kept["agg_s0.mp4"]) == len(kept["agg_s1.mp4"]) == 8
    m = json.loads((tmp_path / "mm.json").read_text())
    assert JAX_KEYS <= set(m)
    assert m["streams"] == 2 and m["frames_total"] == 16
    assert m["aggregate_fps"] > 0 and m["mesh"] == {"stream": 1, "space": 1}
    assert m["device"] == "cpu"
