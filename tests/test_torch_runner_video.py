"""The port's video runner (``pipelines/runner.py: run_video``), its host
I/O (``io/video.py``) and its frame pump binding (``io/native.py``) on
the CPU, against the JAX package's runner and OpenCV.

Tolerances, as measured:

- ``run_video`` against JAX ``run_video`` (``timex``, a clip already at
  the working size, chunk 3, frame_skip 3, max_frames 4): the same frame
  count and equal frames (timex is the same operations in the same order
  on both sides), the same metrics keys and equal counts and flags;
- the gray upload against the BGR upload: equal frames; the host's
  BGR2GRAY equals the device ``bgr_to_gray`` bit for bit and
  ``cv2.cvtColor`` within one level (OpenCV 5.0 rounds ~0.3% of random
  pixels the other way; the reference's fixed point is the port's);
- the frame pump against ``cv2.resize`` and ``cv2.cvtColor`` of its own
  resized frames: within one level.
"""

import json

import cv2
import numpy as np
import pytest
import torch

from ripcurrents_tpu.pipelines import runner as jrunner
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch.io import native
from ripcurrents_tpu_torch.io import video as vio
from ripcurrents_tpu_torch.ops.image import bgr_to_gray
from ripcurrents_tpu_torch.pipelines import runner
from ripcurrents_tpu_torch.pipelines.common import GRAY_INPUT, ModeConfig

torch.set_num_threads(1)

H, W = 48, 64


def write_clip(path, frames, fourcc="mp4v"):
    h, w = frames[0].shape[:2]
    wtr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 30,
                          (w, h))
    for f in frames:
        wtr.write(f)
    wtr.release()
    return str(path)


def wave_frames(rng, t, h=H, w=W):
    yy = np.mgrid[0:h, 0:w][0].astype(np.float32)
    base = rng.uniform(0, 255, (h, w)).astype(np.float32)
    out = []
    for k in range(t):
        wave = 60 * np.sin(2 * np.pi * (yy / 12.0 - k * 0.2))
        g = np.clip(base * 0.5 + wave + 60, 0, 255)
        out.append(np.stack([g * 0.9, g, np.clip(g * 1.1, 0, 255)],
                            -1).astype(np.uint8))
    return out


class Capture:
    """A VideoWriter stand-in that keeps what is written, by path."""
    written: dict = {}

    def __init__(self, path, fps, size_hw, fourcc=None):
        self.frames = Capture.written[path] = []

    def write(self, frame):
        self.frames.append(np.array(frame))

    def write_batch(self, frames):
        for f in frames:
            self.write(f)

    def close(self):
        pass


@pytest.fixture()
def capture(monkeypatch):
    Capture.written = {}
    monkeypatch.setattr(vio, "VideoWriter", Capture)
    monkeypatch.setattr(jrunner, "VideoWriter", Capture)
    return Capture.written


def test_run_video_matches_jax(tmp_path, rng, capture):
    """timex through both runners with chunk 3, frame_skip 3 (android's
    decode subsampling) and max_frames 4 on a 16-frame clip: 15 raw
    frames after the seed frame give 5, cut to 4 (chunks of 3 and 1)."""
    clip = write_clip(tmp_path / "clip.mp4", wave_frames(rng, 16))
    kw = dict(chunk=3, max_frames=4, frame_skip=3, progress=False)
    jm, tm = tmp_path / "jax.json", tmp_path / "port.json"
    jstats = jrunner.run_video("timex", clip, "jax.mp4",
                               JaxModeConfig(xdim=W, ydim=H),
                               metrics_json=str(jm), **kw)
    stats = runner.run_video("timex", clip, "port.mp4",
                             ModeConfig(xdim=W, ydim=H),
                             metrics_json=str(tm), device="cpu", **kw)
    assert stats.frames == jstats.frames == 4
    want, got = np.stack(capture["jax.mp4"]), np.stack(capture["port.mp4"])
    assert got.shape == want.shape == (4, H, W, 3)
    np.testing.assert_array_equal(got, want)
    j, t = json.loads(jm.read_text()), json.loads(tm.read_text())
    assert set(t) == set(j)
    assert set(t["stages_s"]) == set(j["stages_s"]) == {
        "upload", "dispatch", "materialize", "encode"}
    for k in ("mode", "frames", "resolution", "native_host_prep",
              "gray_upload", "output_download"):
        assert t[k] == j[k], k
    assert t["device"] == "cpu"


def test_gray_upload_matches_bgr_upload(tmp_path, rng, capture,
                                        monkeypatch):
    """A gray-input mode fed host-gray frames writes the frames of the
    BGR upload (device resize + bgr_to_gray), from a clip at the working
    size; the host BGR2GRAY against the device's and cv2's."""
    mode = "subtructAverageVector"
    assert mode in GRAY_INPUT
    clip = write_clip(tmp_path / "clip.mp4", wave_frames(rng, 6))
    cfg = ModeConfig(xdim=W, ydim=H)
    mg, mb = tmp_path / "g.json", tmp_path / "b.json"
    runner.run_video(mode, clip, "gray.mp4", cfg, chunk=3, progress=False,
                     metrics_json=str(mg), device="cpu")
    monkeypatch.setattr(runner, "GRAY_INPUT", frozenset())
    runner.run_video(mode, clip, "bgr.mp4", cfg, chunk=3, progress=False,
                     metrics_json=str(mb), device="cpu")
    assert json.loads(mg.read_text())["gray_upload"] is True
    assert json.loads(mb.read_text())["gray_upload"] is False
    a, b = np.stack(capture["gray.mp4"]), np.stack(capture["bgr.mp4"])
    assert a.shape == (5, H, W, 3)
    np.testing.assert_array_equal(a, b)

    frames = rng.integers(0, 256, (4, 37, 53, 3), dtype=np.uint8)
    host = runner.bgr_to_gray_host(frames)
    np.testing.assert_array_equal(host,
                                  bgr_to_gray(torch.from_numpy(frames)).numpy())
    ref = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in frames])
    assert np.abs(host.astype(int) - ref).max() <= 1


def test_no_output_no_download_and_webcam(tmp_path, rng, capture,
                                          monkeypatch):
    """With no writer the runner downloads nothing (``_download`` is never
    called); ``-`` opens camera 0 through cv2.VideoCapture (a fake serving
    4 frames) and runs the same path as a file."""
    clip = write_clip(tmp_path / "clip.mp4", wave_frames(rng, 8))
    metrics = tmp_path / "m.json"

    def no_download(*a):
        raise AssertionError("downloaded without an output")

    with monkeypatch.context() as m:
        m.setattr(runner, "_download", no_download)
        stats = runner.run_video("timelines", clip, None,
                                 ModeConfig(xdim=W, ydim=H), chunk=3,
                                 metrics_json=str(metrics), progress=False,
                                 device="cpu")
    assert stats.frames == 7 == json.loads(metrics.read_text())["frames"]
    assert json.loads(metrics.read_text())["output_download"] is False

    opened = {}

    class FakeCap:
        def __init__(self, src):
            opened["src"] = src
            self.n = 0

        def isOpened(self):
            return True

        def get(self, prop):
            return {cv2.CAP_PROP_FPS: 30.0,
                    cv2.CAP_PROP_FRAME_COUNT: 0.0,
                    cv2.CAP_PROP_FRAME_HEIGHT: float(H),
                    cv2.CAP_PROP_FRAME_WIDTH: float(W)}.get(prop, 0.0)

        def read(self):
            if self.n >= 4:
                return False, None
            self.n += 1
            return True, np.random.default_rng(self.n).integers(
                0, 255, (H, W, 3), dtype=np.uint8)

        def release(self):
            pass

    monkeypatch.setattr(vio.cv2, "VideoCapture", FakeCap)
    stats = runner.run_video("timelines", "-", "cam.mp4",
                             ModeConfig(xdim=W, ydim=H), chunk=2,
                             progress=False, device="cpu")
    assert opened["src"] == 0          # webcam device index, not a path
    assert stats.frames == 3           # 4 camera frames, first is preload
    assert len(capture["cam.mp4"]) == 3


def test_frame_pump_and_video_io(tmp_path, rng):
    """The pump built from native/framepump.cpp on this host against
    cv2.resize / cv2.cvtColor within one level; reader, batched_frames and
    writer round trips (mp4v, and MJPG for .avi)."""
    assert native.available()
    frames = rng.integers(0, 255, (6, 120, 160, 3)).astype(np.uint8)
    pump = native.FramePump((120, 160), (H, W), threads=2)
    with pytest.raises(ValueError):
        pump.push(frames[0][:-1])
    for f in frames:
        pump.push(f)
    pump.close()
    resized, gray = pump.pop_batch(8)
    assert resized.shape == (6, H, W, 3) and gray.shape == (6, H, W)
    for i, f in enumerate(frames):
        want = cv2.resize(f, (W, H), interpolation=cv2.INTER_LINEAR)
        assert np.abs(resized[i].astype(int) - want.astype(int)).max() <= 1
        want_g = cv2.cvtColor(resized[i], cv2.COLOR_BGR2GRAY)
        assert np.abs(gray[i].astype(int) - want_g.astype(int)).max() <= 1

    clip = write_clip(tmp_path / "clip.mp4",
                      rng.integers(0, 255, (10, H, W, 3)).astype(np.uint8))
    reader = vio.VideoReader(clip)
    assert (reader.frame_count, reader.size) == (10, (H, W))
    got = list(reader)
    assert len(got) == 10 and got[0].shape == (H, W, 3)
    chunks = list(vio.batched_frames(vio.VideoReader(clip), batch=4))
    assert [c.shape[0] for c in chunks] == [4, 4, 2]
    for name in ("out.mp4", "out.avi"):
        w = vio.VideoWriter(str(tmp_path / name), 30, (H, W))
        w.write_batch(rng.integers(0, 255, (6, H, W, 3)).astype(np.uint8))
        w.close()
        assert len(list(vio.VideoReader(str(tmp_path / name)))) == 6
    with pytest.raises(FileNotFoundError):
        vio.VideoReader(str(tmp_path / "missing.mp4"))
