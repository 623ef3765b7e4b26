"""Host video I/O rim: decode, batch, encode.

The equivalent of the reference's VideoCapture/VideoWriter loops
(main.cpp:63-96 etc.): the host decodes frames (on a background thread in
``batched_frames`` and in the runner) while the device steps the previous
chunk, and encoded output is written from a writer thread. Decode and
encode use OpenCV. Importing this module needs no OpenCV: the reader and
writer raise when they are constructed without it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


class VideoReader:
    """Iterates BGR uint8 frames from a video file or camera index."""

    def __init__(self, path: str):
        if not _HAS_CV2:
            raise RuntimeError(
                "No video decode backend available (cv2 missing)")
        # '-' selects the webcam, as the legacy CLI does (ripcurrents.cpp:62).
        self.cap = cv2.VideoCapture(0 if path == "-" else path)
        if not self.cap.isOpened():
            raise FileNotFoundError(f"Input video could not be opened: {path}")

    @property
    def fps(self) -> float:
        return float(self.cap.get(cv2.CAP_PROP_FPS) or 30.0)

    @property
    def frame_count(self) -> int:
        return int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)

    @property
    def size(self) -> tuple[int, int]:
        return (int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)))

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            ok, frame = self.cap.read()
            if not ok:
                return
            yield frame

    def close(self):
        self.cap.release()


class VideoWriter:
    """Writes BGR uint8 frames; encodes on a background thread."""

    def __init__(self, path: str, fps: float, size_hw: tuple[int, int],
                 fourcc: str | None = None):
        if not _HAS_CV2:
            raise RuntimeError("No video encode backend available")
        if fourcc is None:
            # .avi -> MJPG (intra-only: every frame encodes independently,
            # which kill-and-resume comparisons rely on); otherwise mp4v.
            fourcc = "MJPG" if path.lower().endswith(".avi") else "mp4v"
        h, w = size_hw
        self.writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h), True)
        if not self.writer.isOpened():
            raise RuntimeError(f"Output video could not be opened: {path}")
        self._q: queue.Queue = queue.Queue(maxsize=64)
        self._error: "Exception | None" = None
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        # A failing encode must not kill this thread silently: write()
        # would then deadlock once the bounded queue fills. Record the
        # error, keep draining (discarding), and re-raise in write/close.
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._error is None:
                try:
                    self.writer.write(item)
                except Exception as e:
                    self._error = e

    def _check(self):
        if self._error is not None:
            raise RuntimeError("video encode failed") from self._error

    def write(self, frame: np.ndarray):
        self._check()
        self._q.put(np.ascontiguousarray(frame))

    def write_batch(self, frames: np.ndarray):
        for f in np.asarray(frames):
            self.write(f)

    def close(self):
        self._q.put(None)
        self._thread.join()
        self.writer.release()
        self._check()


def batched_frames(reader: VideoReader, batch: int,
                   prefetch: int = 2) -> Iterator[np.ndarray]:
    """Yield (T<=batch, H, W, 3) uint8 stacks, decoded on a worker thread so
    decode overlaps device work."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)

    def produce():
        # Any decode/stack failure must reach the consumer: a producer
        # thread dying without a sentinel leaves q.get() blocked forever
        # (e.g. a mid-stream frame-shape change failing np.stack).
        try:
            chunk = []
            for frame in reader:
                chunk.append(frame)
                if len(chunk) == batch:
                    q.put(np.stack(chunk))
                    chunk = []
            if chunk:
                q.put(np.stack(chunk))
            q.put(None)
        except Exception as e:
            q.put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is None:
            return
        if isinstance(item, Exception):
            raise item
        yield item
