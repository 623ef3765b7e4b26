"""Stream runner: drives a registered mode's step over frames (port of
``ripcurrents_tpu/pipelines/runner.py``).

``run_frames`` takes any iterable of (H, W, 3) uint8 BGR arrays or
tensors; each is uploaded, stepped, and its output frame yielded as a
tensor on the device. ``run_video`` takes a video file or camera and
pipelines the host and the card:

- decode (+ the native frame pump's resize and gray, ``io/native.py``)
  runs on a producer thread, feeding fixed-size chunks through a bounded
  queue;
- each chunk is copied into pinned host memory and uploaded on a side
  CUDA stream one chunk ahead of the steps that read it;
- the steps are PyTorch's eager launches, one frame at a time (the loop
  of ``run_frames``). Most steps only launch device work, so the host
  runs ahead of the card; ``stabilizeTPU``'s step waits on the card (6
  times a Harris frame: its upload, its frame count, its SVDs) and the
  steps that bin a histogram with ``torch.bincount`` (legacy, android)
  twice a frame, so their chunks do not run ahead;
- the previous chunk's outputs are stacked on the device and copied into
  pinned memory once the current chunk's steps are issued, then handed to
  the writer thread, which encodes. With no writer and no preview
  nothing is downloaded: the runner waits on an event of each chunk's
  last output instead.

``ModeConfig.total_frames`` (the reference's CAP_PROP_FRAME_COUNT) left
at 0 is taken from the source's length, at least 1, as the JAX runner
takes it from the video. The modes that shade their trails by it raise
on a source without a length unless the config gives the count.

With the frame pump (built from ``native/framepump.cpp`` at first use),
steady-state frames are resized on host worker threads before upload:
the mode's device INTER_LINEAR resize is then an identity at the target
size. The pump's fixed-point resize and the device float resize are each
within +-1 LSB of cv2.resize and may differ from each other by 1 at a few
pixels, which chaotic trackers can amplify over long clips: pass
host_prep=False for bit-stable comparisons with the device path. First
frames keep the raw path because the reference preloads with INTER_AREA
(main.cpp:125).
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ripcurrents_tpu_torch import resolve_device
from ripcurrents_tpu_torch.io import native as io_native
from ripcurrents_tpu_torch.io import video as io_video
from ripcurrents_tpu_torch.ops.image import band_source_rows
from ripcurrents_tpu_torch.pipelines.common import (GRAY_INPUT, MODES,
                                                    ModeConfig)
# mode registration side effects
from ripcurrents_tpu_torch.pipelines import android as _android  # noqa: F401
from ripcurrents_tpu_torch.pipelines import legacy as _legacy  # noqa: F401
from ripcurrents_tpu_torch.pipelines import modes as _modes  # noqa: F401


@dataclasses.dataclass
class RunStats:
    frames: int = 0
    seconds: float = 0.0
    state: object = None     # the mode's state after the last frame

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0


def run_frames(mode: str, frames: Iterable, cfg: ModeConfig = ModeConfig(),
               device=None,
               stats: Optional[RunStats] = None) -> Iterator[torch.Tensor]:
    """Run `mode` over `frames`; yields one (ydim, xdim, 3) uint8 output
    frame per input frame after the first (which only seeds the state).

    device=None means the CUDA card and raises when there is none; pass
    "cpu" for the plain PyTorch versions. `stats`, when given, is filled
    when the iterator ends or is closed: frames stepped, the mode's last
    state, and seconds from the first step to the device finishing the
    last one (the clock is read after a device synchronize).

    cfg.total_frames <= 0 takes max(len(frames), 1) where `frames` has a
    length; else it stays 0, and the modes that shade their trails by it
    raise ValueError at their first step."""
    dev = resolve_device("cuda" if device is None else device)
    if mode not in MODES:
        raise KeyError(f"unknown mode {mode!r}; ported: {sorted(MODES)}")
    if cfg.total_frames <= 0 and hasattr(frames, "__len__"):
        cfg = dataclasses.replace(cfg, total_frames=max(len(frames), 1))
    it = iter(frames)
    try:
        first = next(it)
    except StopIteration:
        return
    init, step = MODES[mode](cfg, device=dev)
    state = init(first)
    t0 = time.perf_counter()
    done = 0
    try:
        for raw in it:
            state, out = step(state, raw)
            done += 1
            yield out
    finally:
        if stats is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            stats.frames = done
            stats.state = state
            stats.seconds = time.perf_counter() - t0


def bgr_to_gray_host(frames: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(COLOR_BGR2GRAY)'s fixed point on the host, in numpy:
    (..., 3) uint8 BGR -> (...) uint8, (B*1868 + G*9617 + R*4899 + 2^13)
    >> 14, as ``ops/image.py: bgr_to_gray`` on the device."""
    f = frames.astype(np.int32)
    return ((f[..., 0] * 1868 + f[..., 1] * 9617 + f[..., 2] * 4899 +
             (1 << 13)) >> 14).astype(np.uint8)


def _have_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def _chunk_source(frames_iter, chunk: int, frame_skip: int,
                  max_frames: Optional[int], pump, prefetch: int = 3,
                  gray_hw: "Optional[tuple]" = None,
                  crop: "Optional[tuple]" = None):
    """Decode (and optionally host-prep) frames on a producer thread,
    yielding (T<=chunk, H, W, 3) uint8 stacks, or (T<=chunk, H, W) gray
    stacks for gray-input modes (`gray_hw` = target (ydim, xdim)): resize
    (cv2 INTER_LINEAR, only where the frame is not at the target size) +
    BGR2GRAY run on the host (the reference's ops and order,
    main.cpp:493-494), cutting upload bytes 3x. `crop` = (a, b) keeps
    only decoded rows [a, b) (a row band's source rows). Closing the
    generator stops the producer and the pump."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def to_gray(f):
        if f.shape[:2] != gray_hw:
            import cv2
            f = cv2.resize(f, (gray_hw[1], gray_hw[0]),
                           interpolation=cv2.INTER_LINEAR)
        return bgr_to_gray_host(f)

    def produce():
        try:
            n = 0
            skip = 0
            buf = []
            for f in frames_iter:
                if stop.is_set():
                    return
                skip += 1
                if skip % frame_skip:  # android-style decode subsampling
                    continue
                if crop is not None:
                    f = f[crop[0]:crop[1]]
                if pump is not None:
                    pump.push(f)
                else:
                    buf.append(to_gray(f) if gray_hw is not None else f)
                    if len(buf) == chunk:
                        put(np.stack(buf))
                        buf = []
                n += 1
                if max_frames and n >= max_frames:
                    break
            if pump is not None:
                pump.close()
            else:
                if buf:
                    put(np.stack(buf))
                put(None)
        except Exception as e:  # surface decode errors to the consumer
            if pump is not None:
                pump.close()
            put(e)

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    try:
        if pump is not None:
            while True:
                resized, gray = pump.pop_batch(chunk)
                if len(resized) == 0:
                    # the producer closed the pump: at its end, or just
                    # before reporting an error
                    producer.join()
                    if not q.empty():
                        raise q.get_nowait()
                    return
                yield gray if gray_hw is not None else resized
        else:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
    finally:
        stop.set()
        if pump is not None:
            pump.close()
        producer.join()


def _device_prefetch(gen, timer, device: torch.device, depth: int = 1):
    """Upload chunks to the device one ahead of consumption. Yields
    (device chunk, upload event or None, pinned host chunk or None).

    On a card each chunk is copied into pinned host memory and uploaded
    with a non-blocking copy on a side stream (a copy from pageable
    memory would be synchronous), so chunk i+1's transfer overlaps chunk
    i's steps. The consumer makes its stream wait on the event before
    the chunk's first step and holds the pinned chunk until its steps
    are done. The 'upload' timer stage records the staging copy and the
    issue only."""
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    buf = []
    for item in gen:
        with timer.stage("upload"):
            if side is None:
                buf.append((torch.from_numpy(item), None, None))
            else:
                host = torch.empty(item.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(torch.from_numpy(item))
                with torch.cuda.stream(side):
                    dev = host.to(device, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(side)
                buf.append((dev, done, host))
        if len(buf) > depth:
            yield buf.pop(0)
    yield from buf


def _band_pump_rows(raw_h: int, ydim: int, rows) -> "Optional[tuple]":
    """Source rows [a, b) whose resize to rows[1] - rows[0] rows equals
    rows [i0, i1) of the whole raw_h -> ydim resize, or None: a
    downscale whose band edges fall on source rows (i * raw_h / ydim
    whole), so the band's source-to-output map is the frame's shifted by
    a whole number of rows."""
    i0, i1 = rows
    if raw_h < ydim or (i0 * raw_h) % ydim or (i1 * raw_h) % ydim:
        return None
    return i0 * raw_h // ydim, i1 * raw_h // ydim


def _open_source(mode: str, frames_iter, first: np.ndarray, cfg: ModeConfig,
                 video_in: str, chunk: int, max_frames: Optional[int],
                 frame_skip: int, host_prep: bool,
                 rows: "Optional[tuple]" = None):
    """One stream's chunk source (``_chunk_source``) after its first
    frame: the frame pump when `host_prep` and the source is a file not
    at the target size (and the pump builds); gray chunks for gray-input
    modes where the host can make them (the pump's, frames at the target
    size, or cv2 resizing others; else the mode's own device prep does it
    from BGR). -> (source, pump or None, gray_in, src).

    rows=(i0, i1), a space step's band: the source yields only what the
    band needs, and `src` = (a0, src_h) places it for the step
    (``prep_frame``): the pump's band when the band's source rows resize
    to it exactly (``_band_pump_rows``; src = (i0, ydim)), else the
    source rows the device resize reads (src = (a, raw_h)). None
    without rows."""
    target = (cfg.ydim, cfg.xdim)
    pump = crop = src = None
    want_pump = host_prep and video_in != "-" and \
        first.shape[:2] != target and io_native.available()
    if rows is not None:
        raw_h = first.shape[0]
        pumped = _band_pump_rows(raw_h, cfg.ydim, rows) if want_pump \
            else None
        if pumped is not None:
            crop, src = pumped, (rows[0], cfg.ydim)
            pump = io_native.FramePump(
                (pumped[1] - pumped[0], first.shape[1]),
                (rows[1] - rows[0], cfg.xdim), threads=2,
                capacity=4 * chunk)
        else:
            crop = band_source_rows(raw_h, cfg.ydim, tuple(rows))
            src = (crop[0], raw_h)
    elif want_pump:
        pump = io_native.FramePump(first.shape[:2], target, threads=2,
                                   capacity=4 * chunk)
    gray_in = rows is None and mode in GRAY_INPUT and (
        pump is not None or first.shape[:2] == target or _have_cv2())
    source = _chunk_source(frames_iter, chunk, frame_skip, max_frames,
                           pump, gray_hw=target if gray_in else None,
                           crop=crop)
    return source, pump, gray_in, src


def _download(outs: list, ready, side) -> "tuple[np.ndarray, object]":
    """Stack a chunk's output frames on the device and copy them into
    pinned host memory, on the `side` stream after the `ready` event
    (a card), or directly (the CPU). -> (host frames, event to wait on or
    None)."""
    if side is None:
        return torch.stack(outs).numpy(), None
    side.wait_event(ready)
    with torch.cuda.stream(side):
        stacked = torch.stack(outs)
        host = torch.empty(stacked.shape, dtype=stacked.dtype,
                           pin_memory=True)
        host.copy_(stacked, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    return host.numpy(), done


def _run_chunks(feeds: list, states: list, steps: list,
                device: torch.device, timer, need_frames: bool,
                on_chunk) -> list:
    """The chunk pipeline of ``run_video`` (one stream) and ``run_videos``
    (N streams): steps the streams' uploaded chunks (one
    ``_device_prefetch`` feed and one step function each) in lock-step,
    each stream's frame k before any stream's frame k + 1, and calls
    on_chunk(hosts, states, t)
    for each chunk once the card is done with it: hosts = each stream's
    (t, ...) output frames in host memory (downloaded on a side stream),
    or None when not `need_frames` (nothing is downloaded); states = the
    streams' states after the chunk. A chunk's download and on_chunk
    overlap the device's work on the next chunk. Stops when a feed ends;
    a chunk shorter than another stream's (that stream is ending) is the
    last. -> the streams' last states, after the card has finished."""
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def flush(outs, ready, chunk_states):
        hosts = None
        with timer.stage("materialize"):
            if need_frames:
                got = [_download(o, ready, side) for o in outs]
                for _, done in got:
                    if done is not None:
                        done.synchronize()
                hosts = [host for host, _ in got]
            elif ready is not None:
                ready.synchronize()
        on_chunk(hosts, chunk_states, len(outs[0]))

    states = list(states)
    pending = None
    while True:
        chunks = [next(feed, None) for feed in feeds]
        if any(c is None for c in chunks):
            break
        t = min(c[0].shape[0] for c in chunks)
        with timer.stage("dispatch"):
            ready = None
            if cuda:
                cur = torch.cuda.current_stream(device)
                for frames, uploaded, _ in chunks:
                    cur.wait_event(uploaded)
                    # the chunk was allocated on the side stream
                    frames.record_stream(cur)
            outs = [[] for _ in chunks]
            for k in range(t):
                for i, (frames, _, _) in enumerate(chunks):
                    states[i], out = steps[i](states[i], frames[k])
                    outs[i].append(out)
            if cuda:
                ready = torch.cuda.Event()
                ready.record()
        if pending is not None:
            flush(*pending[:3])  # overlaps the device's work on this chunk
        # The pinned uploads (the chunks' third items) live in `pending`
        # until flush has waited on `ready`, which follows their copies.
        pending = (outs, ready, list(states), chunks)
        if any(c[0].shape[0] > t for c in chunks):
            break                # a stream is ending
    if pending is not None:
        flush(*pending[:3])
    if cuda:
        torch.cuda.synchronize(device)
    return states


def run_video(mode: str, video_in: str, video_out: Optional[str],
              cfg: Optional[ModeConfig] = None, chunk: int = 8,
              max_frames: Optional[int] = None,
              frame_skip: int = 1,
              host_prep: bool = True,
              checkpoint_every: Optional[int] = None,
              checkpoint_path: Optional[str] = None,
              resume: Optional[str] = None,
              metrics_json: Optional[str] = None,
              preview: bool = False,
              progress: bool = True,
              device=None) -> RunStats:
    """Process a video through `mode`, optionally writing the overlay video.

    device=None means the CUDA card and raises when there is none; pass
    "cpu" for the plain PyTorch versions. checkpoint_every=N saves the
    mode's state + frame offset to checkpoint_path every >=N processed
    frames (the state after the chunk just written); resume=path restores
    it and skips the already-processed frames, so a killed stream run
    continues where it stopped (the reference loses all temporal state
    on exit, SURVEY.md section 5)."""
    from ripcurrents_tpu_torch.utils.checkpoint import (load_meta,
                                                        load_state,
                                                        save_state)
    from ripcurrents_tpu_torch.utils.profiling import StageTimer
    dev = resolve_device("cuda" if device is None else device)
    reader = io_video.VideoReader(video_in)
    if cfg is None:
        cfg = ModeConfig()
    if cfg.total_frames <= 0:
        cfg = dataclasses.replace(cfg, total_frames=max(reader.frame_count, 1))
    if mode not in MODES:
        raise KeyError(f"unknown mode {mode!r}; available: {sorted(MODES)}")
    init_fn, step = MODES[mode](cfg, device=dev)
    writer = None
    stats = RunStats()
    timer = StageTimer()
    frames_iter = iter(reader)
    # Preload first frame raw to initialize state (reference preloads with
    # INTER_AREA, main.cpp:476-480: done on the device by the mode's init).
    try:
        first = next(frames_iter)
    except StopIteration:
        raise RuntimeError("empty input video")
    state = init_fn(first)

    frames_done = 0
    if resume:
        meta = load_meta(resume)
        state = load_state(resume, like=state)
        frames_done = int(meta.get("processed", 0))
        # Reproduce the producer's raw-frame alignment: each processed
        # frame consumed frame_skip raw frames.
        for _ in range(frames_done * frame_skip):
            try:
                next(frames_iter)
            except StopIteration:
                break
        if max_frames is not None:
            max_frames = max(max_frames - frames_done, 0)
        if progress:
            print(f"resumed at frame {frames_done} from {resume}",
                  flush=True)

    source, pump, gray_in, _ = _open_source(mode, frames_iter, first, cfg,
                                            video_in, chunk, max_frames,
                                            frame_skip, host_prep)
    last_ckpt = 0
    # cv2.imshow on a displayless host aborts the process inside Qt (not a
    # catchable Python exception), so gate on $DISPLAY up front.
    _preview_ok = bool(os.environ.get("DISPLAY") or
                       os.environ.get("WAYLAND_DISPLAY"))
    if preview and not _preview_ok and progress:
        print("preview disabled: no display", flush=True)
    # With no writer and no preview nobody consumes the rendered frames:
    # skip the download and wait on an event of each chunk's last output.
    need_frames = bool(video_out) or (preview and _preview_ok)
    cuda = dev.type == "cuda"

    def on_chunk(hosts, chunk_states, t):
        nonlocal last_ckpt, writer
        with timer.stage("encode"):
            if video_out:
                if writer is None:
                    writer = io_video.VideoWriter(video_out, reader.fps,
                                                  hosts[0].shape[1:3])
                writer.write_batch(hosts[0])
        if preview and _preview_ok:
            # the reference's imshow windows (e.g. main.cpp:502); shows the
            # last frame of each chunk to keep up with device rate
            import cv2
            cv2.imshow(mode, hosts[0][-1])
            cv2.waitKey(1)
        stats.frames += t
        if (checkpoint_every and checkpoint_path and
                stats.frames - last_ckpt >= checkpoint_every):
            save_state(checkpoint_path, chunk_states[0],
                       {"processed": frames_done + stats.frames,
                        "mode": mode})
            last_ckpt = stats.frames
        if progress:
            print(f"frames processed: {stats.frames}", flush=True)

    t0 = time.perf_counter()
    try:
        state, = _run_chunks([_device_prefetch(source, timer, dev)],
                             [state], [step], dev, timer, need_frames,
                             on_chunk)
    finally:
        source.close()      # stops the producer before the reader goes
        reader.close()
    stats.seconds = time.perf_counter() - t0
    stats.state = state
    if writer:
        writer.close()
    if progress:
        print(timer.report())
        print(f"{stats.frames} frames in {stats.seconds:.2f}s "
              f"({stats.fps:.1f} fps)"
              + (" [native host prep]" if pump is not None else ""))
    if metrics_json:
        # Per-run structured metrics (SURVEY.md section 5: per-run JSON).
        with open(metrics_json, "w") as f:
            json.dump({
                "mode": mode, "frames": stats.frames,
                "seconds": round(stats.seconds, 4),
                "fps": round(stats.fps, 3),
                "resolution": [cfg.ydim, cfg.xdim],
                "native_host_prep": pump is not None,
                "gray_upload": gray_in,
                "output_download": need_frames,
                "stages_s": {k: round(v, 4)
                             for k, v in sorted(timer.totals.items())},
                "device": (torch.cuda.get_device_name(dev) if cuda
                           else str(dev)),
            }, f)
            f.write("\n")
    return stats
