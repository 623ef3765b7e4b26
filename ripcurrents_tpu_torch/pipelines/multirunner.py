"""Multi-stream runner: N video/camera streams on one card (port of
``ripcurrents_tpu/pipelines/multirunner.py``).

The deployment surface for several cameras per host: each input video
gets its own decode thread and chunk source (``runner._open_source``:
the frame pump where ``run_video`` uses it), its own pinned upload one
chunk ahead (``runner._device_prefetch``) and its own mode state on the
process's card. ``runner._run_chunks``, the chunk pipeline ``run_video``
runs with one stream, calls the single-stream ``step`` for each stream
in turn every lock-step frame, so each stream's outputs are those of
``run_video`` on its clip, bit for bit. JAX on one chip also runs
streams one after another (``farneback_stream_multi``, the sequential
LK batch); its vmapped form exists to spread streams over chips. Here
the mesh is over processes, one card each: several processes are a
stream farm (``parallel/distributed.py``), each running its own videos.

Streams advance in lock-step chunks and processing stops when the
shortest stream ends (the reference is strictly single-video, its
per-frame loop RipCurrents_main/main.cpp:484-517; on a live rig every
stream is endless, so lock-step is the natural schedule). One overlay
video per stream is written; `metrics_json` records the AGGREGATE
frames/sec across all streams.

First frames: each stream's mode init takes its raw first frame on the
device, as ``run_video`` does (the reference preloads with INTER_AREA).
JAX's runner resizes first frames on the host with cv2 INTER_AREA only
to stack them for vmap; a loop of per-stream states has nothing to
stack.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Optional, Sequence

import torch

from ripcurrents_tpu_torch import resolve_device
from ripcurrents_tpu_torch.io import video as io_video
from ripcurrents_tpu_torch.parallel.mesh import Mesh
from ripcurrents_tpu_torch.pipelines import runner
from ripcurrents_tpu_torch.pipelines.common import MODES, ModeConfig
from ripcurrents_tpu_torch.pipelines.runner import RunStats


def _stream_mesh(n_streams: int, space: int = 1, world: int = 1,
                 ydim: Optional[int] = None) -> Mesh:
    """('stream', 'space') mesh: the stream axis is the largest divisor of
    n_streams that fits `world` devices (streams divide evenly so every
    device carries the same number), rows over an optional 'space'
    factor. Raises ValueError naming --mesh-space when `space` exceeds
    the devices or does not divide the frame height `ydim`."""
    if space < 1 or space > world:
        raise ValueError(
            f"--mesh-space {space} needs 1 <= K <= the {world} device(s) "
            f"the streams run on (one card per process; row-sharding a "
            f"whole mode step over several cards is not ported)")
    if ydim is not None and ydim % space:
        raise ValueError(f"--mesh-space {space} does not divide the frame "
                         f"height {ydim}")
    budget = max(world // space, 1)
    ns = max(d for d in range(1, min(budget, n_streams) + 1)
             if n_streams % d == 0)
    return Mesh(ns, space)


def run_videos(mode: str, videos: Sequence[str],
               output_stem: Optional[str],
               cfg: Optional[ModeConfig] = None, chunk: int = 8,
               max_frames: Optional[int] = None,
               space: int = 1,
               metrics_json: Optional[str] = None,
               progress: bool = True,
               host_prep: bool = True,
               device=None) -> RunStats:
    """Process N videos through `mode` in lock-step on this process's
    card.

    Writes one overlay video per stream (`<output_stem>_s<i>.mp4`; None
    skips encoding and downloads nothing) and returns aggregate RunStats
    (frames = scanned frames across streams; state = the streams' last
    states). device=None means the CUDA card and raises when there is
    none; pass "cpu" for the plain PyTorch versions. `space` > 1 would
    shard frame rows over several cards: refused (ValueError)."""
    if len(videos) < 1:
        raise ValueError("run_videos needs at least one input video")
    if mode not in MODES:
        raise KeyError(f"unknown mode {mode!r}; available: {sorted(MODES)}")
    from ripcurrents_tpu_torch.utils.profiling import StageTimer
    if cfg is None:
        cfg = ModeConfig()
    n = len(videos)
    mesh = _stream_mesh(n, space, world=1, ydim=cfg.ydim)
    dev = resolve_device("cuda" if device is None else device)
    cuda = dev.type == "cuda"
    stats = RunStats()
    timer = StageTimer()
    writers = [None] * n
    with contextlib.ExitStack() as stack:
        stack.callback(lambda: [w.close() for w in writers if w])
        readers = []
        for v in videos:
            readers.append(io_video.VideoReader(v))
            stack.callback(readers[-1].close)
        if cfg.total_frames <= 0:
            cfg = dataclasses.replace(cfg, total_frames=max(
                max(r.frame_count for r in readers), 1))
        init_fn, step = MODES[mode](cfg, device=dev)
        states, feeds, pumps, grays = [], [], [], []
        for video, reader in zip(videos, readers):
            it = iter(reader)
            try:
                first = next(it)
            except StopIteration:
                raise RuntimeError("empty input video")
            states.append(init_fn(first))
            source, pump, gray_in = runner._open_source(
                mode, it, first, cfg, video, chunk, max_frames, 1,
                host_prep)
            # closed before this stream's reader (LIFO): it stops the
            # producer thread and the pump first
            stack.callback(source.close)
            feeds.append(runner._device_prefetch(source, timer, dev))
            pumps.append(pump)
            grays.append(gray_in)

        def on_chunk(hosts, _, t):
            with timer.stage("encode"):
                for i, host in enumerate(hosts or ()):
                    if writers[i] is None:
                        writers[i] = io_video.VideoWriter(
                            f"{output_stem}_s{i}.mp4", readers[i].fps,
                            host.shape[1:3])
                    writers[i].write_batch(host)
            stats.frames += t * n
            if progress:
                print(f"frames processed: {stats.frames} "
                      f"({t} x {n} streams)", flush=True)

        t0 = time.perf_counter()
        states = runner._run_chunks(feeds, states, step, dev, timer,
                                    output_stem is not None, on_chunk)
        stats.seconds = time.perf_counter() - t0
    stats.state = states
    if progress:
        print(timer.report())
        print(f"{stats.frames} frames across {n} streams in "
              f"{stats.seconds:.2f}s (aggregate {stats.fps:.1f} fps)",
              flush=True)
    if metrics_json:
        with open(metrics_json, "w") as f:
            json.dump({
                "mode": mode, "streams": n,
                "frames_total": stats.frames,
                "seconds": round(stats.seconds, 4),
                "aggregate_fps": round(stats.fps, 3),
                "per_stream_fps": round(stats.fps / n, 3),
                "resolution": [cfg.ydim, cfg.xdim],
                "gray_upload": all(grays),
                "native_host_prep": all(p is not None for p in pumps),
                "stages_s": {k: round(v, 4)
                             for k, v in sorted(timer.totals.items())},
                "mesh": mesh.shape,
                "device": (torch.cuda.get_device_name(dev) if cuda
                           else str(dev)),
            }, f)
            f.write("\n")
    return stats
