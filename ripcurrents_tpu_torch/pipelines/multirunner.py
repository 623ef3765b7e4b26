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

Rows over a 'space' group (`space` K > 1, the modes of
``common.SPACE_MODES``: legacy and timelines): a world of S x K
processes (the farm's flags; every process runs the same command with
the same videos) forms S 'stream' groups of K 'space' ranks
(``parallel/mesh.py``). Stream group g runs streams [g N/S, (g+1) N/S);
each rank of its 'space' group decodes them, uploads only the source
rows of its band (the pump makes the band itself where its rows resize
exactly), steps the band with the mode's space form, downloads its
output band once a chunk, and the group's first rank gathers the bands
and writes the stream's video and the metrics. The group's backend is
NCCL when each rank has a card of its own, gloo (device tensors staged
through host memory) when ranks share one (``mesh.space_backend``); the
metrics name it. Each rank runs on cuda:(rank mod the cards) unless the
device names an index.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ripcurrents_tpu_torch import resolve_device
from ripcurrents_tpu_torch.io import video as io_video
from ripcurrents_tpu_torch.parallel import mesh as pmesh
from ripcurrents_tpu_torch.parallel.distributed import local_stream_slice
from ripcurrents_tpu_torch.parallel.mesh import Mesh
from ripcurrents_tpu_torch.pipelines import legacy, runner
from ripcurrents_tpu_torch.pipelines.common import (MODES, SPACE_MODES,
                                                    ModeConfig, space_rows)
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
            f"the streams run on (one process per device: start K x S "
            f"processes with --coordinator, --num-processes and "
            f"--process-id)")
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
    (frames = scanned frames across this process's streams; state = the
    streams' last states). device=None means the CUDA card and raises
    when there is none; pass "cpu" for the plain PyTorch versions.

    `space` K > 1 splits each frame's rows over K processes (module doc):
    the process group must be initialized with S x K ranks, N divisible
    by S, and `mode` one of ``SPACE_MODES`` (else ValueError). The
    returned states hold this rank's bands; the metrics (written by the
    first rank of each 'space' group, `<stem>_g<g><ext>` when there are
    several groups) add the mesh, the backend, the halo and each rank's
    exchange seconds and bytes a frame."""
    if len(videos) < 1:
        raise ValueError("run_videos needs at least one input video")
    if mode not in MODES:
        raise KeyError(f"unknown mode {mode!r}; available: {sorted(MODES)}")
    from ripcurrents_tpu_torch.utils.profiling import StageTimer
    if cfg is None:
        cfg = ModeConfig()
    size, rank = pmesh.world()
    mesh = _stream_mesh(len(videos), space, world=size, ydim=cfg.ydim)
    dev = resolve_device("cuda" if device is None else device)
    split = space > 1
    names = list(range(len(videos)))
    if split:
        if mode not in SPACE_MODES:
            raise ValueError(f"--mesh-space {space}: mode {mode!r} has no "
                             f"space form; the modes with one are "
                             f"{sorted(SPACE_MODES)}")
        if len(videos) % (size // space):
            raise ValueError(f"--mesh-space {space}: {len(videos)} streams "
                             f"do not divide over {size // space} stream "
                             f"groups of {space} processes")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = pmesh.space_backend(dev, space)
        mesh = pmesh.make_mesh(size, space, backend)
        rows = space_rows(cfg, mesh)
        sl = local_stream_slice(mesh)
        per = len(videos) // mesh.stream
        names = names[sl.start * per:sl.stop * per]
        first_rank = mesh.coords["space"] == 0
    else:
        rows, first_rank = None, True
    cuda = dev.type == "cuda"
    n = len(names)
    stats = RunStats()
    timer = StageTimer()
    writers = [None] * n
    with contextlib.ExitStack() as stack:
        stack.callback(lambda: [w.close() for w in writers if w])
        readers = []
        for i in names:
            readers.append(io_video.VideoReader(videos[i]))
            stack.callback(readers[-1].close)
        if cfg.total_frames <= 0:
            cfg = dataclasses.replace(cfg, total_frames=max(
                max(r.frame_count for r in readers), 1))
        init_fn, step = (MODES[mode](cfg, device=dev, mesh=mesh) if split
                         else MODES[mode](cfg, device=dev))
        states, feeds, pumps, grays, steps = [], [], [], [], []
        for i, reader in zip(names, readers):
            it = iter(reader)
            try:
                first = next(it)
            except StopIteration:
                raise RuntimeError("empty input video")
            states.append(init_fn(first))
            source, pump, gray_in, src = runner._open_source(
                mode, it, first, cfg, videos[i], chunk, max_frames, 1,
                host_prep, rows)
            # closed before this stream's reader (LIFO): it stops the
            # producer thread and the pump first
            stack.callback(source.close)
            feeds.append(runner._device_prefetch(source, timer, dev))
            pumps.append(pump)
            grays.append(gray_in)
            steps.append(step if src is None else
                         (lambda s, f, src=src: step(s, f, src)))

        def on_chunk(hosts, _, t):
            with timer.stage("encode"):
                for j, host in enumerate(hosts or ()):
                    if split:
                        host = pmesh.gather_host_rows(
                            mesh, torch.from_numpy(host))
                        if host is None:
                            continue
                        host = host.numpy()
                    if writers[j] is None:
                        writers[j] = io_video.VideoWriter(
                            f"{output_stem}_s{names[j]}.mp4",
                            readers[j].fps, host.shape[1:3])
                    writers[j].write_batch(host)
            stats.frames += t * n
            if progress and first_rank:
                print(f"frames processed: {stats.frames} "
                      f"({t} x {n} streams)", flush=True)

        t0 = time.perf_counter()
        states = runner._run_chunks(feeds, states, steps, dev, timer,
                                    output_stem is not None, on_chunk)
        stats.seconds = time.perf_counter() - t0
    stats.state = states
    if progress and first_rank:
        print(timer.report())
        print(f"{stats.frames} frames across {n} streams in "
              f"{stats.seconds:.2f}s (aggregate {stats.fps:.1f} fps)",
              flush=True)
    metrics = {
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
    }
    if split:
        step_x, out_x = mesh.tally["step"], mesh.tally["output"]
        mine = {"seconds": stats.seconds,
                "ms_per_frame": stats.seconds * 1e3 / max(stats.frames, 1),
                "exchange_s": step_x["seconds"],
                "exchange_bytes_per_frame":
                    step_x["bytes"] / max(stats.frames, 1),
                "exchanges_per_frame":
                    step_x["calls"] / max(stats.frames, 1),
                "exchange_by": {k: {"s": v[0], "bytes": v[1], "calls": v[2]}
                                for k, v in step_x["by"].items()},
                "output_gather_s": out_x["seconds"]}
        ranks = [None] * space
        dist.all_gather_object(ranks, mine, group=mesh.host_group)
        metrics["space"] = {
            "backend": backend, "band_rows": rows[1] - rows[0],
            "halo": legacy.space_halo(cfg) if mode == "legacy" else None,
            "streams": [f"s{i}" for i in names], "ranks": ranks}
        if mesh.stream > 1 and metrics_json:
            stem, dot, ext = metrics_json.rpartition(".")
            metrics_json = (f"{stem}_g{mesh.coords['stream']}.{ext}" if dot
                            else f"{metrics_json}_g{mesh.coords['stream']}")
    if metrics_json and first_rank:
        with open(metrics_json, "w") as f:
            json.dump(metrics, f)
            f.write("\n")
    return stats
