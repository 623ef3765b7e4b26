"""Command-line interface of the PyTorch port.

The reference selects its mode by editing/recompiling main.cpp:76-87 and
accepts `ripcurrents <video> [outputFileName]` (main.cpp:55-90). Here every
mode is a `--mode` flag with the same defaults; all compile-time constants
are exposed as flags. The flags, names, defaults and choices are those of
the JAX package's CLI, plus `--device`:

    python -m ripcurrents_tpu_torch beach.mp4 out --mode timelines

Everything runs on the CUDA card unless `--device cpu` is given; without
a card the default exits with an error instead of falling back.
`--videos a b ...` runs N streams in lock-step on the process's card
(``pipelines/multirunner.py``); `--coordinator HOST:PORT --num-processes
N --process-id I` makes each of N processes one member of a stream farm
(``parallel/distributed.py``, a gloo process group), each running its
own videos. `--mesh-space K > 1` with the farm's flags splits each
frame's rows over K processes (a world of S x K: S stream groups of K
ranks, all running the same command with the same videos); every
registered mode has a space form (``common.register``).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

SPECIAL_MODES = ("stabilize", "validate", "wheel", "benchmark", "legacy-full")


def build_parser() -> argparse.ArgumentParser:
    from ripcurrents_tpu_torch.pipelines.runner import MODES  # registry

    p = argparse.ArgumentParser(
        prog="ripcurrents_tpu_torch",
        description="PyTorch/CUDA rip-current video flow engine")
    p.add_argument("video", nargs="?", default=None,
                   help="input video path ('-' for webcam)")
    p.add_argument("output", nargs="?", default="default",
                   help="output file stem (reference: outputFileName)")
    p.add_argument("--videos", nargs="+", default=None, metavar="VIDEO",
                   help="N input videos processed in lock-step as "
                        "independent streams on this process's card (one "
                        "output per stream: <stem>_s<i>.mp4). With "
                        "--videos a positional (given BEFORE --videos or "
                        "after '--') names the output stem instead.")
    p.add_argument("--mesh-space", type=int, default=1, metavar="K",
                   help="with --videos: additionally shard frame rows "
                        "over K devices (one process each; the farm "
                        "flags start them)")
    p.add_argument("--mode", default="timelines",
                   choices=sorted(set(MODES) | set(SPECIAL_MODES)),
                   help="pipeline mode (reference default: timelines)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the steps run: the CUDA card (default; an "
                        "error without one) or the CPU's plain versions")
    p.add_argument("--chunk", type=int, default=8,
                   help="frames per upload/download chunk")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--xdim", type=int, default=640)
    p.add_argument("--ydim", type=int, default=480)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bright-option", type=int, default=0, choices=[0, 1, 2],
                   help="brightColor: 0=mean 1=max-V 2=min-V (main.cpp:1320)")
    p.add_argument("--no-output", action="store_true",
                   help="skip video encoding (throughput measurement)")
    p.add_argument("--no-host-prep", action="store_true",
                   help="disable the native FramePump host resize path")
    p.add_argument("--metrics-json", default=None, metavar="PATH",
                   help="write per-run metrics (fps, stage times) as JSON")
    p.add_argument("--preview", action="store_true",
                   help="live imshow window (needs a display; the "
                        "reference shows one per mode)")

    ck = p.add_argument_group("checkpoint/resume")
    ck.add_argument("--checkpoint-every", type=int, default=None,
                    metavar="N", help="save pipeline state every N frames")
    ck.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="checkpoint file (default: <output>.ckpt.npz)")
    ck.add_argument("--resume", default=None, metavar="PATH",
                    help="resume from a checkpoint written by a prior run")

    # Every reference compile-time constant (ripcurrents.hpp:4-13 and the
    # per-mode literals) is a flag; defaults are the reference values.
    c = p.add_argument_group("mode constants")
    c.add_argument("--window-size", type=int, default=10,
                   help="sliding flow-mean window (main.cpp:1084)")
    c.add_argument("--average-buffer", type=int, default=300,
                   help="BUFFER_FRAME ring length (ripcurrents.hpp:11)")
    c.add_argument("--timex-window", type=int, default=500,
                   help="timex exposure length (main.cpp:1213)")
    c.add_argument("--shear-window", type=int, default=100)
    c.add_argument("--bright-window", type=int, default=50)
    c.add_argument("--timeline-vertices", type=int, default=200)
    c.add_argument("--max-streaklines", type=int, default=5)
    c.add_argument("--population-vertices", type=int, default=50)
    c.add_argument("--n-streamline-seeds", type=int, default=20)
    c.add_argument("--legacy-seeds", type=int, default=250)
    c.add_argument("--lk-win", type=int, default=None,
                   help="LK window size (square; preset default 50)")
    c.add_argument("--lk-levels", type=int, default=None)
    c.add_argument("--lk-iters", type=int, default=None)
    c.add_argument("--lk-eps", type=float, default=None)
    c.add_argument("--thr-lower", type=float, default=0.2)
    c.add_argument("--thr-mid", type=float, default=0.5)
    c.add_argument("--thr-upper-init", type=float, default=45.0)
    c.add_argument("--hist-bins", type=int, default=50)
    c.add_argument("--hist-directions", type=int, default=36)
    c.add_argument("--hist-resolution", type=int, default=20)
    c.add_argument("--hist-top-frac", type=float, default=0.05)
    c.add_argument("--warp-impl", default=None,
                   choices=["fused", "tiled", "shift", "gather"],
                   help="override the Farneback warp strategy")
    c.add_argument("--warp-residual", type=int, default=None,
                   help="override the tiled/fused warp residual budget")
    c.add_argument("--warp-subcol", type=int, default=None,
                   help="override the fused-warp subcolumn width "
                        "(e.g. 128; must divide the padded frame width)")
    c.add_argument("--dump-matches", action="store_true",
                   help="--mode stabilize: write per-frame keypoint-match "
                        "visualizations to match/ (the reference's debug "
                        "dump, main.cpp:1625-1637)")
    c.add_argument("--stab-features", default="harris",
                   choices=["harris", "akaze"],
                   help="stabilizeTPU feature engine: Harris corners or "
                        "the AKAZE-class detector/descriptor "
                        "(flow/akaze_tpu.py)")

    d = p.add_argument_group(
        "multi-host stream farm (parallel/distributed.py): every process "
        "runs the same command with its own videos; only aggregate "
        "metrics cross processes")
    d.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="address process 0 serves the farm's gloo "
                        "rendezvous on")
    d.add_argument("--num-processes", type=int, default=None)
    d.add_argument("--process-id", type=int, default=None)
    return p


def _mode_config(args):
    import dataclasses

    from ripcurrents_tpu_torch.config import (HistogramParams, LKParams,
                                              Thresholds)
    from ripcurrents_tpu_torch.pipelines.common import ModeConfig
    lk = LKParams.particles()
    lk_kw = {}
    if args.lk_win is not None:
        lk_kw["win"] = (args.lk_win, args.lk_win)
    if args.lk_levels is not None:
        lk_kw["levels"] = args.lk_levels
    if args.lk_iters is not None:
        lk_kw["max_iters"] = args.lk_iters
    if args.lk_eps is not None:
        lk_kw["eps"] = args.lk_eps
    if lk_kw:
        lk = dataclasses.replace(lk, **lk_kw)
    return ModeConfig(
        xdim=args.xdim, ydim=args.ydim, seed=args.seed,
        bright_option=args.bright_option,
        window_size=args.window_size, average_buffer=args.average_buffer,
        timex_window=args.timex_window, shear_window=args.shear_window,
        bright_window=args.bright_window,
        timeline_vertices=args.timeline_vertices,
        max_streaklines=args.max_streaklines,
        population_vertices=args.population_vertices,
        n_streamline_seeds=args.n_streamline_seeds,
        legacy_seeds=args.legacy_seeds,
        lk=lk,
        thresholds=Thresholds(args.thr_lower, args.thr_mid,
                              args.thr_upper_init),
        hist=HistogramParams(bins=args.hist_bins,
                             directions=args.hist_directions,
                             resolution=args.hist_resolution,
                             top_frac=args.hist_top_frac),
        warp_impl=args.warp_impl, warp_residual=args.warp_residual,
        warp_subcol=args.warp_subcol,
        stab_features=args.stab_features,
    )


def _stabilize_akaze(args):
    """AKAZE + cross-match + RANSAC homography stabilization
    (main.cpp:1556-1682). Feature detection/matching is host-side OpenCV,
    as in the JAX package; the on-device stabilizers are --mode
    stabilizeTPU and phaseCorrelate."""
    import os

    import cv2
    from ripcurrents_tpu_torch.io import video as io_video
    reader = io_video.VideoReader(args.video)
    writer = None
    if args.dump_matches:
        # Per-frame match visualizations, as the reference dumps to a
        # match/ directory next to the output (main.cpp:1625-1637).
        os.makedirs("match", exist_ok=True)
    # OpenCV 5.x moved AKAZE to contrib; SIFT is the closest in-tree
    # detector/descriptor (same cross-match + RANSAC pipeline either way).
    if hasattr(cv2, "AKAZE_create"):
        algorithm = cv2.AKAZE_create()
    else:
        algorithm = cv2.SIFT_create()
    matcher = cv2.DescriptorMatcher_create("BruteForce")
    prev = None
    for n, frame in enumerate(reader):
        cur = cv2.resize(frame, (args.xdim, args.ydim),
                         interpolation=cv2.INTER_AREA)
        if prev is None:
            prev = cur
            continue
        kp1, d1 = algorithm.detectAndCompute(prev, None)
        kp2, d2 = algorithm.detectAndCompute(cur, None)
        correction = cur
        if d1 is not None and d2 is not None and len(kp1) and len(kp2):
            m12 = matcher.match(d1, d2)
            m21 = matcher.match(d2, d1)
            good = []
            for fwd in m12:
                bwd = m21[fwd.trainIdx]
                if bwd.trainIdx == fwd.trainIdx:
                    p1 = kp1[fwd.trainIdx].pt
                    p2 = kp2[fwd.trainIdx].pt
                    if abs(p1[0] - p2[0]) < 1.0 and abs(p1[1] - p2[1]) < 1.0:
                        good.append(fwd)
            if good:
                if args.dump_matches:
                    vis = cv2.drawMatches(prev, kp1, cur, kp2, good, None)
                    cv2.imwrite(os.path.join("match", f"match_{n}.jpg"),
                                vis)
                src = np.float32([kp1[m.trainIdx].pt for m in good])
                dst = np.float32([kp2[m.trainIdx].pt for m in good])
                if len(good) >= 4:
                    m, _ = cv2.findHomography(src, dst, cv2.RANSAC)
                    if m is not None:
                        correction = cv2.warpPerspective(
                            cur, np.linalg.inv(m), (args.xdim, args.ydim))
        if writer is None and not args.no_output:
            writer = io_video.VideoWriter("stablization.mp4", reader.fps,
                                          (args.ydim, args.xdim))
        if writer:
            writer.write(correction)
        prev = correction
        print(f"frames processed: {n}", flush=True)
        if args.max_frames and n >= args.max_frames:
            break
    if writer:
        writer.close()
    reader.close()


def validate_orbit(ydim: int, xdim: int, device) -> np.ndarray:
    """validate_streamlines' orbit (main.cpp:303-443): one streamline from
    (200, 200) through the analytic circular field, dt 0.03, 3500 steps.
    -> its radius about the frame centre at each of the 3501 points."""
    import torch
    from ripcurrents_tpu_torch.dynamics import advect
    flow = advect.circular_field(ydim, xdim, device)
    res = advect.streamline(torch.tensor([200.0, 200.0], device=device),
                            flow, dt=0.03, iterations=3500)
    pts = res.points.cpu().numpy()
    center = np.array([xdim / 2.0, ydim / 2.0])
    return np.sqrt(((pts - center) ** 2).sum(-1))


def _validate(args, device):
    """Integrate one streamline through the analytic circular field and
    report the orbit error; exit 0 when it drifts less than 5%."""
    r = validate_orbit(args.ydim, args.xdim, device)
    drift = abs(r[-1] - r[0]) / r[0]
    print(f"orbit radius start={r[0]:.3f} end={r[-1]:.3f} "
          f"drift={drift * 100:.3f}%")
    return 0 if drift < 0.05 else 1


def _wheel(args, device):
    """Generate the color-wheel legend PNG (android wheel(),
    jni/ripcurrents.cpp:31-70)."""
    import cv2
    from ripcurrents_tpu_torch.viz.color import color_wheel
    img = color_wheel(480, device=device).cpu().numpy()
    cv2.imwrite("wheel.png", img)
    print("Generated wheel.png")


def _benchmark(args, device):
    """farnebackAndLkSpeedComparison (ripcurrents_module.cpp:696-721):
    time Farneback vs dense-grid LK on one frame pair. The dense grid
    (every pixel, 307k points at 640x480) runs the dense LK engine
    (flow/dense_lk.py). Each is called once to warm up, then timed over
    one call ended by a device synchronize."""
    import torch
    from ripcurrents_tpu_torch.config import FarnebackParams, LKParams
    from ripcurrents_tpu_torch.flow.dense_lk import dense_lk
    from ripcurrents_tpu_torch.flow.farneback import farneback
    from ripcurrents_tpu_torch.io import video as io_video
    from ripcurrents_tpu_torch.pipelines.common import (ModeConfig,
                                                        prep_frame,
                                                        to_device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = ModeConfig(xdim=args.xdim, ydim=args.ydim)
    reader = io_video.VideoReader(args.video)
    it = iter(reader)
    _, g1 = prep_frame(to_device(next(it), device), cfg, first=True)
    _, g2 = prep_frame(to_device(next(it), device), cfg)
    reader.close()

    def timed(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    t_farne = timed(lambda: farneback(
        g2, g1, FarnebackParams(0.5, 2, 3, 2, 15, 1.2, True)))
    t_lk = timed(lambda: dense_lk(g1, g2, LKParams.dense_grid()))
    n_pts = args.xdim * args.ydim
    print(f"farneback {t_farne * 1e3:.2f} ms")
    print(f"lk (dense grid, {n_pts} points) {t_lk * 1e3:.2f} ms")


LEGACY_STREAMS = {"overlay_bgr": "video_borders",
                  "streamlines_bgr": "video_streamlines",
                  "density_bgr": "video_streamlines_only",
                  "flow_hsv_bgr": "video_flow", "duty_bgr": "video_duty",
                  "hist_wheel_bgr": "video_histogram"}


def _legacy_full(args, device):
    """The legacy detector with all three parity output videos
    (ripcurrents.cpp:79-100: video_streamlines, video_streamlines_only,
    video_borders) plus the duty/flow diagnostic views, each chunk of
    outputs downloaded in one copy per stream."""
    import dataclasses

    import torch
    from ripcurrents_tpu_torch.io import video as io_video
    from ripcurrents_tpu_torch.pipelines.legacy import make_legacy

    reader = io_video.VideoReader(args.video)
    cfg = dataclasses.replace(_mode_config(args),
                              total_frames=max(reader.frame_count, 1))
    init, step = make_legacy(cfg, device=device)
    frames_iter = iter(reader)
    state = init(next(frames_iter))

    writers = {}
    outs, n = [], 0
    for frame in frames_iter:
        state, out = step(state, frame)
        outs.append(out)
        n += 1
        if len(outs) == args.chunk or (args.max_frames and
                                       n >= args.max_frames):
            for field, stem in LEGACY_STREAMS.items():
                arr = torch.stack([getattr(o, field) for o in outs]).cpu()
                if field not in writers:
                    writers[field] = io_video.VideoWriter(
                        f"{stem}.mp4", reader.fps, tuple(arr.shape[1:3]))
                writers[field].write_batch(arr.numpy())
            print(f"frames processed: {n}", flush=True)
            outs = []
        if args.max_frames and n >= args.max_frames:
            break
    for wtr in writers.values():
        wtr.close()
    reader.close()


def _refuse(args) -> "str | None":
    """Why this command cannot run (before any work starts), or None."""
    if args.videos and args.mode in SPECIAL_MODES:
        return f"--videos cannot be combined with --mode {args.mode}"
    if not args.videos and not args.video:
        return "an input video is required (positional or --videos)"
    if args.mesh_space != 1:
        from ripcurrents_tpu_torch.pipelines.multirunner import (
            _stream_mesh)
        try:
            _stream_mesh(len(args.videos or ()) or 1, args.mesh_space,
                         world=args.num_processes or 1, ydim=args.ydim)
        except ValueError as e:
            return str(e)
        if not args.videos:
            return f"--mesh-space {args.mesh_space} needs --videos"
    return None


def main(argv=None) -> int:
    from ripcurrents_tpu_torch import resolve_device
    args = build_parser().parse_args(argv)
    why = _refuse(args)
    if why is not None:
        print(f"error: {why}", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e} (use --device cpu)", file=sys.stderr)
        return 2
    if args.coordinator or (args.num_processes or 0) > 1:
        # Join the farm before any work; each process then runs its own
        # videos.
        from ripcurrents_tpu_torch.parallel.distributed import init_cluster
        try:
            init_cluster(args.coordinator, args.num_processes,
                         args.process_id)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if args.mode == "stabilize":
        _stabilize_akaze(args)
        return 0
    if args.mode == "validate":
        return _validate(args, device)
    if args.mode == "wheel":
        _wheel(args, device)
        return 0
    if args.mode == "benchmark":
        _benchmark(args, device)
        return 0
    if args.mode == "legacy-full":
        _legacy_full(args, device)
        return 0

    cfg = _mode_config(args)
    if args.videos:
        # N streams in lock-step on this card (pipelines/multirunner.py).
        # The positional slot, if filled, names the output stem (the input
        # role is taken).
        from ripcurrents_tpu_torch.pipelines.multirunner import run_videos
        stem = args.video if args.video is not None else args.output
        run_videos(args.mode, args.videos,
                   None if args.no_output else stem, cfg,
                   chunk=args.chunk, max_frames=args.max_frames,
                   space=args.mesh_space, metrics_json=args.metrics_json,
                   host_prep=not args.no_host_prep, device=device)
        return 0

    from ripcurrents_tpu_torch.pipelines.runner import run_video
    out = None if args.no_output else f"{args.output}.mp4"
    frame_skip = 3 if args.mode == "android" else 1
    max_frames = args.max_frames
    if args.mode == "timex":
        # The reference's timex loop runs exactly windowSize frames
        # (main.cpp:1213-1218).
        max_frames = min(max_frames or cfg.timex_window, cfg.timex_window)
    ckpt = args.checkpoint or f"{args.output}.ckpt"
    run_video(args.mode, args.video, out, cfg, chunk=args.chunk,
              max_frames=max_frames, frame_skip=frame_skip,
              host_prep=not args.no_host_prep,
              checkpoint_every=args.checkpoint_every,
              checkpoint_path=ckpt, resume=args.resume,
              metrics_json=args.metrics_json, preview=args.preview,
              device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
