"""Where the time of a mode's step goes on the card.

Drives one registered mode (``legacy`` by default; ``--mode timelines``,
``--mode subtructAverageVector`` and every other ported mode likewise) at
640x480 over synthetic 1280x720 frames (the chip_smoke.py main paths),
traces a window of warm frames with ``torch.profiler`` and prints, per
frame: host wall time, device kernel time, the device's busy share,
launches (all kernels, and each of K1-K8), and the kernels that take the
most device time. ``--warp-impl pallas`` (or ``tiled``) runs a Farneback
mode on the portable engine. Run from the repository root on a machine
with a card:

    python -m ripcurrents_tpu_torch.trace_legacy [--mode legacy]
        [--warp-impl pallas|tiled] [--frames 20] [--traced 10]
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ripcurrents_tpu_torch.flow import fused_update as fu
from ripcurrents_tpu_torch.flow import prep_kernel
from ripcurrents_tpu_torch.flow.lk_kernel import lk_track
from ripcurrents_tpu_torch.flow.warp_kernel import warp5_shift, warp_tiles
from ripcurrents_tpu_torch.ops.image import resize_bilinear_cf_padded
from ripcurrents_tpu_torch.pipelines import runner
from ripcurrents_tpu_torch.pipelines.common import ModeConfig
from ripcurrents_tpu_torch.synthetic import moving_frames

# The wrappers of the eight kernels; each counts its launches in its
# `launches` attribute.
COUNTERS = {"K1": fu.farneback_update, "K2": fu.farneback_blur_solve,
            "K3": lk_track, "K4": resize_bilinear_cf_padded,
            "K5": prep_kernel.prep_y, "K6": prep_kernel.prep_x3,
            "K7": warp5_shift, "K8": warp_tiles}


def reset_launches() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """{"K1": n, ...}: launches since the last reset_launches()."""
    return {name: fn.launches for name, fn in COUNTERS.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="legacy", choices=sorted(runner.MODES))
    ap.add_argument("--warp-impl", default=None,
                    choices=["fused", "gather", "shift", "pallas", "tiled"],
                    help="the Farneback warp (default: the mode's preset)")
    ap.add_argument("--frames", type=int, default=20,
                    help="warm-up frames before the traced window")
    ap.add_argument("--traced", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_legacy: no CUDA device")
    dev = torch.device("cuda")
    n = args.frames + args.traced
    cfg = ModeConfig(total_frames=n, warp_impl=args.warp_impl)
    raw = moving_frames(n + 1, 720, 1280, dev)
    init, step = runner.MODES[args.mode](cfg, device=dev)
    state = init(raw[0])
    half = args.frames // 2
    for t in range(1, args.frames + 1):
        if t == half + 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, _ = step(state, raw[t])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / (args.frames - half)
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(args.frames + 1, n + 1):
            state, _ = step(state, raw[t])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.traced
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = (sum(e.time_range.elapsed_us() for e in kernels) / 1e3 /
              args.traced)
    by_name = {}
    for e in kernels:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(json.dumps({
        "mode": args.mode,
        "warp_impl": args.warp_impl,
        "frames_traced": args.traced,
        "wall_ms_per_frame_untraced": plain_ms,
        "wall_ms_per_frame_traced": wall_ms,
        "device_kernel_ms_per_frame": dev_ms,
        "device_busy_share_untraced": dev_ms / plain_ms,
        "device_launches_per_frame": len(kernels) / args.traced,
        "kernel_launches_per_frame": {
            k: n / args.traced for k, n in launch_counts().items()},
        "top_kernels_us_per_frame": [
            {"name": k[:80], "us": v[0] / args.traced,
             "launches": v[1] / args.traced} for k, v in top],
    }, indent=1))


if __name__ == "__main__":
    main()
