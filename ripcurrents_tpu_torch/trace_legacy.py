"""Where the time of the legacy step goes on the card.

Drives ``make_legacy`` at 640x480 over synthetic 1280x720 frames (the
chip_smoke.py main path), traces a window of warm frames with
``torch.profiler`` and prints, per frame: host wall time, device kernel
time, the device's busy share, launches, and the kernels that take the
most device time. Run from the repository root on a machine with a card:

    python -m ripcurrents_tpu_torch.trace_legacy [--frames 20] [--traced 10]
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ripcurrents_tpu_torch.flow import fused_update as fu
from ripcurrents_tpu_torch.pipelines.common import ModeConfig
from ripcurrents_tpu_torch.pipelines.legacy import make_legacy
from ripcurrents_tpu_torch.synthetic import moving_frames


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=20,
                    help="warm-up frames before the traced window")
    ap.add_argument("--traced", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_legacy: no CUDA device")
    dev = torch.device("cuda")
    n = args.frames + args.traced
    cfg = ModeConfig(total_frames=n)
    raw = moving_frames(n + 1, 720, 1280, dev)
    init, step = make_legacy(cfg, device=dev)
    state = init(raw[0])
    half = args.frames // 2
    for t in range(1, args.frames + 1):
        if t == half + 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, _ = step(state, raw[t])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / (args.frames - half)
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
        "frames_traced": args.traced,
        "wall_ms_per_frame_untraced": plain_ms,
        "wall_ms_per_frame_traced": wall_ms,
        "device_kernel_ms_per_frame": dev_ms,
        "device_busy_share_untraced": dev_ms / plain_ms,
        "device_launches_per_frame": len(kernels) / args.traced,
        "k1_k2_launches": [fu.farneback_update.launches,
                           fu.farneback_blur_solve.launches],
        "top_kernels_us_per_frame": [
            {"name": k[:80], "us": v[0] / args.traced,
             "launches": v[1] / args.traced} for k, v in top],
    }, indent=1))


if __name__ == "__main__":
    main()
