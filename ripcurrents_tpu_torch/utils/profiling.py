"""Per-stage wall timers and a torch.profiler trace helper.

The reference times stages with a static-state gettimeofday diff
(ripcurrents_module.cpp:681-688) and prints totals at exit
(ripcurrents.cpp:517-524). Here timers are explicit objects, and device
work can be traced with torch.profiler into a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class StageTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(f"time spent on {name}: {total:.3f}s "
                         f"({n} calls, {total / max(n, 1) * 1e3:.2f} ms/call)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler session around a block (host ops, and CUDA kernels
    and copies where a card is present); writes ``logdir/trace.json``
    (open in chrome://tracing or Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
