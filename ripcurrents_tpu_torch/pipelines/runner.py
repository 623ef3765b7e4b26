"""Stream runner: drives a registered mode's step over frames (the device
half of ``ripcurrents_tpu/pipelines/runner.py``).

Frames come from any iterable of (H, W, 3) uint8 BGR arrays or tensors;
each is uploaded, stepped, and its output frame yielded as a tensor on
the device. There is no video decode here and no chunked scan: PyTorch
runs eagerly, so the loop is a plain one and a step never waits for the
device.

``ModeConfig.total_frames`` (the reference's CAP_PROP_FRAME_COUNT) left
at 0 is taken from the source's length, at least 1, as the JAX runner
takes it from the video. The modes that shade their trails by it raise
on a source without a length unless the config gives the count.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator, Optional

import torch

from ripcurrents_tpu_torch import resolve_device
from ripcurrents_tpu_torch.pipelines.common import MODES, ModeConfig
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
