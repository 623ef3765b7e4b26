"""Shared pipeline plumbing: configuration, frame prep, the flow stream
(port of the legacy-path parts of ``ripcurrents_tpu/pipelines/
common.py``)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ripcurrents_tpu_torch.config import (FarnebackParams, HistogramParams,
                                          XDIM, YDIM)
from ripcurrents_tpu_torch.flow.farneback import (farneback_precompute,
                                                  farneback_stream)
from ripcurrents_tpu_torch.ops.image import (bgr_to_gray, resize_area,
                                             resize_bilinear)


@dataclasses.dataclass(frozen=True)
class ModeConfig:
    """Static configuration of a mode (the legacy pipeline's fields)."""
    xdim: int = XDIM
    ydim: int = YDIM
    total_frames: int = 0        # CAP_PROP_FRAME_COUNT
    seed: int = 0                # seed of the random streamline seeds
    hist: HistogramParams = HistogramParams()
    legacy_seeds: int = 250


def prep_frame(raw_bgr_u8: torch.Tensor, cfg: ModeConfig,
               first: bool = False):
    """Resize to the working resolution + grayscale (main.cpp:142-144);
    first frames use INTER_AREA (main.cpp:125). -> (resized BGR, gray)."""
    resize = resize_area if first else resize_bilinear
    resized = resize(raw_bgr_u8, (cfg.ydim, cfg.xdim))
    return resized, bgr_to_gray(resized)


class FlowStream(NamedTuple):
    """Carried Farneback stream state: the previous frame's per-level
    expansion tables, so each frame is expanded once per stream."""
    exp: tuple


def flow_stream_init(gray: torch.Tensor, fb: FarnebackParams) -> FlowStream:
    return FlowStream(farneback_precompute(gray, fb))


def flow_stream_step(fs: FlowStream, gray: torch.Tensor,
                     fb: FarnebackParams):
    """-> (flow (H, W, 2) to the new frame, updated FlowStream)."""
    flow, exp = farneback_stream(fs.exp, gray, fb)
    return flow, FlowStream(exp)
