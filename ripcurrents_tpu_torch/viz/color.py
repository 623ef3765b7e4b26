"""The per-frame threshold wheel (port of ``histogram_wheel`` from
``ripcurrents_tpu/viz/color.py``; display_histogram,
ripcurrents_module.cpp:246-277)."""

from __future__ import annotations

import math

import torch

from ripcurrents_tpu_torch.config import HistogramParams
from ripcurrents_tpu_torch.ops.color import hsv_to_bgr


def histogram_wheel(upper2d: torch.Tensor, prop_above_upper: torch.Tensor,
                    p: HistogramParams = HistogramParams(),
                    size: int = 480) -> torch.Tensor:
    """A polar wheel where S=0 beyond each direction's UPPER2d radius and
    V=0 beyond prop_above_upper*10 -> (size, size, 3) uint8 BGR."""
    dev = upper2d.device
    c = size / 2.0
    ys, xs = torch.meshgrid(torch.arange(size, dtype=torch.float32, device=dev),
                            torch.arange(size, dtype=torch.float32, device=dev),
                            indexing="ij")
    tx = (xs - c) / c
    ty = (ys - c) / c
    theta = torch.atan2(ty, tx) * (180.0 / math.pi)
    theta = torch.where(theta < 0, theta + 360.0, theta)
    r = torch.sqrt(tx * tx + ty * ty)
    d = torch.clamp((theta * p.directions / 360.0).to(torch.int32),
                    0, p.directions - 1).long()
    hue = d.to(torch.float32) * (360.0 / p.directions)
    s = torch.where(r > upper2d[d] * p.resolution / p.bins, 0.0, 1.0)
    v = torch.where(r > prop_above_upper[d] * 10.0, 0.0, 1.0)
    bgr = hsv_to_bgr(torch.stack([hue, s, v], dim=-1))
    return torch.clamp(torch.round(bgr * 255.0), 0, 255).to(torch.uint8)
