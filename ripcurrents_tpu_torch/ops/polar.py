"""Cartesian -> polar conversion for flow fields (port of
``ripcurrents_tpu/ops/polar.py``; cv::cartToPolar with angleInDegrees at
ripcurrents.cpp:305-309, exact atan2)."""

from __future__ import annotations

import math

import torch


def flow_to_polar(flow: torch.Tensor):
    """(H, W, 2) flow -> (magnitude, angle in degrees [0, 360)).
    Channel 0 is dx, channel 1 is dy."""
    x, y = flow[..., 0], flow[..., 1]
    mag = torch.sqrt(x * x + y * y)
    ang = torch.atan2(y, x) * (180.0 / math.pi)
    return mag, torch.where(ang < 0, ang + 360.0, ang)
