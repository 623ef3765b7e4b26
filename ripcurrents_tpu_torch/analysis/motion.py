"""Motion-history global orientation (port of ``ripcurrents_tpu/analysis/
motion.py``; globalOrientation, ripcurrents_module.cpp:319-359, which uses
OpenCV-contrib's motempl updateMotionHistory / calcMotionGradient /
calcGlobalOrientation on abs-diff silhouettes):

- motion history: a timestamped decay buffer;
- gradient: the Sobel 3x3 orientation of the history surface, valid where
  the local min/max spread lies within the delta bounds;
- global orientation: a 12-bin orientation vote, then the recency-weighted
  mean deviation around the winning bin.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ripcurrents_tpu_torch.ops.conv import sep_filter2d


def update_motion_history(mhi: torch.Tensor, silhouette: torch.Tensor,
                          timestamp, duration) -> torch.Tensor:
    """updateMotionHistory: stamp moving pixels with `timestamp`, zero the
    ones older than timestamp - duration."""
    ts = float(timestamp)
    mhi = torch.where(silhouette > 0, ts, mhi)
    return torch.where((silhouette <= 0) & (mhi < ts - duration), 0.0, mhi)


class MotionGradient(NamedTuple):
    orientation_deg: torch.Tensor  # (H, W) in [0, 360)
    mask: torch.Tensor             # (H, W) bool: the gradient is valid


def motion_gradient(mhi: torch.Tensor, delta1: float, delta2: float,
                    aperture: int = 3) -> MotionGradient:
    """calcMotionGradient with a Sobel aperture of 3."""
    smooth, diff = (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)
    dx = sep_filter2d(mhi, smooth, diff, border="replicate")
    dy = sep_filter2d(mhi, diff, smooth, border="replicate")
    orient = torch.atan2(dy, dx) * (180.0 / math.pi)
    orient = torch.where(orient < 0, orient + 360.0, orient)
    # local min and max over the aperture window (erode / dilate)
    r = aperture // 2
    pad = F.pad(mhi[None, None], (r, r, r, r), mode="replicate")[0, 0]
    h, w = mhi.shape
    mn = mx = None
    for oy in range(aperture):
        for ox in range(aperture):
            s = pad[oy:oy + h, ox:ox + w]
            mn = s if mn is None else torch.minimum(mn, s)
            mx = s if mx is None else torch.maximum(mx, s)
    d1, d2 = min(delta1, delta2), max(delta1, delta2)
    spread = mx - mn
    mask = (spread >= d1) & (spread <= d2) & \
        ((torch.abs(dx) > 1e-6) | (torch.abs(dy) > 1e-6))
    return MotionGradient(orient, mask)


def global_orientation(orientation_deg: torch.Tensor, mask: torch.Tensor,
                       mhi: torch.Tensor, timestamp,
                       duration) -> torch.Tensor:
    """calcGlobalOrientation: a 12-bin vote for the base orientation (the
    first bin on a tie), then the recency-weighted mean deviation around
    it."""
    hist_size = 12
    bins = torch.clamp((orientation_deg * hist_size / 360.0).to(torch.int64),
                       0, hist_size - 1)
    m = mask & (mhi > 0)
    counts = torch.zeros(hist_size, dtype=torch.float32,
                         device=mhi.device).index_add_(
        0, torch.where(m, bins, hist_size - 1).reshape(-1),
        m.to(torch.float32).reshape(-1))
    base = torch.argmax(counts).to(torch.float32) * (360.0 / hist_size)
    ts = float(timestamp)
    w = torch.where(m, (mhi - (ts - duration)) / duration, 0.0)
    w = torch.clamp(w, 0.0, 1.0)
    rel = orientation_deg - base
    rel = torch.where(rel < -180.0, rel + 360.0,
                      torch.where(rel > 180.0, rel - 360.0, rel))
    ang = base + torch.sum(w * rel) / torch.clamp(torch.sum(w), min=1e-6)
    return torch.where(ang < 0, ang + 360.0,
                       torch.where(ang >= 360.0, ang - 360.0, ang))


class GlobalOrientationOut(NamedTuple):
    mhi_norm: torch.Tensor   # (H, W) normalized motion history for display
    angle_deg: torch.Tensor  # () global motion direction
    orientation: MotionGradient


def global_orientation_step(prev_gray_u8: torch.Tensor,
                            cur_gray_u8: torch.Tensor,
                            timestamp: float = 1.0) -> GlobalOrientationOut:
    """globalOrientation on one frame pair (ripcurrents_module.cpp:
    319-337): abs-diff -> threshold 30 -> motion history -> normalize ->
    gradient (0.25, 1) -> global angle."""
    diff = torch.abs(cur_gray_u8.to(torch.int32) -
                     prev_gray_u8.to(torch.int32))
    sil = (diff > 30).to(torch.float32)
    mhi = update_motion_history(torch.zeros_like(sil), sil, timestamp, 1.0)
    mhi_n = mhi / torch.clamp(torch.max(mhi), min=1e-6)
    grad = motion_gradient(mhi_n, 0.25, 1.0, 3)
    ang = global_orientation(grad.orientation_deg, grad.mask, mhi_n,
                             timestamp, 1.0)
    return GlobalOrientationOut(mhi_n, ang, grad)
