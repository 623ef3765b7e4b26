"""HSV -> BGR with OpenCV conventions (port of ``hsv_to_bgr`` from
``ripcurrents_tpu/ops/color.py``): float images have H in degrees
[0, 360) and S, V in [0, 1]; uint8 images have H in [0, 180) and S, V in
[0, 255]."""

from __future__ import annotations

import torch


def _hsv_to_rgb_float(h, s, v):
    """OpenCV HSV2RGB on float values: h degrees, s/v in [0,1]."""
    h = torch.remainder(h / 60.0, 6.0)
    sector = torch.floor(h).to(torch.int32)
    f = h - sector
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))

    def select(vals, default):
        out = default
        for k in range(4, -1, -1):
            out = torch.where(sector == k, vals[k], out)
        return out

    r = select([v, q, p, p, t], v)
    g = select([t, v, v, q, p], p)
    b = select([p, p, t, v, v], q)
    return r, g, b


def hsv_to_bgr(hsv: torch.Tensor) -> torch.Tensor:
    """(..., 3) HSV -> BGR: float HSV (H in degrees) -> float BGR in
    [0, 1]; uint8 HSV (H in [0, 180)) -> uint8 BGR."""
    if hsv.dtype == torch.uint8:
        h = hsv[..., 0].to(torch.float32) * 2.0
        s = hsv[..., 1].to(torch.float32) / 255.0
        v = hsv[..., 2].to(torch.float32) / 255.0
        r, g, b = _hsv_to_rgb_float(h, s, v)
        bgr = torch.stack([b, g, r], dim=-1)
        return torch.clamp(torch.round(bgr * 255.0), 0, 255).to(torch.uint8)
    r, g, b = _hsv_to_rgb_float(hsv[..., 0], hsv[..., 1], hsv[..., 2])
    return torch.stack([b, g, r], dim=-1)
