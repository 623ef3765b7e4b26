"""Colour-space conversions with OpenCV conventions (port of
``ripcurrents_tpu/ops/color.py``): HSV -> BGR/RGB for the visualizations
and BGR/RGB -> HSV for compute_brightColor (main.cpp:1265-1382). Float
images have H in degrees [0, 360) and S, V in [0, 1]; uint8 images have H
in [0, 180) and S, V in [0, 255]."""

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


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    return torch.flip(hsv_to_bgr(hsv), dims=(-1,))


def bgr_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) BGR -> HSV in the ranges of the module docstring."""
    return _to_hsv(img, order="bgr")


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    return _to_hsv(img, order="rgb")


def _to_hsv(img: torch.Tensor, order: str) -> torch.Tensor:
    """The JAX package's operations in its order, so that a uint8 result
    rounds alike at the sector edges."""
    is_u8 = img.dtype == torch.uint8
    x = img.to(torch.float32)
    if is_u8:
        x = x / 255.0
    if order == "bgr":
        b, g, r = x[..., 0], x[..., 1], x[..., 2]
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    s = torch.where(v > 0, c / torch.clamp(v, min=1e-20), 0.0)
    safe_c = torch.clamp(c, min=1e-20)
    h = torch.where(
        c == 0, 0.0,
        torch.where(v == r, 60.0 * (g - b) / safe_c,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe_c,
                                240.0 + 60.0 * (r - g) / safe_c)))
    h = torch.where(h < 0, h + 360.0, h)
    if is_u8:
        out = torch.stack([h / 2.0, s * 255.0, v * 255.0], dim=-1)
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return torch.stack([h, s, v], dim=-1)
