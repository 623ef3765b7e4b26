"""Flow colorization and legend images (port of ``ripcurrents_tpu/viz/
color.py``): vectorToColor (ripcurrents_module.cpp:1017-1057),
display_histogram's wheel (:246-277) and the colour-wheel legends
(ripcurrents.cpp:575-609, android jni/ripcurrents.cpp:31-70). The running
max displacement the reference keeps in a function-static float is
explicit state here."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ripcurrents_tpu_torch.config import HistogramParams
from ripcurrents_tpu_torch.ops.color import hsv_to_bgr
from ripcurrents_tpu_torch.viz.draw import _linspace01


def _grid(size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    a = torch.arange(size, dtype=torch.float32, device=device)
    return torch.meshgrid(a, a, indexing="ij")


def _degrees360(ty: torch.Tensor, tx: torch.Tensor) -> torch.Tensor:
    theta = torch.atan2(ty, tx) * (180.0 / math.pi)
    return torch.where(theta < 0, theta + 360.0, theta)


def _to_u8(bgr: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(bgr * 255.0), 0, 255).to(torch.uint8)


class VectorColorOut(NamedTuple):
    bgr_u8: torch.Tensor            # (H, W, 3) colorized flow
    max_displacement: torch.Tensor  # () new running max (for the next frame)


def vector_to_color(flow: torch.Tensor, max_displacement_prev,
                    rows: "tuple[int, int] | None" = None) -> VectorColorOut:
    """HSV encoding: H = angle/2, S = 255, V = mag * 255 / prev-frame max.
    rows=(i0, i1): colour only those rows of flow; the new max is still
    the whole flow's."""
    mag_all = torch.sqrt(torch.sum(flow * flow, dim=-1))
    cut = slice(*(rows or (0, None)))
    flow, mag = flow[cut], mag_all[cut]
    theta = _degrees360(flow[..., 1], flow[..., 0])
    hsv = torch.stack([
        torch.clamp(theta / 2.0, 0, 255),
        torch.full_like(theta, 255.0),
        torch.clamp(mag * 255.0 / torch.clamp(
            torch.as_tensor(max_displacement_prev, device=flow.device),
            min=1e-6), 0, 255),
    ], dim=-1).to(torch.uint8)
    return VectorColorOut(hsv_to_bgr(hsv),
                          torch.clamp(torch.max(mag_all), min=1e-6))


def polar_to_hsv_bgr(ang_deg: torch.Tensor, val01: torch.Tensor,
                     sat01: "torch.Tensor | None" = None) -> torch.Tensor:
    """Generic (angle, value) -> BGR u8 via float HSV, S defaulting to 1."""
    s = torch.ones_like(val01) if sat01 is None else sat01
    hsv = torch.stack([ang_deg, s, torch.clamp(val01, 0.0, 1.0)], dim=-1)
    return _to_u8(hsv_to_bgr(hsv.to(torch.float32)))


def histogram_wheel(upper2d: torch.Tensor, prop_above_upper: torch.Tensor,
                    p: HistogramParams = HistogramParams(),
                    size: int = 480) -> torch.Tensor:
    """A polar wheel where S=0 beyond each direction's UPPER2d radius and
    V=0 beyond prop_above_upper*10 -> (size, size, 3) uint8 BGR."""
    c = size / 2.0
    ys, xs = _grid(size, upper2d.device)
    tx = (xs - c) / c
    ty = (ys - c) / c
    theta = _degrees360(ty, tx)
    r = torch.sqrt(tx * tx + ty * ty)
    d = torch.clamp((theta * p.directions / 360.0).to(torch.int32),
                    0, p.directions - 1).long()
    hue = d.to(torch.float32) * (360.0 / p.directions)
    s = torch.where(r > upper2d[d] * p.resolution / p.bins, 0.0, 1.0)
    v = torch.where(r > prop_above_upper[d] * 10.0, 0.0, 1.0)
    return _to_u8(hsv_to_bgr(torch.stack([hue, s, v], dim=-1)))


def shear_color_chart(height: int = 40, width: int = 256,
                      device="cpu") -> torch.Tensor:
    """Legend bar of the shearRate mode: the hue ramp of
    analysis/shear.shear_to_color (hue byte 128 at zero shear down to 0 at
    the running max, S = V = 1), left to right increasing shear."""
    xs = _linspace01(width, device)
    hue = (128.0 - 128.0 * xs) * 2.0       # hue byte -> degrees
    hsv = torch.stack([hue.expand(height, width),
                       torch.ones((height, width), device=device),
                       torch.ones((height, width), device=device)], dim=-1)
    return _to_u8(hsv_to_bgr(hsv))


def color_wheel(size: int = 480, directions: int = 36,
                device="cpu") -> torch.Tensor:
    """The legend wheel (android jni/ripcurrents.cpp:31-70): hue quantized
    to `directions` sectors, S = radius, V = 1 inside the unit disc."""
    c = size / 2.0
    ys, xs = _grid(size, device)
    tx = (xs - c) / size
    ty = (ys - c) / size
    theta = _degrees360(ty, tx)
    bin_ = torch.clamp((theta / 360.0 * directions).to(torch.int32),
                       0, directions - 1)
    d = torch.sqrt(tx * tx + ty * ty)
    hue = bin_.to(torch.float32) * (360.0 / directions)
    s = torch.where(d > 1.0, 0.0, d)
    v = torch.where(d > 1.0, 0.0, 1.0)
    return _to_u8(hsv_to_bgr(torch.stack([hue, s, v], dim=-1)))
