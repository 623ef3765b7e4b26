"""Shear-rate analysis (port of ``ripcurrents_tpu/analysis/shear.py``;
shearRateToColor, ripcurrents_module.cpp:1059-1138): central differences
of the flow at +-offset give the 2x2 velocity-gradient Jacobian, whose
Frobenius norm drives the hue."""

from __future__ import annotations

from typing import NamedTuple

import torch

OFFSET = 10   # rows and columns between the differenced samples


def shear_frobenius(flow: torch.Tensor, offset: int = OFFSET,
                    band: "tuple[int, int] | None" = None) -> torch.Tensor:
    """(H, W) Frobenius norm of [[dvx/dx, dvx/dy], [dvy/dx, dvy/dy]] from
    right-left and above-below differences at +-offset (not divided by
    2*offset, as the reference), zero outside the interior.

    band=(row0, frame_h): flow is rows [row0, row0 + its height) of a
    frame_h-row frame, and the interior is the frame's. A row whose
    neighbours at +-offset lie in flow equals the whole frame's row bit
    for bit; a band with `offset` rows of the frame on each side (fewer
    at the frame's edges) gives the band's rows exactly."""
    right = torch.roll(flow, -offset, dims=1)
    left = torch.roll(flow, offset, dims=1)
    above = torch.roll(flow, offset, dims=0)    # row - offset
    below = torch.roll(flow, -offset, dims=0)   # row + offset
    j00 = right[..., 0] - left[..., 0]
    j01 = above[..., 0] - below[..., 0]
    j10 = right[..., 1] - left[..., 1]
    j11 = above[..., 1] - below[..., 1]
    fn = torch.sqrt(j00 ** 2 + j01 ** 2 + j10 ** 2 + j11 ** 2)
    row0, h = band or (0, fn.shape[0])
    w = fn.shape[1]
    ys = torch.arange(row0, row0 + fn.shape[0], device=flow.device)[:, None]
    xs = torch.arange(w, device=flow.device)[None, :]
    interior = ((ys >= offset) & (ys < h - offset) &
                (xs >= offset) & (xs < w - offset))
    return torch.where(interior, fn, 0.0)


class ShearColorOut(NamedTuple):
    hsv_u8: torch.Tensor         # (H, W, 3) uint8, H = 128 - fn*128/max
    max_frobenius: torch.Tensor  # () new running max for the next frame


def shear_to_color(flow: torch.Tensor, max_frobenius_prev,
                   offset: int = OFFSET, band: "tuple[int, int] | None" = None,
                   rows: "tuple[int, int] | None" = None) -> ShearColorOut:
    """The shear hue of ``shear_frobenius(flow, offset, band)`` and its
    maximum; rows=(i0, i1), frame rows inside flow's band: only those
    rows' (a space rank's band within its ring's slab)."""
    fn = shear_frobenius(flow, offset, band)
    if rows is not None:
        row0 = band[0] if band else 0
        fn = fn[rows[0] - row0:rows[1] - row0]
    prev = torch.as_tensor(max_frobenius_prev, device=flow.device)
    hue = 128.0 - fn * 128.0 / torch.clamp(prev, min=1e-6)
    hsv = torch.stack([torch.clamp(hue, 0, 255),
                       torch.full_like(hue, 255.0),
                       torch.full_like(hue, 255.0)], dim=-1).to(torch.uint8)
    return ShearColorOut(hsv, torch.clamp(torch.max(fn), min=1e-6))
