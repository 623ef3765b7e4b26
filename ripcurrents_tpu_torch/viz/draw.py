"""Rasterization of polylines and filled circles onto device images (port
of the functions of ``ripcurrents_tpu/viz/draw.py`` that the legacy path
and the particle modes need).

A segment is sampled at a fixed number of points, rounded to pixels and
scattered with the thickness offsets; invalid or off-image points go to a
sentinel row below the image that is cropped afterwards. All segments of
one call share one color, so their draw order does not change the result
and they are drawn in one scatter.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _seg_samples(h: int, w: int) -> int:
    """Samples per segment: max(h, w) + 1 steps <= 1 px along the major
    axis of any fully visible segment."""
    return max(512, max(h, w) + 1)


@functools.lru_cache(maxsize=16)
def _thickness_offsets(thickness: int) -> np.ndarray:
    """Integer offsets of a disc of diameter `thickness` (1 -> single px)."""
    r = max((thickness - 1) / 2.0, 0.0)
    n = int(np.ceil(r))
    offs = [(dy, dx) for dy in range(-n, n + 1) for dx in range(-n, n + 1)
            if dy * dy + dx * dx <= max(r * r, 0.25)]
    return np.array(offs, np.int32)


@functools.lru_cache(maxsize=32)
def _disc_offsets(radius: int) -> np.ndarray:
    offs = [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if dy * dy + dx * dx <= radius * radius]
    return np.array(offs, np.int32)


def _linspace01(n: int, device) -> torch.Tensor:
    """n samples of [0, 1] rounded as jnp.linspace rounds them in float32:
    i / (n - 1), then exactly 1.0."""
    step = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    return torch.cat([step, torch.ones(1, dtype=torch.float32,
                                       device=device)])


def _scatter_points(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    valid: torch.Tensor, color) -> torch.Tensor:
    """img[y, x] = color for valid in-image points (ys/xs int, any shape)."""
    h, w = img.shape[0], img.shape[1]
    inb = valid & (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    flat = torch.where(inb, ys * w + torch.clamp(xs, 0, w - 1), h * w)
    rest = img.shape[2:]
    padded = torch.cat([img.reshape((h * w,) + rest),
                        torch.zeros((1,) + rest, dtype=img.dtype,
                                    device=img.device)])
    color = torch.as_tensor(color, dtype=img.dtype, device=img.device)
    padded = padded.index_put((flat.reshape(-1).long(),),
                              color.expand((flat.numel(),) + rest))
    return padded[:h * w].reshape(img.shape)


def draw_segments(img: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor,
                  valid: torch.Tensor, color,
                  thickness: int = 1) -> torch.Tensor:
    """Draw N segments p0[i] -> p1[i] ((N, 2) (x, y) float) where valid[i]."""
    t = _linspace01(_seg_samples(img.shape[0], img.shape[1]),
                    img.device)[None, :, None]
    pts = p0[:, None, :] * (1 - t) + p1[:, None, :] * t      # (N, S, 2)
    xs = torch.round(pts[..., 0]).to(torch.int32)
    ys = torch.round(pts[..., 1]).to(torch.int32)
    v = valid[:, None].expand(xs.shape)
    for dy, dx in _thickness_offsets(thickness):
        img = _scatter_points(img, ys + int(dy), xs + int(dx), v, color)
    return img


def draw_polyline(img: torch.Tensor, pts: torch.Tensor, color,
                  thickness: int = 1,
                  valid: "torch.Tensor | None" = None) -> torch.Tensor:
    """Connect consecutive points of pts (N, 2); segment i is drawn when
    both of its endpoints are valid."""
    if valid is None:
        valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    return draw_segments(img, pts[:-1], pts[1:], valid[:-1] & valid[1:],
                         color, thickness)


def draw_circles(img: torch.Tensor, centers: torch.Tensor, radius: int,
                 color, valid: "torch.Tensor | None" = None) -> torch.Tensor:
    """Filled circles at centers (N, 2) (x, y), rounded half to even."""
    if valid is None:
        valid = torch.ones(centers.shape[0], dtype=torch.bool,
                           device=centers.device)
    c = torch.round(centers).long()
    offs = torch.from_numpy(_disc_offsets(radius)).to(centers.device).long()
    ys = c[:, 1, None] + offs[None, :, 0]
    xs = c[:, 0, None] + offs[None, :, 1]
    return _scatter_points(img, ys, xs, valid[:, None].expand(ys.shape),
                           color)


def blend(a_u8: torch.Tensor, b_u8: torch.Tensor, alpha: float,
          beta: float) -> torch.Tensor:
    """cv::addWeighted(a, alpha, b, beta, 0)."""
    out = a_u8.to(torch.float32) * alpha + b_u8.to(torch.float32) * beta
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
