"""Rasterization of polylines, filled circles, arrows and the frame count
onto device images (port of ``ripcurrents_tpu/viz/draw.py``).

A segment is sampled at a fixed number of points, rounded to pixels and
scattered with the thickness offsets; invalid or off-image points go to a
sentinel row below the image that is cropped afterwards. All segments of
one call share one color, so their draw order does not change the result
and they are drawn in one scatter.
"""

from __future__ import annotations

import functools
import math

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
                  valid: torch.Tensor, color, thickness: int = 1,
                  band: "tuple[int, int] | None" = None) -> torch.Tensor:
    """Draw N segments p0[i] -> p1[i] ((N, 2) (x, y) float) where valid[i].
    band=(row0, frame_h): img is rows [row0, row0 + its height) of a
    frame_h-row frame, the points in frame coordinates; it gets the
    pixels of those rows that drawing on the whole frame sets."""
    row0, frame_h = band or (0, img.shape[0])
    t = _linspace01(_seg_samples(frame_h, img.shape[1]),
                    img.device)[None, :, None]
    pts = p0[:, None, :] * (1 - t) + p1[:, None, :] * t      # (N, S, 2)
    xs = torch.round(pts[..., 0]).to(torch.int32)
    ys = torch.round(pts[..., 1]).to(torch.int32) - row0
    v = valid[:, None].expand(xs.shape)
    for dy, dx in _thickness_offsets(thickness):
        img = _scatter_points(img, ys + int(dy), xs + int(dx), v, color)
    return img


def draw_polyline(img: torch.Tensor, pts: torch.Tensor, color,
                  thickness: int = 1,
                  valid: "torch.Tensor | None" = None,
                  band: "tuple[int, int] | None" = None) -> torch.Tensor:
    """Connect consecutive points of pts (N, 2); segment i is drawn when
    both of its endpoints are valid. `band` as ``draw_segments``."""
    if valid is None:
        valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    return draw_segments(img, pts[:-1], pts[1:], valid[:-1] & valid[1:],
                         color, thickness, band)


def draw_circles(img: torch.Tensor, centers: torch.Tensor, radius: int,
                 color, valid: "torch.Tensor | None" = None,
                 band: "tuple[int, int] | None" = None) -> torch.Tensor:
    """Filled circles at centers (N, 2) (x, y), rounded half to even.
    `band` as ``draw_segments``: img gets the pixels of its rows that
    drawing on the whole frame sets (a disc's pixels depend on its
    centre only, so the frame's height is not read)."""
    row0 = band[0] if band else 0
    if valid is None:
        valid = torch.ones(centers.shape[0], dtype=torch.bool,
                           device=centers.device)
    c = torch.round(centers).long()
    offs = torch.from_numpy(_disc_offsets(radius)).to(centers.device).long()
    ys = c[:, 1, None] + offs[None, :, 0] - row0
    xs = c[:, 0, None] + offs[None, :, 1]
    return _scatter_points(img, ys, xs, valid[:, None].expand(ys.shape),
                           color)


def blend(a_u8: torch.Tensor, b_u8: torch.Tensor, alpha: float,
          beta: float) -> torch.Tensor:
    """cv::addWeighted(a, alpha, b, beta, 0)."""
    out = a_u8.to(torch.float32) * alpha + b_u8.to(torch.float32) * beta
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def draw_arrows(img: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
                valid: torch.Tensor, color, thickness: int = 1,
                tip_frac: float = 0.4,
                band: "tuple[int, int] | None" = None) -> torch.Tensor:
    """cv::arrowedLine: the shaft and two tip barbs at 45 degrees. `band`
    as ``draw_segments``."""
    img = draw_segments(img, starts, ends, valid, color, thickness, band)
    d = ends - starts
    tip = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True)) * tip_frac
    ang = torch.atan2(d[:, 1], d[:, 0])
    for s in (math.pi / 4, -math.pi / 4):
        barb = ends - tip * torch.stack([torch.cos(ang + s),
                                         torch.sin(ang + s)], dim=-1)
        img = draw_segments(img, ends, barb, valid, color, thickness, band)
    return img


def paste(img: torch.Tensor, patch: torch.Tensor, y: int, x: int,
          band: "tuple[int, int] | None" = None) -> torch.Tensor:
    """Copy `patch` into img at (y, x), the start clamped so that the patch
    fits (the warpAffine legend placement, main.cpp:1161-1162).
    band=(row0, frame_h): img is rows [row0, row0 + its height) of a
    frame_h-row frame; the start is clamped by the frame, and img gets
    the patch's rows that fall in its band."""
    row0, frame_h = band or (0, img.shape[0])
    ph, pw = patch.shape[0], patch.shape[1]
    y = min(max(y, 0), frame_h - ph)
    x = min(max(x, 0), img.shape[1] - pw)
    lo, hi = max(y, row0), min(y + ph, row0 + img.shape[0])
    out = img.clone()
    if lo < hi:
        out[lo - row0:hi - row0, x:x + pw] = patch[lo - y:hi - y].to(
            img.dtype)
    return out


# A minimal 5x3 digit font for the frame count.
_DIGITS = [
    "111101101101111", "010110010010111", "111001111100111",
    "111001111001111", "101101111001001", "111100111001111",
    "111100111101111", "111001001001001", "111101111101111",
    "111101111001111",
]


@functools.lru_cache(maxsize=1)
def _digit_masks() -> np.ndarray:
    m = np.zeros((10, 5, 3), np.uint8)
    for d, s in enumerate(_DIGITS):
        m[d] = np.array([int(c) for c in s], np.uint8).reshape(5, 3)
    return m


def draw_frame_count(img: torch.Tensor, framecount, pos=(30, 30),
                     scale: int = 2, color=(250, 250, 250),
                     row0: int = 0) -> torch.Tensor:
    """drawFrameCount (ripcurrents_module.cpp:1198-1201): the frame number
    as light bitmap digits near (30, 30); img may be rows [row0, ...) of
    the frame `pos` is in."""
    dev = img.device
    masks = torch.from_numpy(np.kron(_digit_masks(),
                                     np.ones((scale, scale), np.uint8))).to(dev)
    fc = torch.as_tensor(framecount, dtype=torch.int32, device=dev)
    digits = torch.stack([(fc // 10000) % 10, (fc // 1000) % 10,
                          (fc // 100) % 10, (fc // 10) % 10, fc % 10]).long()
    shown = torch.stack([fc >= 10000, fc >= 1000, fc >= 100, fc >= 10,
                         torch.ones_like(fc, dtype=torch.bool)])
    x0, y0 = pos
    dh, dw = 5 * scale, 3 * scale
    ys = (torch.arange(dh, device=dev)[:, None] + y0 - row0).expand(dh, dw)
    for i in range(5):
        xs = (torch.arange(dw, device=dev)[None, :] + x0 +
              i * (dw + scale)).expand(dh, dw)
        on = (masks[digits[i]] > 0) & shown[i]
        img = _scatter_points(img, ys, xs, on, color)
    return img
