"""Bilinear sampling and translation (port of ``ripcurrents_tpu/ops/
warp.py``): the warpAffine translation of the phase-correlation jitter
compensation (main.cpp:1740-1760)."""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                    border: str = "clamp") -> torch.Tensor:
    """Sample img (H, W[, C]) at float coordinates (xs, ys) of one shape.

    border='clamp': coordinates clamp to the edge (replicate);
    border='zero': samples outside the image are 0.
    Returns xs.shape [+ (C,)]."""
    h, w = img.shape[0], img.shape[1]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx, fy = xs - x0, ys - y0
    if img.dim() == 3:
        fx, fy = fx[..., None], fy[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def gather(yi, xi):
        v = img[torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1)]
        if border == "zero":
            inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            if img.dim() == 3:
                inb = inb[..., None]
            v = torch.where(inb, v, 0)
        return v

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def translate(img: torch.Tensor, dx, dy, border: str = "zero",
              rows: "tuple[int, int] | None" = None) -> torch.Tensor:
    """warpAffine with the translation [[1, 0, dx], [0, 1, dy]] and
    bilinear interpolation: output (x, y) samples the input at
    (x - dx, y - dy) (main.cpp:1753-1755). dx, dy: numbers or 0-d
    tensors. `rows` (i0, i1): only those output rows of the whole
    frame's translation, each pixel sampled from the whole `img` as
    the whole frame's is (its rows reach |dy| + 1 past the band)."""
    h, w = img.shape[0], img.shape[1]
    i0, i1 = rows or (0, h)
    ys, xs = torch.meshgrid(
        torch.arange(i0, i1, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device),
        indexing="ij")
    out = bilinear_sample(img.to(torch.float32), xs - dx, ys - dy,
                          border=border)
    if img.dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(img.dtype)
