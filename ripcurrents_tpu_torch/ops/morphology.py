"""Binary/grayscale morphology as max/min stencils (port of
``ripcurrents_tpu/ops/morphology.py``; create_edges,
ripcurrents_module.cpp:216-220)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=16)
def ellipse_kernel(h: int, w: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (w, h)) as a bool mask
    (OpenCV's scanline ellipse fill)."""
    r, c = h // 2, w // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    mask = np.zeros((h, w), bool)
    for i in range(h):
        j = i - r
        if abs(j) <= r:
            if r > 0:
                dx = int(round(c * np.sqrt(max(0.0, 1.0 - j * j * inv_r2))))
            else:
                dx = c
            x1, x2 = max(c - dx, 0), min(c + dx, w - 1)
            mask[i, x1:x2 + 1] = True
    return mask


def _morph(img: torch.Tensor, kernel: np.ndarray, op: str) -> torch.Tensor:
    """Dilate ('max') or erode ('min') an (H, W) image by a flat
    structuring element; outside the image counts as the dtype's least
    value for dilation and its greatest for erosion (0 / 255 for uint8,
    -inf / inf for floats)."""
    kh, kw = kernel.shape
    ry, rx = kh // 2, kw // 2
    lo, hi = (0, 255) if img.dtype == torch.uint8 else \
        (-float("inf"), float("inf"))
    pad_val = lo if op == "max" else hi
    x = F.pad(img[None], (rx, rx, ry, ry), value=pad_val)[0]
    h, w = img.shape
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            if not kernel[dy, dx]:
                continue
            sl = x[dy:dy + h, dx:dx + w]
            if acc is None:
                acc = sl
            else:
                acc = torch.maximum(acc, sl) if op == "max" \
                    else torch.minimum(acc, sl)
    return acc


def dilate(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    return _morph(img, kernel, "max")


def erode(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    return _morph(img, kernel, "min")


def morph_gradient(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """cv2.morphologyEx op #4: dilation - erosion."""
    return dilate(img, kernel) - erode(img, kernel)


# Rows beyond a pixel that rip_edges reads: two passes of a 5x5 element.
EDGE_HALO = 4


def rip_edges(mask_u8: torch.Tensor, above: "torch.Tensor | None" = None,
              below: "torch.Tensor | None" = None) -> torch.Tensor:
    """create_edges: dilate with a 5x5 ellipse, then the morphological
    gradient (dilation - erosion) with the same element. For a row band
    of the frame, `above` / `below` are the EDGE_HALO frame rows next to
    it (None at the frame's edge, where the frame's border rule holds):
    the band's edges then equal those rows of the whole frame's."""
    k = ellipse_kernel(5, 5)
    if above is None and below is None:
        return morph_gradient(dilate(mask_u8, k), k)
    x = torch.cat([t for t in (above, mask_u8, below) if t is not None])
    top = 0 if above is None else above.shape[0]
    return morph_gradient(dilate(x, k), k)[top:top + mask_u8.shape[0]]
