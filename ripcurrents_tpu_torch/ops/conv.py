"""Gaussian kernels, separable correlation and blurs with OpenCV border
semantics (port of ``ripcurrents_tpu/ops/conv.py``). The filters take
(H, W) images; ``gaussian_blur``, ``box_blur``, ``pyr_down`` and
``pad2d`` also take (H, W, C), spatial dims leading, as the JAX
functions do."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# OpenCV getGaussianKernel's fixed small kernels, used when sigma <= 0
# (cv::getGaussianKernel small_gaussian_tab).
_SMALL_GAUSSIAN = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}


@functools.lru_cache(maxsize=64)
def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """1-D Gaussian kernel matching cv::getGaussianKernel (float64, sums to 1)."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize]
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


_PAD_MODE = {"replicate": "replicate", "reflect101": "reflect"}


def _corr1d(x: torch.Tensor, k, dim: int) -> torch.Tensor:
    """Valid 1-D correlation along `dim` as a sum of shifted slices, taps
    in ascending order (the order of the JAX package's ``_corr1d``)."""
    n = len(k)
    out_len = x.shape[dim] - n + 1
    acc = None
    for i in range(n):
        term = x.narrow(dim, i, out_len) * float(k[i])
        acc = term if acc is None else acc + term
    return acc


def sep_filter2d(img: torch.Tensor, ky, kx,
                 border: str = "reflect101") -> torch.Tensor:
    """Separable correlation over the last two dims of a float (H, W) or
    (B, H, W) image, y pass first, as cv2.sepFilter2D with the given
    border ('reflect101' or 'replicate'). ky and kx are sequences of
    float32-representable taps."""
    ky = np.asarray(ky, np.float32)
    kx = np.asarray(kx, np.float32)
    ry, rx = (len(ky) - 1) // 2, (len(kx) - 1) // 2
    x = img.reshape((-1, 1) + tuple(img.shape[-2:]))
    x = F.pad(x, (rx, rx, ry, ry), mode=_PAD_MODE[border])
    x = _corr1d(_corr1d(x, ky, 2), kx, 3)
    return x.reshape(img.shape)


def pad2d(img: torch.Tensor, top: int, bottom: int, left: int, right: int,
          border: str) -> torch.Tensor:
    """Pad the two leading spatial dims of (H, W[, C]). border:
    'replicate' | 'reflect101' | 'constant' (zeros)."""
    if border == "constant":
        out = img.new_zeros((img.shape[0] + top + bottom,
                             img.shape[1] + left + right) +
                            tuple(img.shape[2:]))
        out[top:top + img.shape[0], left:left + img.shape[1]] = img
        return out
    mode = {"replicate": "edge", "reflect101": "reflect"}[border]
    for dim, pads in ((0, (top, bottom)), (1, (left, right))):
        idx = np.pad(np.arange(img.shape[dim]), pads, mode=mode)
        img = img.index_select(dim, torch.from_numpy(idx).to(img.device))
    return img


def _filter_hwc(img: torch.Tensor, ky, kx, border: str) -> torch.Tensor:
    """``sep_filter2d`` of an (H, W) or (H, W, C) image."""
    if img.ndim == 2:
        return sep_filter2d(img, ky, kx, border)
    return sep_filter2d(img.movedim(-1, 0), ky, kx, border).movedim(0, -1)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float,
                  border: str = "reflect101") -> torch.Tensor:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma) with default border."""
    k = gaussian_kernel(ksize, sigma)
    return _filter_hwc(img, k, k, border)


def box_blur(img: torch.Tensor, ksize: int, border: str = "replicate",
             normalize: bool = True) -> torch.Tensor:
    """ksize x ksize box filter (cv2.blur semantics with replicate
    border)."""
    k = np.full((ksize,), 1.0 / ksize if normalize else 1.0)
    return _filter_hwc(img, k, k, border)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown: blur with [1,4,6,4,1]/16 (reflect101), then take the
    even pixels. Output size is ((H+1)//2, (W+1)//2), as in OpenCV."""
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16.0
    return _filter_hwc(img, k, k, "reflect101")[::2, ::2]
