"""Gaussian kernels and separable correlation with OpenCV border
semantics (port of the functions of ``ripcurrents_tpu/ops/conv.py`` that
the legacy path and the LK pyramid need)."""

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
