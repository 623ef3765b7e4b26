"""Gaussian kernels with OpenCV semantics (port of the one function of
``ripcurrents_tpu/ops/conv.py`` that the legacy path needs)."""

from __future__ import annotations

import functools

import numpy as np

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
