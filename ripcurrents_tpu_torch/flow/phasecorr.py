"""FFT phase correlation for translation estimation (port of
``ripcurrents_tpu/flow/phasecorr.py``; cv::phaseCorrelate in
compute_phaseCorrelate, main.cpp:1684-1775): Hann-windowed cross-power
spectrum over a beach ROI, the inverse FFT's peak refined by a 5x5
weighted centroid. The JAX package computes the FFTs with ``jnp.fft``
outside any kernel; here they are ``torch.fft`` (cuFFT on the card)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def hanning_window(h: int, w: int, device="cpu") -> torch.Tensor:
    """cv2.createHanningWindow: the separable sin(pi*i/(N-1)) taper (the
    square root of a Hann window per axis, so the two windowed inputs
    multiply to a true Hann in the correlation)."""
    wy = torch.sin(math.pi * torch.arange(h, dtype=torch.float32,
                                          device=device) / (h - 1))
    wx = torch.sin(math.pi * torch.arange(w, dtype=torch.float32,
                                          device=device) / (w - 1))
    return wy[:, None] * wx[None, :]


class PhaseCorrelateOut(NamedTuple):
    shift: torch.Tensor     # (2,) (dx, dy): src2's translation from src1
    response: torch.Tensor  # () peak response in [0, 1]


def phase_correlate(src1: torch.Tensor, src2: torch.Tensor,
                    window: "torch.Tensor | None" = None
                    ) -> PhaseCorrelateOut:
    """cv2.phaseCorrelate(src1, src2, window). The peak is the first
    maximum in row-major order (argmax), as in the JAX package."""
    a = src1.to(torch.float32)
    b = src2.to(torch.float32)
    if window is not None:
        a = a * window
        b = b * window
    cross = torch.conj(torch.fft.fft2(a)) * torch.fft.fft2(b)
    cross = cross / torch.clamp(torch.abs(cross), min=1e-20)
    corr = torch.fft.ifft2(cross).real

    h, w = corr.shape
    idx = torch.argmax(corr)
    py = idx // w
    px = idx % w
    # 5x5 weighted centroid around the peak (cv::weightedCentroid), in
    # coordinates unwrapped around the peak
    off = torch.arange(-2, 3, device=corr.device)
    oy, ox = py + off[:, None], px + off[None, :]
    vals = torch.clamp(corr[oy % h, ox % w], min=0.0)
    total = torch.clamp(vals.sum(), min=1e-20)
    cy = (vals * oy).sum() / total
    cx = (vals * ox).sum() / total
    # shifts beyond half the frame wrap to negative displacements
    cx = torch.where(cx > w / 2.0, cx - w, cx)
    cy = torch.where(cy > h / 2.0, cy - h, cy)
    return PhaseCorrelateOut(torch.stack([cx, cy]), corr[py, px])
