"""Pyramidal Lucas-Kanade sparse optical flow (port of
``ripcurrents_tpu/flow/lucas_kanade.py``).

Replaces every cv::calcOpticalFlowPyrLK call site of the reference, with
OpenCV's semantics: a pyramid of uint8 images built with pyrDown (5-tap
binomial, fixed-point rounding), Scharr 3x3 derivatives, per-level
iterative refinement with cv2's epsilon and oscillation stopping rules,
and the min-eigenvalue quality gate.

The pyramid and the derivative images are plain PyTorch ops, batched over
streams; the per-point tracking is kernel K3 (``flow/lk_kernel.py``,
``csrc/lk_track.cu``) on the card and its plain version on the CPU.
Streams and points are batch dimensions of one call: nothing here runs
streams one after another or splits the points into chunks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ripcurrents_tpu_torch.config import LKParams
from ripcurrents_tpu_torch.flow.lk_kernel import (_reflect101,  # noqa: F401
                                                  lk_track)
from ripcurrents_tpu_torch.ops.conv import sep_filter2d


class LKResult(NamedTuple):
    points: torch.Tensor   # (N, 2) or (B, N, 2) float32: new positions
    status: torch.Tensor   # (N,) or (B, N) bool: tracking succeeded
    err: torch.Tensor      # same shape, float32: min-eigenvalue measure


_BINOMIAL = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)
_SCHARR_SMOOTH = (3 / 32, 10 / 32, 3 / 32)
_SCHARR_DIFF = (-1.0, 0.0, 1.0)


def _pyr_down_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown on uint8 values held in float32: binomial blur +
    decimate, fixed-point rounding. (..., H, W) -> (..., ceil(H/2),
    ceil(W/2))."""
    x = sep_filter2d(img, _BINOMIAL, _BINOMIAL, border="reflect101")
    x = x[..., ::2, ::2]
    return torch.clamp(torch.floor(x + 0.5), 0, 255).contiguous()


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Image pyramid [level0 ... levelN] as float32 tensors holding u8
    values; img is (H, W) or (B, H, W)."""
    out = [img.to(torch.float32).contiguous()]
    for _ in range(levels):
        out.append(_pyr_down_u8(out[-1]))
    return out


def _scharr(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scharr 3x3 derivatives / 32 (intensity units per pixel)."""
    ix = sep_filter2d(img, _SCHARR_SMOOTH, _SCHARR_DIFF, border="replicate")
    iy = sep_filter2d(img, _SCHARR_DIFF, _SCHARR_SMOOTH, border="replicate")
    return ix, iy


def pyramid_levels(hw: tuple[int, int], p: LKParams) -> int:
    """The coarsest level index: p.levels, shrunk while a level would be
    smaller than the window (cv::buildOpticalFlowPyramid stops early)."""
    levels = p.levels
    while levels > 0 and (min(hw) >> levels) < max(p.win):
        levels -= 1
    return levels


def prepare(prev_img: torch.Tensor, next_img: torch.Tensor, p: LKParams):
    """The tracker's inputs from two (B, H, W) frames: (pyramid of prev,
    pyramid of next, Scharr (Ix, Iy) of each prev level), every level a
    contiguous (B, lh, lw) float32 tensor. Both frames go through one
    batched pyramid."""
    b = prev_img.shape[0]
    levels = pyramid_levels(tuple(prev_img.shape[-2:]), p)
    pyr = build_pyramid(torch.cat([prev_img, next_img]), levels)
    pyr_prev = [lv[:b] for lv in pyr]
    pyr_next = [lv[b:] for lv in pyr]
    derivs = [_scharr(lv) for lv in pyr_prev]
    return pyr_prev, pyr_next, derivs


def pyr_lk(prev_img: torch.Tensor, next_img: torch.Tensor, pts: torch.Tensor,
           p: LKParams = LKParams()) -> LKResult:
    """Track pts in (x, y) pixel coords from prev_img to next_img.

    One stream: prev_img / next_img (H, W), pts (N, 2). A batch of
    streams: (B, H, W) and (B, N, 2). The frames' device decides the
    route: CUDA tensors launch kernel K3 (and raise if it cannot be built
    or launched), CPU tensors run the plain version.

    status is in_bounds & final_ok & solvable at level 0: a point that
    fails the min-eigenvalue gate reports False, as cv2 and the TPU kernel
    report it (the JAX gather path leaves `solvable` out of its status)."""
    single = prev_img.dim() == 2
    if single:
        prev_img, next_img, pts = prev_img[None], next_img[None], pts[None]
    if prev_img.dim() != 3 or prev_img.shape != next_img.shape or \
            pts.dim() != 3 or pts.shape[0] != prev_img.shape[0] or \
            pts.shape[2] != 2:
        raise ValueError(f"pyr_lk: frames {tuple(prev_img.shape)} / "
                         f"{tuple(next_img.shape)}, points {tuple(pts.shape)}")
    if pts.device != prev_img.device or next_img.device != prev_img.device:
        raise ValueError("pyr_lk: frames and points on different devices")
    pyr_prev, pyr_next, derivs = prepare(prev_img, next_img, p)
    out, _ = lk_track(pyr_prev, pyr_next, derivs,
                      pts.to(torch.float32), p)
    res = LKResult(out[..., :2], out[..., 2] > 0.5, out[..., 3])
    if single:
        res = LKResult(*(t[0] for t in res))
    return res
