"""Dense pyramidal Lucas-Kanade flow: a tracked point at every pixel (port
of ``ripcurrents_tpu/flow/dense_lk.py``).

The reference's farnebackAndLkSpeedComparison runs cv2's sparse LK over a
full 640x480 pixel grid (ripcurrents_module.cpp:696-721, 307k points).
For a dense grid the per-point tracker's math becomes dense tensor ops:

- each pixel's window sums of derivative products are box filters, as
  banded matrix products (``torch.matmul``);
- the per-iteration J resampling at x + flow is one flow-conditioned warp,
  the tiled base + residual warp ``farneback._warp5_tiled`` (kernel K8,
  frame layout, one channel, on the card);
- the 2x2 solves and the epsilon / oscillation stopping rules of
  cv::calcOpticalFlowPyrLK run per pixel with convergence masks over a
  fixed count of iterations (converged pixels stop moving; there is no
  early exit, which would cost a host sync a level and change nothing).

Grid points sit at integer pixels, so the I-window sums are box filters.
Each iteration warps J by the window-MEAN flow and re-centres the estimate
on it, the dense analogue of the sparse tracker's rigid window; the output
is implicitly window-smoothed, which sharp motion boundaries feel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ripcurrents_tpu_torch.config import LKParams
from ripcurrents_tpu_torch.flow.farneback import (_banded_replicate, _grid,
                                                  _warp5_tiled)
from ripcurrents_tpu_torch.flow.lucas_kanade import (_scharr, build_pyramid,
                                                     pyramid_levels)
from ripcurrents_tpu_torch.ops.image import resize_bilinear


@functools.lru_cache(maxsize=64)
def _banded_zero(n: int, taps: tuple, device: torch.device) -> torch.Tensor:
    """(n, n) banded correlation matrix of a 1-D kernel with a zero
    border (out = B^T contracted with the input)."""
    k = np.asarray(taps, np.float32)
    half = (len(k) - 1) // 2
    b = np.zeros((n, n), np.float32)
    dst = np.arange(n)
    for i, kv in enumerate(k):
        src = dst - half + i
        ok = (src >= 0) & (src < n)
        b[src[ok], dst[ok]] += kv
    return torch.from_numpy(b).to(device)


def _box_zero(img: torch.Tensor, win: tuple[int, int]) -> torch.Tensor:
    """Window sum of an (H, W) image with a zero border (the sparse
    tracker's zero-padded derivative windows), as two banded products."""
    by = _banded_zero(img.shape[0], (1.0,) * win[1], img.device)
    bx = _banded_zero(img.shape[1], (1.0,) * win[0], img.device)
    return torch.matmul(torch.matmul(by.T, img), bx)


def _box_mean(a: torch.Tensor, by: torch.Tensor,
              bx: torch.Tensor) -> torch.Tensor:
    """Window mean of an (H, W, C) field with a replicate border ->
    contiguous (H, W, C), as two banded products."""
    h, w, c = a.shape
    t = torch.matmul(by.T, a.reshape(h, w * c)).reshape(h, w, c)
    return torch.matmul(bx.T, t).contiguous()


def dense_lk(prev: torch.Tensor, nxt: torch.Tensor,
             p: LKParams = LKParams.dense_grid(),
             warp_residual: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Flow (H, W, 2) and status (H, W) bool from tracking every pixel of
    the (H, W) frame `prev` into `nxt`.

    Per pixel as cv::calcOpticalFlowPyrLK (window sums, min-eigenvalue
    gate, stopping rules); J is resampled by the tiled warp (residual
    clamped to +-warp_residual) instead of an exact gather: p.max_iters
    warps per pyramid level."""
    h, w = prev.shape
    levels = pyramid_levels((h, w), p)
    pyr_i = build_pyramid(prev, levels)
    pyr_j = build_pyramid(nxt, levels)
    eps2 = min(max(p.eps, 0.0), 10.0) ** 2
    area = p.win[0] * p.win[1]
    kby = np.ones(p.win[1], np.float32) / np.float32(p.win[1])
    kbx = np.ones(p.win[0], np.float32) / np.float32(p.win[0])

    flow = None
    status = None
    for lvl in range(levels, -1, -1):
        i_img = pyr_i[lvl]
        j_tab = pyr_j[lvl][..., None]
        lh, lw = i_img.shape
        dev = i_img.device
        if flow is None:
            flow = torch.zeros((lh, lw, 2), dtype=torch.float32, device=dev)
        else:
            flow = resize_bilinear(flow, (lh, lw)) * 2.0

        ix, iy = _scharr(i_img)
        by = _banded_replicate(lh, tuple(float(v) for v in kby), dev)
        bx = _banded_replicate(lw, tuple(float(v) for v in kbx), dev)

        g11 = _box_zero(ix * ix, p.win)
        g12 = _box_zero(ix * iy, p.win)
        g22 = _box_zero(iy * iy, p.win)
        det = g11 * g22 - g12 * g12
        # OpenCV's 1/1024-scaled eigenvalue frame / window area (as the
        # sparse tracker)
        min_eig = ((g22 + g11 - torch.sqrt((g11 - g22) ** 2 + 4 * g12 ** 2))
                   / (2.0 * 1024.0 * area))
        solvable = (min_eig >= p.min_eig_threshold) & (det > 1e-12)
        inv_det = torch.where(det > 1e-12, 1.0 / det, 0.0)

        prev_delta = torch.full((lh, lw, 2), torch.inf, device=dev)
        done = ~solvable
        for _ in range(p.max_iters):
            flw = _box_mean(flow, by, bx)   # the rigid-window flow
            jw, inside = _warp5_tiled(j_tab, flw, bres=warp_residual)
            diff = torch.where(inside, jw[..., 0] - i_img, 0.0)
            b1 = _box_zero(diff * ix, p.win)
            b2 = _box_zero(diff * iy, p.win)
            dxx = (g12 * b2 - g22 * b1) * inv_det
            dyy = (g12 * b1 - g11 * b2) * inv_det
            delta = torch.stack([dxx, dyy], dim=-1)
            active = (~done & solvable & inside)[..., None]
            new_fl = torch.where(active, flw + delta, flow)
            converged = torch.sum(delta * delta, dim=-1) <= eps2
            oscillating = (
                (torch.abs(delta[..., 0] + prev_delta[..., 0]) < 0.01) &
                (torch.abs(delta[..., 1] + prev_delta[..., 1]) < 0.01))
            flow = torch.where(active & (oscillating & ~converged)[..., None],
                               new_fl - delta * 0.5, new_fl)
            done = done | ~inside | converged | oscillating
            prev_delta = torch.where(active, delta, prev_delta)
        if lvl == 0:
            ys, xs = _grid(lh, lw, dev)
            x1 = torch.floor(xs + flow[..., 0])
            y1 = torch.floor(ys + flow[..., 1])
            status = (solvable & (x1 >= 0) & (y1 >= 0) &
                      (x1 < lw - 1) & (y1 < lh - 1))
    return flow, status
