"""K3 ``lk_track``: the per-point pyramidal Lucas-Kanade tracker, its
wrapper and its plain PyTorch version.

Replaces the TPU kernel ``ripcurrents_tpu/flow/lk_pallas.py:
pyr_lk_pallas`` (``_kernel``), with the gather semantics of
``ripcurrents_tpu/flow/lucas_kanade.py: pyr_lk``: reflect-101 for the I and
J samples, zero outside the image for the derivative windows, no halo
freeze and no border clamp. Streams and points are grid dimensions: one
launch tracks every point of every stream through all pyramid levels.

The pyramid and the Scharr images are made by PyTorch ops before the
launch (``flow/lucas_kanade.py``); the kernel gets one pointer per level
and image. The plain version below repeats the kernel's arithmetic with
tensor indexing, batched over streams and points; it sums the windows in
another order than the kernel, so the two agree to a tolerance, not bit
for bit (a 2500-term sum in another order can flip a convergence test).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ripcurrents_tpu_torch import kernels
from ripcurrents_tpu_torch.config import LKParams

MAX_LEVELS = 8               # pyramid images a launch takes (kMaxLevels)
MAX_SHARED = 227 * 1024      # bytes of shared memory a Hopper block can use


def _reflect101(idx: torch.Tensor, n: int) -> torch.Tensor:
    """cv2 BORDER_REFLECT_101 of integer indices, any distance outside."""
    period = max(2 * (n - 1), 1)
    idx = idx.abs() % period
    return torch.where(idx >= n, period - idx, idx)


def _bilinear_patch(img: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                    fx: torch.Tensor, fy: torch.Tensor, win: tuple[int, int],
                    border_zero: bool) -> torch.Tensor:
    """Window patches (B, N, wy, wx) of img (B, h, w) at integer corners
    (x0, y0) (B, N) float + fractions (fx, fy).

    border_zero=True: samples outside the image are 0 (derivatives);
    False: reflect-101 coordinates (images)."""
    b, h, w = img.shape
    dev = img.device
    oy = torch.arange(win[1], device=dev)[:, None]
    ox = torch.arange(win[0], device=dev)[None, :]
    # Corners far outside (or NaN) are masked by the caller; the clamp only
    # keeps the integer conversion defined.
    xi0 = torch.nan_to_num(x0).clamp(-1e9, 1e9).long()[..., None, None] + ox
    yi0 = torch.nan_to_num(y0).clamp(-1e9, 1e9).long()[..., None, None] + oy
    flat = img.reshape(b, h * w)

    def tap(dy, dx, wgt):
        yi, xi = yi0 + dy, xi0 + dx
        if border_zero:
            inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        else:
            idx = _reflect101(yi, h) * w + _reflect101(xi, w)
        v = torch.gather(flat, 1, idx.reshape(b, -1)).reshape(idx.shape)
        if border_zero:
            v = torch.where(inb, v, 0.0)
        return v * wgt[..., None, None]

    return (tap(0, 0, (1 - fx) * (1 - fy)) + tap(0, 1, fx * (1 - fy)) +
            tap(1, 0, (1 - fx) * fy) + tap(1, 1, fx * fy))


def _eps2(p: LKParams) -> float:
    return min(max(p.eps, 0.0), 10.0) ** 2


def lk_track_plain(pyr_prev, pyr_next, derivs, pts: torch.Tensor,
                   p: LKParams):
    """Plain PyTorch version of K3. pyr_prev / pyr_next: per-level images
    (B, lh, lw) f32, finest first; derivs: per-level (Ix, Iy) of pyr_prev;
    pts (B, N, 2) f32. -> (out (B, N, 4) f32: x, y, status, err;
    iterations (B, N) int32: J windows sampled, over all levels)."""
    levels = len(pyr_prev) - 1
    wx, wy = p.win
    dev = pts.device
    half = torch.tensor([(wx - 1) * 0.5, (wy - 1) * 0.5],
                        dtype=torch.float32, device=dev)
    eps2 = _eps2(p)
    pts = pts.to(torch.float32)
    next_pt = pts / (2.0 ** levels)
    iters = torch.zeros(pts.shape[:2], dtype=torch.int32, device=dev)
    for lvl in range(levels, -1, -1):
        i_img, j_img = pyr_prev[lvl], pyr_next[lvl]
        ix_img, iy_img = derivs[lvl]
        lh, lw = i_img.shape[-2:]

        def inside(ix, iy):
            return (ix >= -wx) & (ix < lw) & (iy >= -wy) & (iy < lh)

        prev_pt = pts / (2.0 ** lvl) - half
        if lvl != levels:
            next_pt = next_pt * 2.0
        npt = next_pt - half
        ipx, ipy = torch.floor(prev_pt[..., 0]), torch.floor(prev_pt[..., 1])
        in_bounds = inside(ipx, ipy)
        fx, fy = prev_pt[..., 0] - ipx, prev_pt[..., 1] - ipy
        i_patch = _bilinear_patch(i_img, ipx, ipy, fx, fy, p.win, False)
        ix_patch = _bilinear_patch(ix_img, ipx, ipy, fx, fy, p.win, True)
        iy_patch = _bilinear_patch(iy_img, ipx, ipy, fx, fy, p.win, True)
        a11 = (ix_patch * ix_patch).sum(dim=(-2, -1))
        a12 = (ix_patch * iy_patch).sum(dim=(-2, -1))
        a22 = (iy_patch * iy_patch).sum(dim=(-2, -1))
        det = a11 * a22 - a12 * a12
        # OpenCV's 1/1024 fixed-point frame, divided by the window area.
        min_eig = ((a22 + a11 - torch.sqrt((a11 - a22) * (a11 - a22) +
                                           4 * (a12 * a12)))
                   / (2.0 * 1024.0 * wx * wy))
        # A window wholly outside the image has zero derivatives.
        min_eig = torch.where(in_bounds, min_eig, 0.0)
        solvable = (min_eig >= p.min_eig_threshold) & (det > 1e-12) & \
            in_bounds
        inv_det = torch.where(det > 1e-12, 1.0 / det, 0.0)

        prev_delta = torch.full_like(npt, float("inf"))
        done = ~solvable
        for _ in range(p.max_iters):
            if bool(done.all()):
                break
            inx, iny = torch.floor(npt[..., 0]), torch.floor(npt[..., 1])
            ok = inside(inx, iny)
            gx, gy = npt[..., 0] - inx, npt[..., 1] - iny
            j_patch = _bilinear_patch(j_img, inx, iny, gx, gy, p.win, False)
            diff = j_patch - i_patch
            b1 = (diff * ix_patch).sum(dim=(-2, -1))
            b2 = (diff * iy_patch).sum(dim=(-2, -1))
            delta = torch.stack([(a12 * b2 - a22 * b1) * inv_det,
                                 (a12 * b1 - a11 * b2) * inv_det], dim=-1)
            step_ok = ok & ~done
            iters = iters + step_ok.to(torch.int32)
            new_pt = torch.where(step_ok[..., None], npt + delta, npt)
            converged = (delta * delta).sum(dim=-1) <= eps2
            osc = ((delta[..., 0] + prev_delta[..., 0]).abs() < 0.01) & \
                  ((delta[..., 1] + prev_delta[..., 1]).abs() < 0.01)
            new_pt = torch.where((step_ok & osc & ~converged)[..., None],
                                 new_pt - delta * 0.5, new_pt)
            prev_delta = torch.where(step_ok[..., None], delta, prev_delta)
            done = done | ~ok | converged | osc
            npt = new_pt
        next_pt = npt + half
        if lvl == 0:
            final_ok = inside(torch.floor(npt[..., 0]),
                              torch.floor(npt[..., 1]))
            status = in_bounds & final_ok & solvable
            err = min_eig
    out = torch.cat([next_pt, status.to(torch.float32)[..., None],
                     err[..., None]], dim=-1)
    return out, iters


def _pointer_array(tensors):
    return (ctypes.c_void_p * MAX_LEVELS)(
        *[t.data_ptr() for t in tensors],
        *([None] * (MAX_LEVELS - len(tensors))))


def lk_track(pyr_prev, pyr_next, derivs, pts: torch.Tensor, p: LKParams):
    """K3: track pts (B, N, 2) f32 through the pyramid (see
    lk_track_plain for the arguments and the result). On CUDA tensors one
    launch of the kernel, one thread block per (stream, point); on CPU
    tensors the plain version."""
    dev = pts.device
    nlev = len(pyr_prev)
    b, n = pts.shape[:2]
    if pts.dtype != torch.float32 or pts.dim() != 3 or pts.shape[2] != 2:
        raise ValueError(f"pts: expected float32 (B, N, 2), got {pts.dtype} "
                         f"{tuple(pts.shape)}")
    if not 1 <= nlev <= MAX_LEVELS or len(pyr_next) != nlev or \
            len(derivs) != nlev:
        raise ValueError(f"bad pyramid: {nlev} levels")
    images = [list(pyr_prev), list(pyr_next), [d[0] for d in derivs],
              [d[1] for d in derivs]]
    for group in images:
        for ref, t in zip(pyr_prev, group):
            if t.dtype != torch.float32 or t.device != dev or \
                    tuple(t.shape) != (b,) + tuple(ref.shape[1:]) or \
                    not t.is_contiguous():
                raise ValueError(
                    f"level image: expected contiguous float32 "
                    f"{(b,) + tuple(ref.shape[1:])} on {dev}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    if not kernels.launches_on(dev):
        return lk_track_plain(pyr_prev, pyr_next, derivs, pts, p)
    wx, wy = p.win
    shared = 3 * wx * wy * 4
    if shared > MAX_SHARED - 1024 or b > 65535 or n == 0:
        raise ValueError(f"lk_track: window {p.win} needs {shared} B of "
                         f"shared memory, streams {b}, points {n}")
    pts = pts.contiguous()
    out = torch.empty((b, n, 4), dtype=torch.float32, device=dev)
    iters = torch.empty((b, n), dtype=torch.int32, device=dev)
    _i = ctypes.c_int * MAX_LEVELS
    pad = [0] * (MAX_LEVELS - nlev)
    err = kernels.entry("lk_track")(
        *[_pointer_array(g) for g in images],
        _i(*[t.shape[1] for t in pyr_prev], *pad),
        _i(*[t.shape[2] for t in pyr_prev], *pad),
        nlev, pts.data_ptr(), out.data_ptr(), iters.data_ptr(), b, n, wx, wy,
        p.max_iters, float(np.float32(_eps2(p))),
        float(np.float32(p.min_eig_threshold)),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "lk_track")
    lk_track.launches += 1
    return out, iters


lk_track.launches = 0
