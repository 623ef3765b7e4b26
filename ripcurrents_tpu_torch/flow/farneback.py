"""Farneback dense optical flow on the fused level engine.

Port of the channels-first fused branch of ``ripcurrents_tpu/flow/
farneback.py``: per-level polynomial expansion straight from the full-res
frame (pre-smooth, pyramid resize and both expansion correlations composed
into dense matrices on the host in float64, applied as float32 matmuls on
operands rounded to bf16 as the TPU's blocked prep rounds them, and stored
as bf16 in the halo'd table layout), the per-level residual,
subcolumn and iteration schedule, and the coarse-to-fine pyramid with the
flow kept in the padded (2, Hp, Wp) layout across levels.

Conventions: images are (H, W) (uint8 or float), flow is (H, W, 2) with
channel 0 = dx (columns) and channel 1 = dy (rows), as OpenCV.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow.fused_update import (HALO_X, HALO_Y,
                                                     _row_tile, fused_level,
                                                     prepare_expansions)
from ripcurrents_tpu_torch.ops.conv import gaussian_kernel
from ripcurrents_tpu_torch.ops.image import (_linear_weights,
                                             resize_bilinear_cf_padded)


@functools.lru_cache(maxsize=16)
def _poly_exp_consts(n: int, sigma: float):
    """Gaussian applicability kernels and the inverse-Gram entries
    (ig11, ig03, ig33, ig55) the expansion coefficients depend on."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g

    gy = g[:, None]
    gx = g[None, :]
    w = gy * gx
    xs = x[None, :]
    ys = x[:, None]
    G = np.zeros((6, 6))
    G[0, 0] = w.sum()
    G[1, 1] = (w * xs * xs).sum()
    G[2, 2] = G[1, 1]
    G[3, 3] = (w * xs ** 4).sum()
    G[4, 4] = G[3, 3]
    G[5, 5] = (w * xs * xs * ys * ys).sum()
    G[0, 3] = G[3, 0] = G[0, 4] = G[4, 0] = G[1, 1]
    G[3, 4] = G[4, 3] = G[5, 5]
    invG = np.linalg.inv(G)
    ig11, ig03, ig33, ig55 = invG[1, 1], invG[0, 3], invG[3, 3], invG[5, 5]
    return (g.astype(np.float32), xg.astype(np.float32),
            xxg.astype(np.float32),
            float(ig11), float(ig03), float(ig33), float(ig55))


@functools.lru_cache(maxsize=32)
def _y_section_stride(ph: int) -> int:
    """Row stride of the g/xg/xxg sections of the stacked y-pass matrix:
    ph rounded up to a multiple of 128."""
    return -(-ph // 128) * 128


def _level_prep_matrices(h: int, w: int, lh: int, lw: int, n: int,
                         sigma: float, smooth_sz: int, blur_sigma: float,
                         ph: int, pw: int, pad_off: tuple[int, int]):
    """Compose (reflect-101 Gaussian pre-smooth at full res) o (bilinear
    level resize) o (expansion correlation, replicate border) into one y
    matrix (h, 3*ps) and three x matrices (w, pw), built in float64 on the
    host and returned as float32. The level lands at rows/cols
    [pad_off, pad_off + (lh, lw)) of a zero (ph, pw) canvas."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g

    kg = np.asarray(gaussian_kernel(smooth_sz, blur_sigma), np.float64)

    def blur_mat(size: int) -> np.ndarray:
        B = np.zeros((size, size))
        half = (len(kg) - 1) // 2
        for d in range(size):
            for i, kv in enumerate(kg):
                s = d - half + i
                while s < 0 or s >= size:   # reflect-101
                    s = -s if s < 0 else 2 * (size - 1) - s
                B[d, s] += kv
        return B

    def resize_mat(src: int, dst: int) -> np.ndarray:
        if src == dst:
            return np.eye(src)
        idx, wgt = _linear_weights(src, dst)
        R = np.zeros((dst, src))
        np.add.at(R, (np.repeat(np.arange(dst), 2), idx.reshape(-1)),
                  wgt.astype(np.float64).reshape(-1))
        return R

    def band_mat(size: int, k: np.ndarray) -> np.ndarray:
        """(dst, src) banded correlation with replicate border."""
        half = (len(k) - 1) // 2
        B = np.zeros((size, size))
        for i, kv in enumerate(k):
            src = np.clip(np.arange(size) - half + i, 0, size - 1)
            np.add.at(B, (np.arange(size), src), kv)
        return B

    oy, ox = pad_off

    def padded(m, rows, off):                    # embed at [off, off+lh)
        return np.pad(m, ((off, rows - off - m.shape[0]), (0, 0)))

    pre_y = resize_mat(h, lh) @ blur_mat(h)      # (lh, h)
    pre_x = resize_mat(w, lw) @ blur_mat(w)      # (lw, w)
    ph_s = _y_section_stride(ph)
    by3 = np.concatenate([padded(band_mat(lh, k) @ pre_y, ph_s, oy)
                          for k in (g, xg, xxg)], axis=0).T   # (h, 3*ph_s)
    bx_g = padded(band_mat(lw, g) @ pre_x, pw, ox).T          # (w, pw)
    bx_xg = padded(band_mat(lw, xg) @ pre_x, pw, ox).T
    bx_xxg = padded(band_mat(lw, xxg) @ pre_x, pw, ox).T
    return (by3.astype(np.float32), bx_g.astype(np.float32),
            bx_xg.astype(np.float32), bx_xxg.astype(np.float32))


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 tensor t with its values rounded to dtype."""
    return t.to(dtype).to(torch.float32)


@functools.lru_cache(maxsize=32)
def _prep_matrices_on(args: tuple, device: torch.device,
                      operand_dtype: torch.dtype):
    by3, bx_g, bx_xg, bx_xxg = _level_prep_matrices(*args)
    return tuple(_rounded(torch.from_numpy(np.ascontiguousarray(m)),
                          operand_dtype).to(device)
                 for m in (by3.T, bx_g, bx_xg, bx_xxg))


def poly_exp_level(img: torch.Tensor, lh: int, lw: int, n: int,
                   sigma: float, smooth_sz: int, blur_sigma: float,
                   pad_hw: tuple[int, int], pad_off: tuple[int, int],
                   out_dtype: torch.dtype,
                   operand_dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
    """Channels-first polynomial expansion (5, Ph, Pw) of one pyramid level
    from the full-res frame: float32 matmuls against the composed matrices,
    the level embedded at pad_off of a (Ph, Pw) zero canvas, cast to
    out_dtype (bf16 for the kernels' tables).

    The matrices, the frame and the y-pass result are rounded to
    operand_dtype before the matmuls. bf16 (the default) is what the TPU
    runs, its blocked prep with bf16 MXU inputs and f32 accumulation: the
    products of bf16 values are exact in f32, so only the summation order
    differs. float32 is the reference's dense CPU form
    (``_poly_exp_level_dense``). The matmuls stay float32 either way (the
    package switches TF32 off)."""
    h, w = img.shape
    ph, pw = pad_hw
    _, _, _, ig11, ig03, ig33, ig55 = _poly_exp_consts(n, sigma)
    args = (h, w, lh, lw, n, sigma, smooth_sz, blur_sigma, ph, pw,
            tuple(pad_off))
    by3t, bx_g, bx_xg, bx_xxg = _prep_matrices_on(args, img.device,
                                                  operand_dtype)
    ps = _y_section_stride(ph)
    t = _rounded(torch.matmul(by3t, _rounded(img.to(torch.float32),
                                             operand_dtype)),
                 operand_dtype)                             # (3*ps, w)
    t0, t1 = t[:ph], t[ps:ps + ph]
    tg = torch.matmul(t, bx_g)
    b1, b3, b5 = tg[:ph], tg[ps:ps + ph], tg[2 * ps:2 * ps + ph]
    txg = torch.matmul(torch.cat([t0, t1]), bx_xg)
    b2, b6 = txg[:ph], txg[ph:]
    b4 = torch.matmul(t0, bx_xxg)
    out = torch.stack([b2 * ig11, b3 * ig11,
                       b1 * ig03 + b4 * ig33,
                       b1 * ig03 + b5 * ig33,
                       b6 * ig55])
    return out.to(out_dtype)


def _level_geometry(h: int, w: int, p: FarnebackParams, k: int):
    scale = p.pyr_scale ** k
    lw = int(round(w * scale))
    lh = int(round(h * scale))
    sigma = (1.0 / scale - 1.0) * 0.5
    smooth_sz = max(int(round(sigma * 5)) | 1, 3)
    return scale, lh, lw, sigma, smooth_sz


def _check_params(p: FarnebackParams) -> None:
    if p.warp_impl != "fused" or p.poly_impl != "banded":
        raise ValueError("the PyTorch port implements the fused engine "
                         "only (warp_impl='fused', poly_impl='banded'); "
                         f"got {p.warp_impl!r}, {p.poly_impl!r}")


def farneback_precompute(frame: torch.Tensor,
                         p: FarnebackParams) -> tuple[torch.Tensor, ...]:
    """Per-level expansion tables of one frame, coarsest first, each
    (5, Hp + 2*HALO_Y, Wp + 2*HALO_X) bf16 with the level at
    (HALO_Y, HALO_X)."""
    _check_params(p)
    f = frame.to(torch.float32)
    h, w = f.shape
    out = []
    for k in range(p.levels, -1, -1):
        _, lh, lw, sigma, smooth_sz = _level_geometry(h, w, p, k)
        th = _row_tile(lh)
        pad_hw = (-(-lh // th) * th + 2 * HALO_Y,
                  -(-lw // 128) * 128 + 2 * HALO_X)
        out.append(poly_exp_level(f, lh, lw, p.poly_n, p.poly_sigma,
                                  smooth_sz, sigma, pad_hw=pad_hw,
                                  pad_off=(HALO_Y, HALO_X),
                                  out_dtype=torch.bfloat16))
    return tuple(out)


def _per_level(sched, k: int):
    """A schedule entry for level k: an int applies to every level, a
    tuple is indexed by level (finest first, last entry reused)."""
    return sched[min(k, len(sched) - 1)] if isinstance(sched, tuple) \
        else sched


def farneback_from_expansions(e0, e1, hw: tuple[int, int],
                              p: FarnebackParams) -> torch.Tensor:
    """Dense flow (h, w, 2) from two frames' expansion tables."""
    _check_params(p)
    h, w = hw
    wr = p.warp_residual
    subcol = p.warp_subcol
    it_sched = None
    if h * w >= p.warp_hires_px:
        if p.warp_residual_hires is not None:
            wr = p.warp_residual_hires
        if p.warp_subcol_hires is not None:
            subcol = p.warp_subcol_hires
        it_sched = p.iters_hires
    flow = None
    prev_true = None
    for idx, k in enumerate(range(p.levels, -1, -1)):
        _, lh, lw, _, _ = _level_geometry(h, w, p, k)
        bres_k = _per_level(wr, k)
        iters_k = p.iterations if it_sched is None \
            else _per_level(it_sched, k)
        # Every level runs at least one iteration (a schedule entry of 0
        # would otherwise leave the level's flow unrefined).
        iters_k = max(1, iters_k)
        th = _row_tile(lh)
        hp, wp = -(-lh // th) * th, -(-lw // 128) * 128
        if flow is None:
            flow = torch.zeros((2, hp, wp), dtype=torch.float32,
                               device=e0[idx].device)
        else:
            # The padded upsample embeds the crop, the zero pads and the
            # 1/pyr_scale rescale in its matrices.
            flow = resize_bilinear_cf_padded(flow, prev_true, (lh, lw),
                                             (hp, wp), 1.0 / p.pyr_scale)
        prev_true = (lh, lw)
        prep = prepare_expansions(e0[idx], e1[idx], th, hw=(lh, lw),
                                  subcol=subcol)
        flow = fused_level(prep, flow, p.winsize, p.gaussian, bres_k,
                           iters_k)
    return torch.movedim(flow[:, :h, :w], 0, -1)


def farneback_stream(prev_exp, nxt: torch.Tensor, p: FarnebackParams):
    """Streaming step: (previous frame's expansions, next frame) ->
    (flow, next frame's expansions). Carrying the expansions expands each
    frame once per stream."""
    nxt_exp = farneback_precompute(nxt, p)
    flow = farneback_from_expansions(prev_exp, nxt_exp, tuple(nxt.shape), p)
    return flow, nxt_exp
