"""Farneback dense optical flow: the fused level engine and the portable
engine.

Port of ``ripcurrents_tpu/flow/farneback.py``:

- per-level polynomial expansion straight from the full-res frame
  (pre-smooth, pyramid resize and both expansion correlations composed
  into banded matrices on the host in float64), applied by kernels K5 and
  K6 (``flow/prep_kernel.py``) to operands rounded to bf16 with float32
  accumulation, as the TPU's blocked prep rounds them: channels-first bf16
  in the halo'd table layout for the fused engine, channels-last float32
  for the portable engine;
- the fused engine (``warp_impl="fused"``): the per-level residual,
  subcolumn and iteration schedule of ``flow/fused_update.py``, with the
  flow kept in the padded (2, Hp, Wp) layout across levels;
- the portable engine (``warp_impl`` "gather", "shift", "pallas" or
  "tiled"): ``update_matrices`` (the "shift" and "pallas" warps are kernel
  K7, the "tiled" warp kernel K8, both in ``flow/warp_kernel.py``), the
  banded window blur ``_blur_m`` and the 2x2 solve ``_solve_flow`` as
  plain PyTorch, with channels-last flow resized between levels;
- ``poly_impl="shifted"``: the expansion as the reference sequences it
  (reflect-101 Gaussian pre-smooth, pyramid resize, then the expansion
  correlations as shifted slice sums), float32 plain PyTorch;
- the stream entry points: ``farneback_stream``, its one-frame-lagged,
  chunked and multi-stream forms, which loop over the single-stream
  engine.

Conventions: images are (H, W) (uint8 or float), flow is (H, W, 2) with
channel 0 = dx (columns) and channel 1 = dy (rows), as OpenCV.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ripcurrents_tpu_torch import kernels
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import prep_kernel
from ripcurrents_tpu_torch.flow.fused_update import (HALO_X, HALO_Y,
                                                     _row_tile, fused_level,
                                                     prepare_expansions)
from ripcurrents_tpu_torch.flow.warp_kernel import (MAX_BASE, warp5_shift,
                                                    warp_tiles)
from ripcurrents_tpu_torch.ops.conv import gaussian_kernel
from ripcurrents_tpu_torch.ops.image import (_linear_weights,
                                             resize_bilinear,
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


def _level_prep_matrices(h: int, w: int, lh: int, lw: int, n: int,
                         sigma: float, smooth_sz: int, blur_sigma: float,
                         ph: int, pw: int, pad_off: tuple[int, int]):
    """Compose (reflect-101 Gaussian pre-smooth at full res) o (bilinear
    level resize) o (expansion correlation, replicate border) into one y
    matrix (h, 3*ph), its g, xg and xxg sections stacked, and three x
    matrices (w, pw), built in float64 on the host and returned as
    float32. The level lands at rows/cols [pad_off, pad_off + (lh, lw)) of
    a zero (ph, pw) canvas."""
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
    by3 = np.concatenate([padded(band_mat(lh, k) @ pre_y, ph, oy)
                          for k in (g, xg, xxg)], axis=0).T   # (h, 3*ph)
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


@functools.lru_cache(maxsize=32)
def _prep_windows_on(args: tuple, device: torch.device) -> dict:
    """K5/K6 windows of one level geometry on `device`."""
    return prep_kernel.windows_on(
        prep_kernel.band_windows(*_level_prep_matrices(*args),
                                 sms=kernels.card_sms(device)), device)


def poly_exp_level(img: torch.Tensor, lh: int, lw: int, n: int,
                   sigma: float, smooth_sz: int, blur_sigma: float,
                   channels_first: bool = False,
                   pad_hw: "tuple[int, int] | None" = None,
                   pad_off: tuple[int, int] = (0, 0),
                   out_dtype: "torch.dtype | None" = None) -> torch.Tensor:
    """Polynomial expansion of one pyramid level straight from the full-res
    frame img (h, w): K5 (y pass) then K6 (x3 pass and combine), or their
    plain versions for CPU tensors. pad_hw=(Ph, Pw) with pad_off=(oy, ox)
    embeds the level at rows [oy, oy+lh), cols [ox, ox+lw) of a zero
    (Ph, Pw) canvas. -> (5, Ph, Pw) if channels_first else (Ph, Pw, 5),
    in out_dtype (None: float32).

    The matrices and the frame are rounded to bf16, the sums accumulate in
    float32 and the y-pass result is stored as bf16, as the TPU's blocked
    prep and its Pallas kernels compute it."""
    h, w = img.shape
    ph, pw = pad_hw if pad_hw is not None else (lh, lw)
    _, _, _, ig11, ig03, ig33, ig55 = _poly_exp_consts(n, sigma)
    args = (h, w, lh, lw, n, sigma, smooth_sz, blur_sigma, ph, pw,
            tuple(pad_off))
    win = _prep_windows_on(args, img.device)
    t = prep_kernel.prep_y(img.to(torch.float32).contiguous(), win)
    return prep_kernel.prep_x3(t, win, ph, (ig11, ig03, ig33, ig55),
                               out_dtype or torch.float32, channels_first)


def poly_exp_level_dense(img: torch.Tensor, lh: int, lw: int, n: int,
                         sigma: float, smooth_sz: int, blur_sigma: float,
                         pad_hw: tuple[int, int], pad_off: tuple[int, int],
                         out_dtype: torch.dtype,
                         operand_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """Dense-matrix form of the channels-first ``poly_exp_level``: float32
    matmuls against the whole composed matrices, >95% of whose products
    are zeros. The yardstick chip_smoke.py times beside K5 + K6; the port
    never calls it on the card.

    The matrices, the frame and the y-pass result are rounded to
    operand_dtype before the matmuls. bf16 (the default) is what the TPU
    runs; float32 is the reference's dense CPU form. The matmuls stay
    float32 either way (the package switches TF32 off)."""
    h, w = img.shape
    ph, pw = pad_hw
    _, _, _, ig11, ig03, ig33, ig55 = _poly_exp_consts(n, sigma)
    args = (h, w, lh, lw, n, sigma, smooth_sz, blur_sigma, ph, pw,
            tuple(pad_off))
    by3t, bx_g, bx_xg, bx_xxg = _prep_matrices_on(args, img.device,
                                                  operand_dtype)
    t = _rounded(torch.matmul(by3t, _rounded(img.to(torch.float32),
                                             operand_dtype)),
                 operand_dtype)                             # (3*ph, w)
    t0, t1 = t[:ph], t[ph:2 * ph]
    tg = torch.matmul(t, bx_g)
    b1, b3, b5 = tg[:ph], tg[ph:2 * ph], tg[2 * ph:]
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


PORTABLE_WARPS = ("gather", "shift", "pallas", "tiled")
POLY_IMPLS = ("banded", "shifted")


def _check_params(p: FarnebackParams) -> None:
    if p.warp_impl not in ("fused",) + PORTABLE_WARPS or \
            p.poly_impl not in POLY_IMPLS:
        raise ValueError(
            f"unknown warp_impl {p.warp_impl!r} or poly_impl "
            f"{p.poly_impl!r}: warp_impl is 'fused' or one of "
            f"{PORTABLE_WARPS}, poly_impl one of {POLY_IMPLS}")


def _prep_level_args(h: int, w: int, p: FarnebackParams, k: int) -> tuple:
    """The prep geometry of pyramid level k of preset p at (h, w), as
    ``_level_prep_matrices`` takes it: for the fused engine the level at
    (HALO_Y, HALO_X) of its halo'd (Ph, Pw) canvas, for the portable
    engine the level alone."""
    _, lh, lw, sigma, smooth_sz = _level_geometry(h, w, p, k)
    if p.warp_impl == "fused":
        th = _row_tile(lh)
        ph = -(-lh // th) * th + 2 * HALO_Y
        pw = -(-lw // 128) * 128 + 2 * HALO_X
        off = (HALO_Y, HALO_X)
    else:
        ph, pw, off = lh, lw, (0, 0)
    return (h, w, lh, lw, p.poly_n, p.poly_sigma, smooth_sz, sigma, ph, pw,
            off)


# ---------------------------------------------------------------------------
# The "shifted" expansion: float32 shifted slice sums
# ---------------------------------------------------------------------------

def _corr1d_multi(img: torch.Tensor, kernels, axis: int) -> list:
    """Correlate a 2-D image with several 1-D kernels along one axis,
    replicate border, taps added in ascending order. Returns one (H, W)
    tensor per kernel."""
    n = (len(kernels[0]) - 1) // 2
    length = img.shape[axis]
    idx = torch.clamp(torch.arange(-n, length + n, device=img.device), 0,
                      length - 1)
    x = img.index_select(axis, idx)
    outs = []
    for k in kernels:
        acc = None
        for i, ki in enumerate(k):
            term = x.narrow(axis, i, length) * float(ki)
            acc = term if acc is None else acc + term
        outs.append(acc)
    return outs


def poly_exp(img: torch.Tensor, n: int, sigma: float,
             channels_first: bool = False,
             impl: str = "shifted") -> torch.Tensor:
    """Per-pixel quadratic expansion coefficients, channels [x, y, x^2,
    y^2, xy], of one image (H, W): (H, W, 5), or (5, H, W) if
    channels_first. Gaussian window half-size n. impl 'shifted': shifted
    slice sums; 'banded': the 1-D correlations as banded float32
    matmuls."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_consts(n, sigma)
    img = img.to(torch.float32)
    if impl == "banded":
        h, w = img.shape
        dev = img.device

        def band(size, k):
            return _banded_replicate(size, tuple(float(v) for v in k), dev)

        by3 = torch.cat([band(h, k) for k in (g, xg, xxg)], dim=1)
        t = torch.einsum("sn,sw->nw", by3, img)
        t0, t1, t2 = t[:h], t[h:2 * h], t[2 * h:]
        tg = torch.einsum("sn,hs->hn", band(w, g), torch.cat([t0, t1, t2]))
        b1, b3, b5 = tg[:h], tg[h:2 * h], tg[2 * h:]
        txg = torch.einsum("sn,hs->hn", band(w, xg), torch.cat([t0, t1]))
        b2, b6 = txg[:h], txg[h:]
        b4 = torch.einsum("sn,hs->hn", band(w, xxg), t0)
    elif impl == "shifted":
        t0, t1, t2 = _corr1d_multi(img, [g, xg, xxg], axis=0)
        b1, b2, b4 = _corr1d_multi(t0, [g, xg, xxg], axis=1)
        b3, b6 = _corr1d_multi(t1, [g, xg], axis=1)
        (b5,) = _corr1d_multi(t2, [g], axis=1)
    else:
        raise ValueError(f"unknown poly_exp impl {impl!r}")
    return torch.stack([b2 * ig11, b3 * ig11,
                        b1 * ig03 + b4 * ig33,
                        b1 * ig03 + b5 * ig33,
                        b6 * ig55], dim=0 if channels_first else -1)


def _gauss_blur_reflect(img: torch.Tensor, k) -> torch.Tensor:
    """Separable Gaussian blur with reflect-101 border (cv2 default): the
    y pass over the padded width, then the x pass, taps in ascending
    order."""
    k = [float(v) for v in np.asarray(k, np.float32)]
    n = (len(k) - 1) // 2
    h, w = img.shape

    def reflect(size):
        i = torch.arange(-n, size + n, device=img.device).abs()
        return torch.where(i > size - 1, 2 * (size - 1) - i, i)

    x = img[reflect(h)][:, reflect(w)]
    acc = None
    for i, kv in enumerate(k):
        t = x[i:i + h] * kv
        acc = t if acc is None else acc + t
    out = acc
    acc = None
    for i, kv in enumerate(k):
        t = out[:, i:i + w] * kv
        acc = t if acc is None else acc + t
    return acc


def _precompute_level(f: torch.Tensor, h: int, w: int, p: FarnebackParams,
                      k: int, cf: bool) -> torch.Tensor:
    """Level k of ``farneback_precompute`` from the float32 frame f."""
    _, lh, lw, sigma, smooth_sz = _level_geometry(h, w, p, k)
    if p.poly_impl == "banded":
        _, _, lh, lw, n, sig, ss, bs, ph, pw, off = _prep_level_args(h, w, p,
                                                                     k)
        return poly_exp_level(f, lh, lw, n, sig, ss, bs, channels_first=cf,
                              pad_hw=(ph, pw), pad_off=off,
                              out_dtype=torch.bfloat16 if cf else None)
    kg = np.asarray(gaussian_kernel(smooth_sz, sigma), np.float32)
    level_img = resize_bilinear(_gauss_blur_reflect(f, kg), (lh, lw))
    return poly_exp(level_img, p.poly_n, p.poly_sigma, channels_first=cf,
                    impl=p.poly_impl)


def farneback_precompute(frame: torch.Tensor,
                         p: FarnebackParams) -> tuple[torch.Tensor, ...]:
    """Per-level expansion tables of one frame, coarsest first. With
    poly_impl 'banded', for the fused engine (5, Hp + 2*HALO_Y,
    Wp + 2*HALO_X) bf16 with the level at (HALO_Y, HALO_X), for the
    portable engine (lh, lw, 5) float32; with 'shifted', (5, lh, lw) or
    (lh, lw, 5) float32 (the fused engine pads and casts it per level)."""
    _check_params(p)
    f = frame.to(torch.float32)
    h, w = f.shape
    cf = p.warp_impl == "fused"
    return tuple(_precompute_level(f, h, w, p, k, cf)
                 for k in range(p.levels, -1, -1))


# ---------------------------------------------------------------------------
# The portable engine: flow-conditioned matrix update, blur, solve
# ---------------------------------------------------------------------------

# Border down-weighting ramp (5 px), as OpenCV's FarnebackUpdateMatrices.
_BORDER_RAMP = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472, 1.0],
                        np.float32)


@functools.lru_cache(maxsize=32)
def _border_scale(h: int, w: int, device: torch.device) -> torch.Tensor:
    n = max(h, w)
    d = np.minimum(np.arange(n), np.arange(n)[::-1])
    bxy = _BORDER_RAMP[np.minimum(d, 5)]
    return torch.from_numpy(bxy[:h, None] * bxy[None, :w]).to(device)


def _grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")


def _warp5_gather(r1: torch.Tensor, flow: torch.Tensor):
    """Exact flow-conditioned bilinear resample of r1 (H, W, 5) by a
    gather (any displacement). Returns (samples, inside)."""
    h, w = r1.shape[0], r1.shape[1]
    ys, xs = _grid(h, w, r1.device)
    fx, fy = xs + flow[..., 0], ys + flow[..., 1]
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    inside = (x1 >= 0) & (y1 >= 0) & (x1 < w - 1) & (y1 < h - 1)
    ax = fx - x1
    ay = fy - y1
    x1i = torch.clamp(x1.to(torch.int32), 0, w - 2).long()
    y1i = torch.clamp(y1.to(torch.int32), 0, h - 2).long()
    a00 = ((1 - ax) * (1 - ay))[..., None]
    a01 = (ax * (1 - ay))[..., None]
    a10 = ((1 - ax) * ay)[..., None]
    a11 = (ax * ay)[..., None]
    r1s = (a00 * r1[y1i, x1i] + a01 * r1[y1i, x1i + 1] +
           a10 * r1[y1i + 1, x1i] + a11 * r1[y1i + 1, x1i + 1])
    return r1s, inside


def _warp5_shift_mask(h: int, w: int, flow: torch.Tensor, budget: int):
    """The validity mask of the shift warp: the sample lands inside the
    frame and |flow| <= budget on both axes. Returns (None, inside)."""
    ys, xs = _grid(h, w, flow.device)
    dx, dy = flow[..., 0], flow[..., 1]
    x1 = torch.floor(xs + dx)
    y1 = torch.floor(ys + dy)
    inside = ((x1 >= 0) & (y1 >= 0) & (x1 < w - 1) & (y1 < h - 1) &
              (torch.abs(dx) <= budget) & (torch.abs(dy) <= budget))
    return None, inside


def _warp5_tiled(r1: torch.Tensor, flow: torch.Tensor, bres: int = 6,
                 max_base: int = MAX_BASE, th: int = 64, tw: int = 256):
    """The tiled base + residual warp of r1 (H, W, C) by flow (H, W, 2),
    C in ``warp_kernel.CHANNELS``, kernel K8 in its frame layout: per
    (th, tw) tile the rounded mean of the tile's real-pixel flow, clamped
    to +-max_base, is the base; each pixel samples r1 (zero outside the
    frame) bilinearly at base + its residual clamped to +-bres. Returns
    (samples (H, W, C), inside): inside is the frame test of
    floor(x + flow) alone, with no residual test. Other channel counts
    raise ValueError."""
    h, w = r1.shape[0], r1.shape[1]
    r1s = warp_tiles(r1.contiguous(), flow.contiguous(), None, th, tw, bres,
                     max_base)
    ys, xs = _grid(h, w, flow.device)
    x1 = torch.floor(xs + flow[..., 0])
    y1 = torch.floor(ys + flow[..., 1])
    inside = (x1 >= 0) & (y1 >= 0) & (x1 < w - 1) & (y1 < h - 1)
    return r1s, inside


def update_matrices(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                    warp_budget: "int | None" = None,
                    warp_impl: str = "shift", warp_residual: int = 6,
                    warp_tile: tuple[int, int] = (64, 256)) -> torch.Tensor:
    """The per-pixel normal-equation channels M = (G11, G12, G22, h1, h2)
    (H, W, 5) from the expansions r0, r1 (H, W, 5) and the current flow
    (H, W, 2), r1 resampled at x + flow: by a gather when warp_budget is
    None or warp_impl is 'gather'; by the tiled warp K8 (base tiles
    warp_tile, residual +-warp_residual) for 'tiled'; else by the shift
    decomposition, K7 ('shift' and 'pallas', the JAX package's XLA and
    Pallas forms of one function, are both K7 here)."""
    h, w = r0.shape[0], r0.shape[1]
    if warp_budget is None or warp_impl == "gather":
        r1s, inside = _warp5_gather(r1, flow)
    elif warp_impl == "tiled":
        r1s, inside = _warp5_tiled(r1, flow, bres=warp_residual,
                                   th=warp_tile[0], tw=warp_tile[1])
    elif warp_impl in ("shift", "pallas"):
        r1s = warp5_shift(r1.contiguous(), flow.contiguous(), warp_budget)
        _, inside = _warp5_shift_mask(h, w, flow, warp_budget)
    else:
        raise ValueError(f"unported warp_impl {warp_impl!r}")
    dx, dy = flow[..., 0], flow[..., 1]

    # Where the warp lands outside the frame the second frame's sample
    # counts as zero: the linear terms fall to r0/2, the quadratic terms
    # to frame 0 alone.
    r2 = torch.where(inside, (r0[..., 0] - r1s[..., 0]) * 0.5,
                     r0[..., 0] * 0.5)
    r3 = torch.where(inside, (r0[..., 1] - r1s[..., 1]) * 0.5,
                     r0[..., 1] * 0.5)
    r4 = torch.where(inside, (r0[..., 2] + r1s[..., 2]) * 0.5, r0[..., 2])
    r5 = torch.where(inside, (r0[..., 3] + r1s[..., 3]) * 0.5, r0[..., 3])
    r6 = torch.where(inside, (r0[..., 4] + r1s[..., 4]) * 0.25,
                     r0[..., 4] * 0.5)

    # Fold the prior displacement back in so the solve yields total flow.
    r2 = r2 + r4 * dx + r6 * dy
    r3 = r3 + r6 * dx + r5 * dy

    scale = _border_scale(h, w, r0.device)
    r2, r3, r4, r5, r6 = (t * scale for t in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6,
                        (r4 + r5) * r6,
                        r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3,
                        r6 * r2 + r5 * r3], dim=-1)


def _solve_flow(m: torch.Tensor) -> torch.Tensor:
    """Per-pixel 2x2 solve of the blurred normal equations."""
    g11, g12, g22, h1, h2 = (m[..., i] for i in range(5))
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    fx = (g22 * h1 - g12 * h2) * idet
    fy = (g11 * h2 - g12 * h1) * idet
    return torch.stack([fx, fy], dim=-1)


@functools.lru_cache(maxsize=32)
def _banded_replicate(n: int, taps: tuple, device: torch.device
                      ) -> torch.Tensor:
    """(n, n) banded correlation matrix of a 1-D kernel with the replicate
    border folded into the band (out = B^T contracted with the input)."""
    k = np.asarray(taps, np.float32)
    half = (len(k) - 1) // 2
    b = np.zeros((n, n), np.float32)
    dst = np.arange(n)
    for i, kv in enumerate(k):
        src = np.clip(dst - half + i, 0, n - 1)
        np.add.at(b, (src, dst), kv)
    return torch.from_numpy(b).to(device)


def _blur_m(m: torch.Tensor, winsize: int, gaussian: bool) -> torch.Tensor:
    """Window sum of the matrix channels (H, W, 5): Gaussian (sigma =
    winsize/2*0.3) or box, replicate border, as two banded float32
    matmuls."""
    half = winsize // 2
    if gaussian:
        x = np.arange(-half, half + 1, dtype=np.float64)
        sig = max(half * 0.3, 1e-6)
        k = np.exp(-(x * x) / (2 * sig * sig))
        k = (k / k.sum()).astype(np.float32)
    else:
        k = np.full((2 * half + 1,), 1.0 / (2 * half + 1), np.float32)
    taps = tuple(float(v) for v in k)
    by = _banded_replicate(m.shape[0], taps, m.device)
    bx = _banded_replicate(m.shape[1], taps, m.device)
    t = torch.einsum("sn,swc->nwc", by, m)
    return torch.einsum("sn,hsc->hnc", bx, t)


def _per_level(sched, k: int):
    """A schedule entry for level k: an int applies to every level, a
    tuple is indexed by level (finest first, last entry reused)."""
    return sched[min(k, len(sched) - 1)] if isinstance(sched, tuple) \
        else sched


def _residual_schedule(h: int, w: int, p: FarnebackParams):
    """(residual budget, iteration schedule) of a frame of h x w: the
    hi-res overrides at >= warp_hires_px."""
    wr, it_sched = p.warp_residual, None
    if h * w >= p.warp_hires_px:
        if p.warp_residual_hires is not None:
            wr = p.warp_residual_hires
        it_sched = p.iters_hires
    return wr, it_sched


def _level_iters(p: FarnebackParams, it_sched, k: int) -> int:
    """Iterations of level k: every level runs at least one (a schedule
    entry of 0 would otherwise leave the level's flow unrefined)."""
    return max(1, p.iterations if it_sched is None
               else _per_level(it_sched, k))


def farneback_from_expansions(e0, e1, hw: tuple[int, int],
                              p: FarnebackParams,
                              init_flow: "torch.Tensor | None" = None,
                              channels_first: bool = False) -> torch.Tensor:
    """Dense flow (h, w, 2), or (2, h, w) if channels_first, from two
    frames' expansion tables. init_flow (h, w, 2), if given, is the
    starting flow, resized and scaled to the coarsest level."""
    _check_params(p)
    if p.warp_impl != "fused":
        flow = _portable_from_expansions(e0, e1, hw, p, init_flow)
        return torch.movedim(flow, -1, 0) if channels_first else flow
    h, w = hw
    wr, it_sched = _residual_schedule(h, w, p)
    subcol = p.warp_subcol
    if h * w >= p.warp_hires_px and p.warp_subcol_hires is not None:
        subcol = p.warp_subcol_hires
    flow = None
    prev_true = None
    for idx, k in enumerate(range(p.levels, -1, -1)):
        scale, lh, lw, _, _ = _level_geometry(h, w, p, k)
        bres_k = _per_level(wr, k)
        iters_k = _level_iters(p, it_sched, k)
        th = _row_tile(lh)
        hp, wp = -(-lh // th) * th, -(-lw // 128) * 128
        if flow is None and init_flow is not None:
            f0 = torch.movedim(resize_bilinear(
                init_flow.to(torch.float32), (lh, lw)) * scale, -1, 0)
            flow = F.pad(f0, (0, wp - lw, 0, hp - lh)).contiguous()
        elif flow is None:
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
    out = flow[:, :h, :w]
    return out if channels_first else torch.movedim(out, 0, -1)


def _adaptive_tile(lh: int, lw: int,
                   tile: tuple[int, int]) -> tuple[int, int]:
    """Shrink the tiled warp's base tile for small level images so the
    tile-mean base stays locally representative (>= ~4 tile rows, 2 tile
    columns); rows stay a multiple of 8 and columns of 128."""
    th, tw = tile
    th = min(th, max(8, (lh // 4) // 8 * 8))
    tw = min(tw, max(128, (lw // 2) // 128 * 128))
    return th, tw


def _portable_from_expansions(e0, e1, hw: tuple[int, int],
                              p: FarnebackParams,
                              init_flow: "torch.Tensor | None" = None
                              ) -> torch.Tensor:
    """The portable engine's pyramid loop: flow at its true (lh, lw, 2)
    shape, resized by 1/pyr_scale between levels; per level the update,
    then iterations x (blur, solve), updating again between them. The
    tiled warp takes each level's residual budget from warp_residual
    (warp_residual_hires at >= warp_hires_px) and its tile from
    ``_adaptive_tile``."""
    h, w = hw
    wr, it_sched = _residual_schedule(h, w, p)
    flow = None
    for idx, k in enumerate(range(p.levels, -1, -1)):
        scale, lh, lw, _, _ = _level_geometry(h, w, p, k)
        bres_k = _per_level(wr, k)
        iters_k = _level_iters(p, it_sched, k)
        r0, r1 = e0[idx], e1[idx]
        if flow is None and init_flow is not None:
            flow = resize_bilinear(init_flow.to(torch.float32),
                                   (lh, lw)) * scale
        elif flow is None:
            flow = torch.zeros((lh, lw, 2), dtype=torch.float32,
                               device=r0.device)
        else:
            flow = resize_bilinear(flow, (lh, lw)) * (1.0 / p.pyr_scale)
        tile = _adaptive_tile(lh, lw, p.warp_tile)
        m = update_matrices(r0, r1, flow, p.warp_budget, p.warp_impl,
                            bres_k, tile)
        for i in range(iters_k):
            flow = _solve_flow(_blur_m(m, p.winsize, p.gaussian))
            if i < iters_k - 1:
                m = update_matrices(r0, r1, flow, p.warp_budget,
                                    p.warp_impl, bres_k, tile)
    return flow


def farneback(prev: torch.Tensor, nxt: torch.Tensor, p: FarnebackParams,
              init_flow: "torch.Tensor | None" = None) -> torch.Tensor:
    """Dense flow from `prev` to `nxt`: (H, W) -> (H, W, 2) float32,
    starting from init_flow (H, W, 2) if given."""
    return farneback_from_expansions(farneback_precompute(prev, p),
                                     farneback_precompute(nxt, p),
                                     tuple(prev.shape), p, init_flow)


def farneback_stream(prev_exp, nxt: torch.Tensor, p: FarnebackParams,
                     init_flow: "torch.Tensor | None" = None,
                     channels_first: bool = False):
    """Streaming step: (previous frame's expansions, next frame) ->
    (flow, next frame's expansions). Carrying the expansions expands each
    frame once per stream. channels_first=True returns flow as
    (2, h, w)."""
    nxt_exp = farneback_precompute(nxt, p)
    flow = farneback_from_expansions(prev_exp, nxt_exp, tuple(nxt.shape), p,
                                     init_flow, channels_first)
    return flow, nxt_exp


def farneback_stream_lagged(carry, frame: torch.Tensor, p: FarnebackParams,
                            channels_first: bool = False):
    """One-frame-lagged streaming step: carry = (expansions of frame t-1,
    expansions of frame t); feeding frame t+1 returns flow(t-1 -> t) and
    the carry advanced to (e_t, e_{t+1}). Start the carry with
    ``(farneback_precompute(f0, p), farneback_precompute(f1, p))``.

    On the TPU the lag lets the level kernel host the next frame's prep in
    idle matrix-unit cycles. That has no counterpart here: frame t+1 is
    expanded by the prep kernels (K5/K6 on the fused engine) as
    ``farneback_stream`` expands it, so each flow equals the
    ``farneback_stream`` flow of the same pair."""
    e_a, e_b = carry
    flow = farneback_from_expansions(e_a, e_b, tuple(frame.shape), p, None,
                                     channels_first)
    return flow, (e_b, farneback_precompute(frame, p))


def farneback_stream_chunk(prev_exp, frames: torch.Tensor,
                           p: FarnebackParams,
                           channels_first: bool = False):
    """Chunked streaming step: (expansions of frame t, frames t+1..t+B as
    (B, h, w)) -> (the B flows stacked, (B, h, w, 2) or (B, 2, h, w),
    expansions of frame t+B). The pair flows of one stream share only
    expansions, so this equals B ``farneback_stream`` steps."""
    hw = tuple(frames.shape[1:])
    flows = []
    exp = prev_exp
    for f in frames:
        nxt = farneback_precompute(f, p)
        flows.append(farneback_from_expansions(exp, nxt, hw, p, None,
                                               channels_first))
        exp = nxt
    return torch.stack(flows), exp


def _stack(items: list):
    """torch.stack over a list of like trees of tensors (tensors, None,
    tuples, named tuples, lists, dicts)."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    parts = [_stack(list(col)) for col in zip(*items)]
    return type(first)(*parts) if hasattr(first, "_fields") \
        else type(first)(parts)


def farneback_stream_multi(prev_exps, frames: torch.Tensor,
                           p: FarnebackParams, channels_first: bool = False,
                           consume=None, frame_map=None):
    """Multi-stream step: N independent streams advanced F frames each.
    prev_exps is the per-stream expansion carry stacked on a leading
    stream axis (each level's table (N, ...)); frames is (N, F, h, w).
    Returns (flows, new_exps): flows (N, F, h, w, 2) (or (N, F, 2, h, w)
    channels_first), or with `consume` (a per-frame reducer of the flow)
    its results stacked to (N, F, ...) instead; new_exps stacked like
    prev_exps. `frame_map`, if given, transforms each frame just before
    the engine. The streams run one after another through the
    single-stream engine, so every result equals stepping each stream by
    hand."""
    flows, new_exps = [], []
    for s in range(frames.shape[0]):
        exp = tuple(x[s] for x in prev_exps)
        outs = []
        for f in frames[s]:
            if frame_map is not None:
                f = frame_map(f)
            fl, exp = farneback_stream(exp, f, p,
                                       channels_first=channels_first)
            outs.append(fl if consume is None else consume(fl))
        flows.append(_stack(outs))
        new_exps.append(exp)
    return _stack(flows), _stack(new_exps)
