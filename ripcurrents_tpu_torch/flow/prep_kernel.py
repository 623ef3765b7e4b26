"""The expansion prep of one Farneback pyramid level: kernels K5 (y pass)
and K6 (x3 pass with the five-channel combine), their wrappers and their
plain PyTorch versions.

Port of ``ripcurrents_tpu/flow/prep_pallas.py: poly_exp_level_pallas``
(``y_kernel`` and ``x_kernel``). Both passes apply the composed level-prep
matrices (``farneback._level_prep_matrices``: pre-smooth o pyramid resize
o expansion correlation, with the output canvas's zero pads) rounded to
bf16, to operands rounded to bf16, with float32 accumulation:

- y pass: t (3*ph, w) bf16 = by3^T (3*ph, h) . bf16(img (h, w));
- x3 pass: t's g / xg / xxg sections times the three x matrices
  (w, pw) -> b1..b6, combined with ig11 / ig03 / ig33 / ig55 into the
  five coefficient channels (ph, pw), stored in out_dtype, channels first
  or channels last.

The matrices are banded. The host takes from them, once per geometry,
each output row's (y pass) and each output column's (x pass) contiguous
source window [lo, lo + len) and its weights; all-zero rows and columns
(the canvas pads) get len 0. Each output is then one float32 accumulator
over its window in ascending source index. A product of two bf16 values is
exact in float32, so the sum's order is the only rounding choice, and the
plain versions sum in the same order: kernel (built with -fmad=false) and
plain version agree bit for bit.

On CUDA tensors each wrapper launches its kernel once and counts the
launch in ``<wrapper>.launches``; on CPU tensors it runs the plain
version.
"""

from __future__ import annotations

import numpy as np
import torch

from ripcurrents_tpu_torch import kernels


def _bf16_values(m: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (nearest, ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _windows(mats: list[np.ndarray]) -> tuple[np.ndarray, ...]:
    """Per-output windows of (n_out, n_src) matrices sharing their output
    axis: lo (n_out,) int32, len (n_out,) int32 spanning the union of the
    matrices' nonzeros, and weights (k, L, n_out) float32 with
    w[i, j, o] = mats[i][o, lo[o] + j] (zero past len[o]); L = max len."""
    n_out, n_src = mats[0].shape
    nz = np.zeros((n_out, n_src), bool)
    for m in mats:
        nz |= m != 0.0
    any_nz = nz.any(axis=1)
    lo = np.where(any_nz, nz.argmax(axis=1), 0)
    hi = np.where(any_nz, n_src - nz[:, ::-1].argmax(axis=1), 0)
    ln = hi - lo
    big = max(int(ln.max()), 1)
    wts = np.zeros((len(mats), big, n_out), np.float32)
    for o in range(n_out):
        for i, m in enumerate(mats):
            wts[i, :ln[o], o] = m[o, lo[o]:hi[o]]
    return lo.astype(np.int32), ln.astype(np.int32), wts


def band_windows(by3: np.ndarray, bx_g: np.ndarray, bx_xg: np.ndarray,
                 bx_xxg: np.ndarray) -> dict:
    """The windows of one level geometry, from the composed matrices of
    ``_level_prep_matrices`` (by3 (h, 3*ph), bx_* (w, pw)), each rounded
    to bf16 first: the y pass per output row of t, the x3 pass per output
    column, over the union of the three x matrices."""
    y_lo, y_len, wy = _windows([_bf16_values(by3).T])
    x_lo, x_len, wx = _windows([_bf16_values(m).T
                                for m in (bx_g, bx_xg, bx_xxg)])
    return {"y_lo": y_lo, "y_len": y_len, "wy": np.ascontiguousarray(wy[0].T),
            "x_lo": x_lo, "x_len": x_len, "wx": wx,
            "h": by3.shape[0], "w": bx_g.shape[0]}


def windows_on(win: dict, device: torch.device) -> dict:
    """The windows as tensors on `device` (wy (rows, Ly), wx (3, Lx, pw))."""
    return {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
                else v) for k, v in win.items()}


def _require(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# K5: the y pass
# ---------------------------------------------------------------------------

def prep_y_plain(img: torch.Tensor, lo: torch.Tensor,
                 wy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: t[r] = sum_j wy[r, j] * bf16(img)[lo[r]
    + j] in ascending j, float32 accumulation, stored as bf16. Past a
    row's window the weights are zero, and adding their zero products
    leaves the sum unchanged."""
    h = img.shape[0]
    v = img.to(torch.bfloat16).to(torch.float32)
    acc = torch.zeros((wy.shape[0], img.shape[1]), dtype=torch.float32,
                      device=img.device)
    lo = lo.long()
    for j in range(wy.shape[1]):
        src = torch.clamp(lo + j, max=h - 1)
        acc = acc + wy[:, j, None] * v[src]
    return acc.to(torch.bfloat16)


def prep_y(img: torch.Tensor, win: dict) -> torch.Tensor:
    """K5: the y pass of one level, img (h, w) float32 (the full-res frame)
    -> t (3*ph, w) bf16."""
    h, w = win["h"], win["w"]
    wy = win["wy"]
    rows, ly = wy.shape
    _require(img, "img", torch.float32, (h, w))
    if not kernels.launches_on(img.device):
        return prep_y_plain(img, win["y_lo"], wy)
    t = torch.empty((rows, w), dtype=torch.bfloat16, device=img.device)
    err = kernels.entry("prep_y")(
        img.data_ptr(), win["y_lo"].data_ptr(), win["y_len"].data_ptr(),
        wy.data_ptr(), t.data_ptr(), h, w, rows, ly,
        torch.cuda.current_stream(img.device).cuda_stream)
    kernels.check(err, "prep_y")
    prep_y.launches += 1
    return t


prep_y.launches = 0


# ---------------------------------------------------------------------------
# K6: the x3 pass and the combine
# ---------------------------------------------------------------------------

def prep_x3_plain(t: torch.Tensor, lo: torch.Tensor, wx: torch.Tensor,
                  ph: int, ig: tuple, out_dtype: torch.dtype,
                  channels_first: bool) -> torch.Tensor:
    """Plain PyTorch version of K6: the six x sums of every output (row r,
    column c) over c's window in ascending source index, then the combine
    -> (5, ph, pw) or (ph, pw, 5) in out_dtype."""
    ig11, ig03, ig33, ig55 = ig
    w = t.shape[1]
    pw = wx.shape[2]
    tf = t.to(torch.float32)
    t0, t1, t2 = tf[:ph], tf[ph:2 * ph], tf[2 * ph:]
    z = torch.zeros((ph, pw), dtype=torch.float32, device=t.device)
    b1, b2, b3, b4, b5, b6 = z, z, z, z, z, z
    lo = lo.long()
    for j in range(wx.shape[1]):
        src = torch.clamp(lo + j, max=w - 1)
        s0, s1, s2 = t0[:, src], t1[:, src], t2[:, src]
        g, xg, xxg = wx[0, j], wx[1, j], wx[2, j]
        b1 = b1 + s0 * g
        b3 = b3 + s1 * g
        b5 = b5 + s2 * g
        b2 = b2 + s0 * xg
        b6 = b6 + s1 * xg
        b4 = b4 + s0 * xxg
    out = torch.stack([b2 * ig11, b3 * ig11,
                       b1 * ig03 + b4 * ig33,
                       b1 * ig03 + b5 * ig33,
                       b6 * ig55], dim=0 if channels_first else -1)
    return out.to(out_dtype)


def prep_x3(t: torch.Tensor, win: dict, ph: int, ig: tuple,
            out_dtype: torch.dtype, channels_first: bool) -> torch.Tensor:
    """K6: the x3 pass of one level and the five-channel combine, t
    (3*ph, w) bf16 -> (5, ph, pw) if channels_first else (ph, pw, 5), in
    out_dtype (bf16 or float32)."""
    wx = win["wx"]
    _, lx, pw = wx.shape
    w = win["w"]
    _require(t, "t", torch.bfloat16, (3 * ph, w))
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"prep_x3: out_dtype {out_dtype} is neither bf16 "
                         f"nor float32")
    if not kernels.launches_on(t.device):
        return prep_x3_plain(t, win["x_lo"], wx, ph, ig, out_dtype,
                             channels_first)
    shape = (5, ph, pw) if channels_first else (ph, pw, 5)
    out = torch.empty(shape, dtype=out_dtype, device=t.device)
    err = kernels.entry("prep_x3")(
        t.data_ptr(), win["x_lo"].data_ptr(), win["x_len"].data_ptr(),
        wx.data_ptr(), out.data_ptr(), w, ph, pw, lx,
        *(float(v) for v in ig), int(out_dtype == torch.bfloat16),
        int(channels_first), torch.cuda.current_stream(t.device).cuda_stream)
    kernels.check(err, "prep_x3")
    prep_x3.launches += 1
    return out


prep_x3.launches = 0
