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

The kernels tile the level's nonzero region and stage what a tile reads
in shared memory; the host plans the tiles once per geometry
(``y_plan``, ``x_plan``, kept in the windows' dict). A kernel thread
sums over the union of the windows it shares a staged span with: the
plan widens each window to that union, aligned to four source indices,
and gives the widened taps weight zero. A zero product added to a float32
sum leaves it unchanged (the sum starts at +0, and +0 + -0 is +0), so the
widened sum equals the plain version's bit for bit.

On CUDA tensors each wrapper launches its kernel once and counts the
launch in ``<wrapper>.launches``; on CPU tensors it runs the plain
version.
"""

from __future__ import annotations

import numpy as np
import torch

from ripcurrents_tpu_torch import kernels

# The warps a launch should give each SM before a thread takes two
# columns (fewer warps, fewer loads per product); plans made off the card
# count the H100's SMs.
WARPS_PER_SM = 16
# K5: level rows per block (one warp each); K6: rows per tile (one lane
# each), column groups per block (one warp each); K6's pad-zeroing blocks
# take ZERO_ROWS canvas rows each. The kernels are built with these
# numbers (``kernels.DEFINES``).
Y_WARPS = kernels.DEFINES["prep_y"]["PREP_Y_WARPS"]
X_ROWS = kernels.DEFINES["prep_x3"]["PREP_X_ROWS"]
X_WARPS = kernels.DEFINES["prep_x3"]["PREP_X_WARPS"]
ZERO_ROWS = kernels.DEFINES["prep_x3"]["PREP_X_ZERO_ROWS"]


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
                 bx_xxg: np.ndarray, sms: int = kernels.H100_SMS) -> dict:
    """The windows of one level geometry, from the composed matrices of
    ``_level_prep_matrices`` (by3 (h, 3*ph), bx_* (w, pw)), each rounded
    to bf16 first: the y pass per output row of t, the x3 pass per output
    column, over the union of the three x matrices."""
    y_lo, y_len, wy = _windows([_bf16_values(by3).T])
    x_lo, x_len, wx = _windows([_bf16_values(m).T
                                for m in (bx_g, bx_xg, bx_xxg)])
    win = {"y_lo": y_lo, "y_len": y_len, "wy": np.ascontiguousarray(wy[0].T),
           "x_lo": x_lo, "x_len": x_len, "wx": wx,
           "h": by3.shape[0], "w": bx_g.shape[0]}
    win.update(y_plan(win, sms))
    win.update(x_plan(win, sms))
    return win


# ---------------------------------------------------------------------------
# Tile plans of K5 and K6 (host, once per geometry)
# ---------------------------------------------------------------------------

def _up(v, m):
    return -(-v // m) * m


def _fits(shared: int, what: str) -> int:
    if shared > kernels.MAX_SHARED:
        raise ValueError(f"{what}: a tile needs {shared} bytes of shared "
                         f"memory, over the block's {kernels.MAX_SHARED}")
    return shared


def _nonzero_range(mask: np.ndarray, what: str) -> tuple[int, int]:
    """[a, b) of the True entries of mask, which must be contiguous."""
    idx = np.flatnonzero(mask)
    if idx.size == 0:
        raise ValueError(f"{what}: no nonzero window")
    a, b = int(idx[0]), int(idx[-1]) + 1
    if idx.size != b - a:
        raise ValueError(f"{what}: nonzero windows are not contiguous")
    return a, b


def _widen(lo, ln, wts, starts, count):
    """Weights (k, n_out, count) of outputs o over widened windows that
    start at starts[o] <= lo[o]: tap j of o's window (wts[i, j, o], k
    weight sets sharing lo / ln) moves to index lo[o] - starts[o] + j;
    every other entry is zero."""
    k, big, n_out = wts.shape
    out = np.zeros((k, n_out, count), np.float32)
    shift = lo - starts
    j = np.arange(big)
    keep = j[None, :] < ln[:, None]                        # (n_out, big)
    o_idx = np.broadcast_to(np.arange(n_out)[:, None], keep.shape)[keep]
    dst = (shift[:, None] + j[None, :])[keep]
    src = np.broadcast_to(j[None, :], keep.shape)[keep]
    out[:, o_idx, dst] = wts[:, src, o_idx]
    return out


def y_plan(win: dict, sms: int = kernels.H100_SMS) -> dict:
    """K5's tiles. A block takes ``Y_WARPS`` level rows (one warp each, all
    three sections) of the nonzero rows [y_rows) by 32 * y_cols columns
    of the frame, and stages the source rows its warps read; blocks past
    the row tiles write the pad rows' zeros.

    y_span (ph, 2): each level row's widened window [start, start +
    count), count a multiple of 4 (0 for a pad row); wy_u (ph, 3, y_taps)
    its weights per section; y_tiles (row tiles, 2): each tile's staged
    source rows [first, first + n); y_stage = the most rows a tile
    stages; y_shared its shared-memory bytes."""
    lo, ln, wy = win["y_lo"], win["y_len"], win["wy"]
    ph = lo.size // 3
    lo3, ln3 = lo.reshape(3, ph), ln.reshape(3, ph)
    a, b = _nonzero_range((ln3 > 0).any(axis=0), "K5 rows")
    live = ln3 > 0
    start = np.where(live, lo3, np.iinfo(np.int32).max).min(axis=0)
    end = np.where(live, lo3 + ln3, 0).max(axis=0)
    count = np.where(live.any(axis=0), _up(end - start, 4), 0)
    start = np.where(live.any(axis=0), start, 0)
    taps = int(count.max())
    wy_u = np.zeros((ph, 3, taps), np.float32)
    for k in range(3):
        wy_u[:, k] = _widen(lo3[k], ln3[k], wy.T[None, :, k * ph:(k + 1) * ph],
                            start, taps)[0]
    tiles = []
    for y0 in range(a, b, Y_WARPS):
        y1 = min(y0 + Y_WARPS, b)
        first = int(start[y0:y1].min())
        tiles.append((first, int((start[y0:y1] + count[y0:y1]).max()) - first))
    tiles = np.asarray(tiles, np.int32)
    stage = int(tiles[:, 1].max())
    cols = 2 if (b - a) * -(-win["w"] // 64) >= sms * WARPS_PER_SM else 1
    shared = _fits(4 * (stage * 32 * cols + Y_WARPS * 3 * taps), "K5")
    return {"y_span": np.stack([start, count], axis=1).astype(np.int32),
            "wy_u": wy_u, "y_tiles": tiles, "y_rows": (a, b),
            "y_taps": taps, "y_stage": stage, "y_cols": cols,
            "y_zero_tiles": -(-(ph - (b - a)) // Y_WARPS),
            "y_shared": shared}


def x_plan(win: dict, sms: int = kernels.H100_SMS) -> dict:
    """K6's tiles. Columns [x_cols_nz) with a window are cut into groups
    of x_cols (1 or 2) adjacent columns, one warp each, lanes over
    ``X_ROWS`` output rows; a block takes ``X_WARPS`` groups of a row
    tile of the nonzero rows (K5's y_rows) and stages the three t
    sections' rows over the source columns its groups read. The first
    blocks of the grid write the canvas pads' zeros, ``ZERO_ROWS`` rows
    each.

    x_span (groups, 2): each group's widened window [start, start +
    count), start and count multiples of 4; wx_u (groups, 3, x_cols,
    x_taps) its weights; x_tiles (column tiles, 2): each tile's staged
    source columns [first, first + n), first and n multiples of 8;
    x_pitch the staged row length (> every n, 4 mod 8 in bf16 values, so
    the 8-byte reads of a half-warp's 16 rows fall on distinct bank
    pairs); x_shared the shared-memory bytes."""
    lo, ln, wx = win["x_lo"], win["x_len"], win["wx"]
    pw = lo.size
    a, b = _nonzero_range(ln > 0, "K6 columns")
    ya, yb = win["y_rows"]
    row_tiles = -(-(yb - ya) // X_ROWS)
    cols = 2 if row_tiles * -(-(b - a) // 2) >= sms * WARPS_PER_SM else 1
    groups = -(-(b - a) // cols)
    col = a + np.arange(groups * cols).reshape(groups, cols)
    real = col < b
    colc = np.minimum(col, b - 1)
    start = (np.where(real, lo[colc], np.iinfo(np.int32).max).min(axis=1)
             // 4) * 4
    end = np.where(real, lo[colc] + ln[colc], 0).max(axis=1)
    count = _up(end - start, 4)
    taps = int(count.max())
    wx_u = np.zeros((groups, 3, cols, taps), np.float32)
    for c in range(cols):
        cc = colc[:, c]
        wide = _widen(lo[cc] * real[:, c] + start * ~real[:, c],
                      ln[cc] * real[:, c], wx[:, :, cc], start, taps)
        wx_u[:, :, c] = wide.transpose(1, 0, 2)
    tiles = []
    for g0 in range(0, groups, X_WARPS):
        g1 = min(g0 + X_WARPS, groups)
        first = int(start[g0:g1].min()) // 8 * 8
        tiles.append((first, _up(int((start[g0:g1] + count[g0:g1]).max())
                                 - first, 8)))
    tiles = np.asarray(tiles, np.int32)
    pitch = int(tiles[:, 1].max()) + 4
    stage = max(3 * X_ROWS * pitch * 2, 5 * X_ROWS * (X_WARPS * cols + 1) * 4)
    shared = _fits(stage + 4 * X_WARPS * 3 * cols * taps, "K6")
    ph = win["y_span"].shape[0]
    pads = (ya, yb, a, b) != (0, ph, 0, pw)
    return {"x_span": np.stack([start, count], axis=1).astype(np.int32),
            "wx_u": wx_u, "x_tiles": tiles, "x_cols_nz": (a, b),
            "x_taps": taps, "x_pitch": pitch, "x_cols": cols,
            "x_row_tiles": row_tiles,
            "x_zero_blocks": -(-ph // ZERO_ROWS) if pads else 0,
            "x_shared": shared}


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
    rows = wy.shape[0]
    _require(img, "img", torch.float32, (h, w))
    if not kernels.launches_on(img.device):
        return prep_y_plain(img, win["y_lo"], wy)
    t = torch.empty((rows, w), dtype=torch.bfloat16, device=img.device)
    a, b = win["y_rows"]
    err = kernels.entry("prep_y")(
        img.data_ptr(), win["y_span"].data_ptr(), win["wy_u"].data_ptr(),
        win["y_tiles"].data_ptr(), t.data_ptr(), h, w, rows // 3, a, b,
        win["y_taps"], len(win["y_tiles"]), win["y_zero_tiles"],
        win["y_cols"], win["y_shared"],
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
    pw = wx.shape[2]
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
    (ya, yb), (xa, xb) = win["y_rows"], win["x_cols_nz"]
    err = kernels.entry("prep_x3")(
        t.data_ptr(), win["x_span"].data_ptr(), win["wx_u"].data_ptr(),
        win["x_tiles"].data_ptr(), out.data_ptr(), w, ph, pw, ya, yb, xa, xb,
        win["x_taps"], win["x_pitch"], win["x_row_tiles"],
        len(win["x_tiles"]), win["x_zero_blocks"], win["x_cols"],
        *(float(v) for v in ig), int(out_dtype == torch.bfloat16),
        int(channels_first), win["x_shared"],
        torch.cuda.current_stream(t.device).cuda_stream)
    kernels.check(err, "prep_x3")
    prep_x3.launches += 1
    return out


prep_x3.launches = 0
