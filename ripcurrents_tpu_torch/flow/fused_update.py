"""The Farneback level engine: host-side geometry, the two Hopper kernels'
wrappers and their plain PyTorch versions, and the level loop.

Port of ``ripcurrents_tpu/flow/fused_update.py``. On the TPU one Pallas
kernel runs a whole pyramid level (``_fused_level``), with a 3-kernel
chain (``_fused_update`` / ``_fused_iter`` / ``_fused_final``) of the same
algebra for levels that do not fit VMEM. Here the level is a host loop of
two hand-written CUDA kernels (``csrc/``):

- K1 ``farneback_update``: per (row tile x subcolumn) block the integer
  base displacement, the bilinear sample of the second frame's expansion
  at base + clamped residual, and the FarnebackUpdateMatrices tail -> M;
  launched as one thread-block cluster of ``cluster_size`` CTAs per block.
  A spatial slab whose blocks cut across ranks hands it the blocks' flow
  sums over the whole frame instead, each rank's part from
  ``farneback_block_sums`` (the same source file) over the rows it owns;
- K2 ``farneback_blur_solve``: the window blur of M and the 2x2 solve ->
  flow.

A level of ``iterations`` runs K1, then (K2 -> K1) x (iterations - 1),
then K2. Every wrapper checks its inputs, launches on the current stream
for CUDA tensors (counting launches in ``<wrapper>.launches``), and runs
the plain version only for CPU tensors.

Layouts match the JAX package: expansion tables (5, Hp + 2*HALO_Y,
Wp + 2*HALO_X) bf16 with the level embedded at (HALO_Y, HALO_X); flow
(2, Hp, Wp) f32 whose alignment pads are zero; M (5, Hp, Wp) bf16.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ripcurrents_tpu_torch import kernels

# Expansion-table halo per side. Bounds the per-block base displacement
# to +-(HALO - bres - 1).
HALO_Y = 32
HALO_X = 128
# Largest blur half-width the engine supports (winsize // 2).
MHALO_Y = 16
# Storage dtype of the normal-equation channels M.
M_DTYPE = torch.bfloat16


def _row_tile(lh: int) -> int:
    """Row-tile height: multiple of 8, minimal padding, ~96-160 rows."""
    best = None
    for th in range(96, 161, 8):
        hp = -(-lh // th) * th
        key = (hp - lh, -th)
        if best is None or key < best[0]:
            best = (key, th)
    th = best[1]
    return min(th, -(-lh // 8) * 8)   # never taller than the padded image


def padded_rows(lh: int, th: int, roff: int = 0) -> int:
    """Padded height Hp of a level of lh rows whose row tiles start roff
    rows above its first row: whole tiles from row 0 (ceil(lh/th)*th) when
    roff is 0, else lh rounded up to a multiple of 8 (K2's row tiles), the
    first and last tiles partial."""
    return -(-lh // th) * th if roff == 0 else -(-lh // 8) * 8


def row_tiles(hp: int, th: int, roff: int = 0) -> int:
    """Row tiles covering rows [0, hp) of a grid of th-row tiles that
    starts roff rows above row 0."""
    return -(-(hp + roff) // th)


def _subcol_width(wp: int, pref: "int | None" = None) -> int:
    """Warp-base subcolumn width: multiple of 128 dividing Wp, <= 384,
    or `pref` when it divides Wp."""
    if pref is not None and wp % pref == 0:
        return pref
    q = wp // 128
    for d in (3, 2, 1):
        if q % d == 0:
            return 128 * d
    return wp


def _blur_taps(winsize: int, gaussian: bool) -> tuple[float, ...]:
    half = winsize // 2
    if gaussian:
        x = np.arange(-half, half + 1, dtype=np.float64)
        sig = max(half * 0.3, 1e-6)
        k = np.exp(-(x * x) / (2 * sig * sig))
        k = k / k.sum()
    else:
        k = np.full((2 * half + 1,), 1.0 / (2 * half + 1))
    return tuple(float(v) for v in k)


def _to_bf16_values(a: np.ndarray) -> np.ndarray:
    """Round float32 values to bfloat16 (nearest, ties to even) and return
    them as float32."""
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


@functools.lru_cache(maxsize=64)
def _blur_weights(hp: int, h: int, taps: tuple) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """Per-row y weights (hp, nt) and x taps (nt,) of the window blur,
    rounded as the TPU kernel rounds its band matrices: at the replicate
    border, taps that land on the same source row are summed in float32
    first and the sum is rounded to bf16 (kept at the first such tap, the
    others zero); every x tap is rounded to bf16 on its own."""
    nt = len(taps)
    half = (nt - 1) // 2
    wy = np.zeros((hp, nt), np.float32)
    for y in range(hp):
        first = {}
        for o, kv in enumerate(taps):
            src = min(max(y - half + o, 0), h - 1)
            j = first.setdefault(src, o)
            wy[y, j] = np.float32(wy[y, j] + np.float32(kv))
    wx = np.asarray(taps, np.float32)
    return _to_bf16_values(wy), _to_bf16_values(wx)


@functools.lru_cache(maxsize=64)
def _blur_weights_on(hp: int, h: int, winsize: int, gaussian: bool,
                     device: torch.device):
    wy, wx = _blur_weights(hp, h, _blur_taps(winsize, gaussian))
    return torch.from_numpy(wy).to(device), torch.from_numpy(wx).to(device)


def _block_counts(h: int, w: int, th: int, hp: int, wp: int,
                  sw: int, roff: int = 0) -> np.ndarray:
    """Real-pixel count of every (row tile, subcolumn) block (>= 1); row
    tile i covers rows [i*th - roff, (i+1)*th - roff) clipped to [0, hp)."""
    ty_n, nsub = row_tiles(hp, th, roff), wp // sw
    lo = np.maximum(np.arange(ty_n) * th - roff, 0)
    rows = np.clip(np.minimum(np.arange(ty_n) * th + th - roff, h) - lo, 0,
                   None)
    cols = np.clip(w - np.arange(nsub) * sw, 0, sw)
    return np.maximum(rows[:, None] * cols[None, :], 1).astype(np.float32)


def prepare_expansions(e0: torch.Tensor, e1: torch.Tensor, th: int,
                       hw: "tuple[int, int] | None" = None,
                       subcol: "int | None" = None, roff: int = 0) -> dict:
    """Per-level kernel inputs: both frames' expansions in the halo'd bf16
    layout (5, Hp+2*HALO_Y, Wp+2*HALO_X) plus the per-(tile, subcolumn)
    real-pixel counts. Accepts expansions already halo'd (pass hw=(h, w))
    or raw (5, h, w), which are padded and cast here. roff: the row tiles
    start roff rows above the level's first row (a slab inside a frame,
    whose tile grid it keeps; Hp from ``padded_rows``)."""
    h, w = hw if hw is not None else tuple(e0.shape[1:])
    if not 0 <= roff < th:
        raise ValueError(f"row offset {roff} outside [0, {th})")
    hp = padded_rows(h, th, roff)
    wp = -(-w // 128) * 128
    sw = _subcol_width(wp, subcol)
    want = (hp + 2 * HALO_Y, wp + 2 * HALO_X)
    if tuple(e0.shape[1:]) != want:
        pad = (HALO_X, HALO_X + wp - w, HALO_Y, HALO_Y + hp - h)
        e0 = F.pad(e0, pad).to(torch.bfloat16)
        e1 = F.pad(e1, pad).to(torch.bfloat16)
    counts = torch.from_numpy(_block_counts(h, w, th, hp, wp, sw,
                                            roff)).to(e0.device)
    return {"p0": e0.contiguous(), "p1": e1.contiguous(), "counts": counts,
            "hw": (h, w), "hpwp": (hp, wp), "th": th, "sw": sw,
            "roff": roff}


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# ---------------------------------------------------------------------------
# K1: the matrix update
# ---------------------------------------------------------------------------

def _border_ramp(d: torch.Tensor) -> torch.Tensor:
    """OpenCV FarnebackUpdateMatrices 5-px border ramp over the edge
    distance d (negative d = alignment pad -> weight 0)."""
    return torch.where(d < 0, 0.0, torch.where(
        d <= 1, 0.14, torch.where(d <= 4, 0.4472, 1.0)))


def farneback_block_sums_plain(flow: torch.Tensor, th: int, sw: int,
                               roff: int, rows: tuple[int, int]
                               ) -> torch.Tensor:
    """Plain PyTorch version of K1's base sums: the flow (2, Hp, Wp) of
    each (row tile, subcolumn) block summed in float64 over rows
    [r0, r1) -> (2, row tiles, Wp / sw)."""
    _, hp, wp = flow.shape
    ty_n = row_tiles(hp, th, roff)
    y = torch.arange(hp, device=flow.device)[:, None]
    f = torch.where((y >= rows[0]) & (y < rows[1]), flow.double(), 0.0)
    grid = F.pad(f, (0, 0, roff, ty_n * th - roff - hp))
    return grid.reshape(2, ty_n, th, wp // sw, sw).sum(dim=(2, 4))


def farneback_block_sums(flow: torch.Tensor, th: int, sw: int, roff: int,
                         rows: tuple[int, int]) -> torch.Tensor:
    """K1's base sums of one rank's rows [r0, r1) of a level's flow (2, Hp,
    Wp) f32: (2, row tiles, Wp / sw) f64, each block's rows of [r0, r1)
    summed per thread in pair order, then a shuffle tree and the warps in
    order. On CUDA tensors one launch of ``farneback_block_sums_kernel``
    (csrc/farneback_update.cu), one block of threads a base block."""
    _, hp, wp = flow.shape
    dev = flow.device
    _require(flow, "flow", torch.float32, (2, hp, wp), dev)
    if wp % sw or sw % 2 or not 0 <= roff < th:
        raise ValueError(f"bad geometry: hpwp={(hp, wp)} th={th} sw={sw} "
                         f"roff={roff}")
    if not kernels.launches_on(dev):
        return farneback_block_sums_plain(flow, th, sw, roff, rows)
    out = torch.empty((2, row_tiles(hp, th, roff), wp // sw),
                      dtype=torch.float64, device=dev)
    err = kernels.entry("farneback_block_sums")(
        flow.data_ptr(), out.data_ptr(), hp, wp, th, sw, roff, rows[0],
        rows[1], torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "farneback_block_sums")
    farneback_block_sums.launches += 1
    return out


farneback_block_sums.launches = 0


def farneback_update_plain(p0: torch.Tensor, p1: torch.Tensor,
                           flow: torch.Tensor, counts: torch.Tensor,
                           hw: tuple[int, int], th: int, sw: int,
                           bres: int, roff: int = 0,
                           sums: "torch.Tensor | None" = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of K1 (same roundings): -> M (5, Hp, Wp) bf16.
    Row tile i covers rows [i*th - roff, (i+1)*th - roff) of the level;
    `sums` (2, row tiles, Wp / sw) f64, if given, are the blocks' flow
    sums (else the flow's own, in float64)."""
    h, w = hw
    _, hp, wp = flow.shape
    dev = flow.device
    ty_n, nsub = row_tiles(hp, th, roff), wp // sw
    if sums is None:
        sums = farneback_block_sums_plain(flow, th, sw, roff, (0, hp))
    q = torch.round(sums.float() / counts)          # half to even
    lim = torch.tensor([HALO_X - bres - 1, HALO_Y - bres - 1],
                       dtype=torch.float32, device=dev)[:, None, None]
    base = torch.minimum(torch.maximum(q, -lim), lim)
    base = base.repeat_interleave(th, dim=1)[:, roff:roff + hp]
    base = base.repeat_interleave(sw, dim=2)
    dx, dy = flow[0], flow[1]
    rx = torch.clamp(dx - base[0], -float(bres), float(bres))
    ry = torch.clamp(dy - base[1], -float(bres), float(bres))
    flx, fly = torch.floor(rx), torch.floor(ry)
    wx0 = 1.0 - (rx - flx)
    wx1 = 1.0 - wx0
    wy0 = 1.0 - (ry - fly)
    wy1 = 1.0 - wy0
    yy = torch.arange(hp, device=dev)[:, None]
    xx = torch.arange(wp, device=dev)[None, :]
    tw = wp + 2 * HALO_X
    row = yy + HALO_Y + base[1].long() + fly.long()
    col = xx + HALO_X + base[0].long() + flx.long()
    t00 = (row * tw + col).reshape(-1)
    table = p1.to(torch.float32).reshape(5, -1)

    def tap(off):
        return table[:, t00 + off].reshape(5, hp, wp)

    a = wx0 * tap(0) + wx1 * tap(1)
    b = wx0 * tap(tw) + wx1 * tap(tw + 1)
    r1 = wy0 * a + wy1 * b
    r0 = p0[:, HALO_Y:HALO_Y + hp, HALO_X:HALO_X + wp].to(torch.float32)

    ys = torch.arange(hp, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(wp, dtype=torch.float32, device=dev)[None, :]
    scale = (_border_ramp(torch.minimum(ys, (h - 1.0) - ys)) *
             _border_ramp(torch.minimum(xs, (w - 1.0) - xs)))
    xpd = xs + dx
    ypd = ys + dy
    inside = (xpd >= 0.0) & (ypd >= 0.0) & (xpd < w - 1.0) & (ypd < h - 1.0)
    r2 = torch.where(inside, (r0[0] - r1[0]) * 0.5, r0[0] * 0.5)
    r3 = torch.where(inside, (r0[1] - r1[1]) * 0.5, r0[1] * 0.5)
    r4 = torch.where(inside, (r0[2] + r1[2]) * 0.5, r0[2])
    r5 = torch.where(inside, (r0[3] + r1[3]) * 0.5, r0[3])
    r6 = torch.where(inside, (r0[4] + r1[4]) * 0.25, r0[4] * 0.5)
    r2 = r2 + r4 * dx + r6 * dy
    r3 = r3 + r6 * dx + r5 * dy
    r2, r3, r4, r5, r6 = (r * scale for r in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6,
                        (r4 + r5) * r6,
                        r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3,
                        r6 * r2 + r5 * r3]).to(M_DTYPE)


# The largest cluster K1 uses (a cluster above 8 CTAs is a non-portable
# size on Hopper).
MAX_CLUSTER = 16


def cluster_size(th: int, hp: int, wp: int, sw: int,
                 active: dict, roff: int = 0) -> tuple[int, int]:
    """(S, CTAs) of K1's launch at one level: S CTAs of one cluster split
    each (th x sw) base block's rows evenly (CTA r takes rows
    [r*n//S, (r+1)*n//S) of the block's n rows; n = th but for a
    partial first or last tile). S is the largest power of two <=
    min(MAX_CLUSTER, th) at which the card holds every cluster of the
    level at once (blocks <= active[S], `active` mapping a cluster size
    to the clusters the card holds: one wave, so no cluster waits for
    another to finish), else 1. CTAs = row_tiles * (wp/sw) * S."""
    blocks = row_tiles(hp, th, roff) * (wp // sw)
    s = 1
    while 2 * s <= min(MAX_CLUSTER, th) and blocks <= active.get(2 * s, 0):
        s *= 2
    return s, blocks * s


@functools.lru_cache(maxsize=1)
def card_clusters() -> dict:
    """{S: K1 clusters of S CTAs the card holds at once} for S = 1, 2, 4,
    ..., MAX_CLUSTER (cudaOccupancyMaxActiveClusters); raises when the
    query fails."""
    return kernels.active_clusters("farneback_update_active_clusters",
                                   MAX_CLUSTER)


@functools.lru_cache(maxsize=64)
def _launch_cluster(th: int, hp: int, wp: int, sw: int, roff: int) -> int:
    return cluster_size(th, hp, wp, sw, card_clusters(), roff)[0]


def farneback_update(prep: dict, flow: torch.Tensor, bres: int,
                     sums: "torch.Tensor | None" = None) -> torch.Tensor:
    """K1: the matrix update of one level from flow (2, Hp, Wp) f32 with
    zero pads -> M (5, Hp, Wp) bf16; the base blocks' row tiles start
    prep["roff"] rows above row 0. `sums`, if given, are the blocks' flow
    sums (2, row tiles, Wp / sw) f64 to take the bases from, with
    prep["counts"] their pixel counts. On CUDA tensors one cluster launch
    (``cluster_size`` CTAs per base block)."""
    (h, w), (hp, wp), th, sw = prep["hw"], prep["hpwp"], prep["th"], \
        prep["sw"]
    roff = prep.get("roff", 0)
    dev = flow.device
    table = (5, hp + 2 * HALO_Y, wp + 2 * HALO_X)
    _require(prep["p0"], "p0", torch.bfloat16, table, dev)
    _require(prep["p1"], "p1", torch.bfloat16, table, dev)
    _require(flow, "flow", torch.float32, (2, hp, wp), dev)
    _require(prep["counts"], "counts", torch.float32,
             (row_tiles(hp, th, roff), wp // sw), dev)
    if sums is not None:
        _require(sums, "sums", torch.float64,
                 (2, row_tiles(hp, th, roff), wp // sw), dev)
    if hp < h or wp % sw or wp % 128 or not 0 <= bres < HALO_Y - 1 or \
            not 0 <= roff < th:
        raise ValueError(f"bad geometry: hpwp={(hp, wp)} th={th} sw={sw} "
                         f"bres={bres} roff={roff}")
    if not kernels.launches_on(dev):
        return farneback_update_plain(prep["p0"], prep["p1"], flow,
                                      prep["counts"], (h, w), th, sw, bres,
                                      roff, sums)
    if flow.data_ptr() % 8 or prep["p0"].data_ptr() % 4:
        raise ValueError("farneback_update: flow must be 8-byte and p0 "
                         "4-byte aligned (paired loads)")
    m = torch.empty((5, hp, wp), dtype=M_DTYPE, device=dev)
    err = kernels.entry("farneback_update")(
        prep["p0"].data_ptr(), prep["p1"].data_ptr(), flow.data_ptr(),
        prep["counts"].data_ptr(), m.data_ptr(),
        None if sums is None else sums.data_ptr(), h, w, hp, wp, th, sw,
        bres, roff, _launch_cluster(th, hp, wp, sw, roff),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "farneback_update")
    farneback_update.launches += 1
    return m


farneback_update.launches = 0


# ---------------------------------------------------------------------------
# K2: window blur + 2x2 solve
# ---------------------------------------------------------------------------

def farneback_blur_solve_plain(m: torch.Tensor, hw: tuple[int, int],
                               wy: torch.Tensor, wx: torch.Tensor,
                               zero_pads: bool) -> torch.Tensor:
    """Plain PyTorch version of K2 (same roundings and tap order):
    M (5, Hp, Wp) bf16 -> flow (2, Hp, Wp) f32."""
    h, w = hw
    _, hp, wp = m.shape
    dev = m.device
    nt = wx.shape[0]
    half = (nt - 1) // 2
    mf = m.to(torch.float32)
    yy = torch.arange(hp, device=dev)
    acc = torch.zeros((5, hp, wp), dtype=torch.float32, device=dev)
    for o in range(nt):
        rows = torch.clamp(yy - half + o, 0, h - 1)
        acc = acc + wy[:, o][None, :, None] * mf[:, rows, :]
    mid = acc.to(torch.bfloat16).to(torch.float32)
    xx = torch.arange(wp, device=dev)
    g = torch.zeros_like(acc)
    for o in range(nt):
        cols = torch.clamp(xx - half + o, 0, w - 1)
        g = g + wx[o] * mid[:, :, cols]
    idet = 1.0 / (g[0] * g[2] - g[1] * g[1] + 1e-3)
    dx = (g[2] * g[3] - g[1] * g[4]) * idet
    dy = (g[0] * g[4] - g[1] * g[3]) * idet
    out = torch.stack([dx, dy])
    if zero_pads:
        valid = ((torch.arange(hp, device=dev) < h)[:, None] &
                 (torch.arange(wp, device=dev) < w)[None, :])
        out = torch.where(valid, out, 0.0)
    return out


# K2's tile plan. A thread sums a strip of `strip` output rows at two
# adjacent columns in the y pass and a run of BLUR_RUN output columns of
# one row in the x pass; the kernel is built for strips of 1 and 2 rows. A
# block has at most BLUR_MAX_THREADS threads, so with the kernel's launch
# bounds ptxas holds each thread to 65536 / BLUR_MAX_THREADS registers and
# any planned block fits an SM (``kernels.DEFINES``, with which the kernel
# is built).
BLUR_MAX_THREADS = kernels.DEFINES["farneback_blur_solve"]["BLUR_MAX_THREADS"]
BLUR_RUN = kernels.DEFINES["farneback_blur_solve"]["BLUR_RUN"]
# A level with fewer than BLUR_LATENCY_TAPS output taps (true outputs times
# window taps) cannot fill the card: its time is one thread's chain, so it
# takes BLUR_SMALL (rows, cols, strip), the most blocks and the shortest
# chains; a larger level takes BLUR_LARGE, fewer loads a product. Chosen
# on an H100 from every tile of 8-32 rows by 32-128 columns in four
# strip/run shapes at the 12 levels of the legacy, windowed and
# subtract_average 640x480 and windowed 1080p pyramids: within 11% of the
# fastest tile at each level and 2% over all of them.
BLUR_LATENCY_TAPS = 1 << 19
BLUR_SMALL = (8, 32, 1)
BLUR_LARGE = (8, 64, 2)


def blur_tile(rows: int, cols: int, half: int, strip: int) -> dict:
    """The geometry of one K2 tile of rows x cols outputs at half-width
    half with y strips of `strip` rows by 2 columns and x runs of BLUR_RUN
    columns: the mid values, mid_cols columns from image column x0 +
    mid_x0 (the x halo rounded up to even on each side, so each strip's
    two columns are one aligned 4-byte word of M) by rows, f32 at row
    pitch `pitch` (covering them and the x pass's 16-byte reads over each
    run's window, rounded up to 4 mod 8 floats); y_tasks strips, x_tasks
    runs, threads (one task of each a thread) and shared bytes."""
    half_even = half + half % 2
    pitch = cols - BLUR_RUN + 4 * -(-(half_even - half + BLUR_RUN + 2 * half)
                                     // 4)
    pitch = max(pitch, cols + 2 * half_even)
    pitch += (4 - pitch) % 8
    y_tasks = (cols // 2 + half_even) * (rows // strip)
    x_tasks = rows * (cols // BLUR_RUN)
    return {"rows": rows, "cols": cols, "half": half, "strip": strip,
            "mid_cols": cols + 2 * half_even, "mid_x0": -half_even,
            "pitch": pitch, "y_tasks": y_tasks, "x_tasks": x_tasks,
            "threads": -(-max(y_tasks, x_tasks) // 32) * 32,
            "shared": 5 * rows * pitch * 4}


@functools.lru_cache(maxsize=256)
def blur_plan(hp: int, wp: int, half: int, hw: tuple[int, int]) -> dict:
    """K2's tiles at one level, padded (hp, wp), true size hw, half-width
    half: BLUR_SMALL below BLUR_LATENCY_TAPS output taps, else BLUR_LARGE,
    as ``blur_tile`` plus grid (tiles across, tiles down). Tiles wholly in
    the pads only write zeros."""
    taps = hw[0] * hw[1] * (2 * half + 1)
    rows, cols, strip = BLUR_SMALL if taps < BLUR_LATENCY_TAPS \
        else BLUR_LARGE
    t = blur_tile(rows, cols, half, strip)
    if t["threads"] > BLUR_MAX_THREADS or t["shared"] > kernels.MAX_SHARED:
        raise ValueError(f"K2: a {rows}x{cols} tile at half-width {half} "
                         f"does not fit a block")
    return dict(t, grid=(-(-wp // cols), -(-hp // rows)))


def farneback_blur_solve(m: torch.Tensor, hw: tuple[int, int], winsize: int,
                         gaussian: bool, zero_pads: bool) -> torch.Tensor:
    """K2: window blur (box or Gaussian, cv2 replicate border about the
    true size hw) of M and the 2x2 solve -> flow (2, Hp, Wp) f32, its
    alignment pads zeroed when zero_pads. On CUDA tensors one launch over
    the tiles of ``blur_plan``."""
    h, w = hw
    dev = m.device
    _, hp, wp = m.shape
    _require(m, "m", M_DTYPE, (5, hp, wp), dev)
    half = winsize // 2
    if hp % 8 or wp % 32 or h > hp or w > wp or half > MHALO_Y:
        raise ValueError(f"bad geometry: m {tuple(m.shape)} hw={hw} "
                         f"winsize={winsize}")
    wy, wx = _blur_weights_on(hp, h, winsize, gaussian, dev)
    if not kernels.launches_on(dev):
        return farneback_blur_solve_plain(m, hw, wy, wx, zero_pads)
    plan = blur_plan(hp, wp, half, (h, w))
    # the taps go to the kernel by value, from the host copy
    taps = _blur_weights(hp, h, _blur_taps(winsize, gaussian))[1]
    flow = torch.empty((2, hp, wp), dtype=torch.float32, device=dev)
    err = kernels.entry("farneback_blur_solve")(
        m.data_ptr(), wy.data_ptr(), taps.ctypes.data, flow.data_ptr(), h, w,
        hp, wp, half, int(zero_pads), plan["rows"], plan["cols"],
        plan["strip"], plan["pitch"], plan["threads"], plan["shared"],
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "farneback_blur_solve")
    farneback_blur_solve.launches += 1
    return flow


farneback_blur_solve.launches = 0


# ---------------------------------------------------------------------------
# The level loop
# ---------------------------------------------------------------------------

def fused_level(prep: dict, flow: torch.Tensor, winsize: int,
                gaussian: bool, bres: int, iterations: int,
                base_sums=None) -> torch.Tensor:
    """One whole pyramid level (counterpart of the TPU's
    fused_level_prepped with padded_io=True): the first update from the
    init flow, iterations - 1 rounds of blur + solve + update, and the
    final blur + solve. flow in and out is (2, Hp, Wp) f32 with zero
    pads. base_sums(flow), if given, makes each update's block sums (a
    slab's, over the whole frame)."""
    def update(flow):
        return farneback_update(prep, flow, bres, None if base_sums is None
                                else base_sums(flow))

    m = update(flow)
    for _ in range(iterations - 1):
        flow = farneback_blur_solve(m, prep["hw"], winsize, gaussian, True)
        m = update(flow)
    return farneback_blur_solve(m, prep["hw"], winsize, gaussian, True)
