"""The standalone warps: kernels K7 and K8, their wrappers and their
plain PyTorch versions.

K7
--

Port of ``ripcurrents_tpu/flow/warp_pallas.py: warp5_shift_pallas``, the
``warp_impl="pallas"`` branch of ``update_matrices``. It computes the
shift decomposition of the bilinear warp of the second frame's expansion
r1 (H, W, 5) by the flow (H, W, 2),

    out(p) = sum_sy hat(dy - sy) * sum_sx hat(dx - sx) * r1(p + (sx, sy)),

over the shifts s in [-budget, budget + 1]^2, with hat(t) = clamp(1 - |t|,
0, 1) in float32 and r1 zero outside the frame. Only the two shifts that
bracket each displacement (floor(d) and floor(d) + 1) can carry weight,
and a sum that starts at zero is not changed by adding zero terms, so K7
evaluates just those (each where it lies inside the shift range), rows in
ascending sx, then the sum over sy: the TPU's (2*budget + 2)^2-term sum,
value for value. Exact for |flow| <= budget; the caller masks the other
pixels with ``_warp5_shift_mask``.

On CUDA tensors ``warp5_shift`` launches K7 once (counted in
``warp5_shift.launches``); on CPU tensors it runs ``warp5_shift_plain``.

K8
--
Port of the TPU kernel of ``tools/bench_warp_variants.py: run``, the
fused engine's warp stage ``ripcurrents_tpu/flow/fused_update.py:
_warp_subcols`` run alone, and of the same algebra in the portable
engine's tiled warp, ``ripcurrents_tpu/flow/farneback.py: _warp5_tiled``.
Per tile of (th, tw) pixels the integer base is the rounded mean of the
tile's real-pixel flow (summed in float64, divided in float32, rounded
half to even), clamped; each pixel's residual flow - base is clamped to
+-bres and the C-channel table is read bilinearly at pixel + base +
residual (weights w0 = 1 - frac, w1 = 1 - w0; the TPU's (2*bres+1)^2-tap
sum has no other nonzero terms). Reads outside the table are 0. Two
layouts, told apart by the table's dtype:

- bf16: the fused engine's halo'd table (5, hp + 2*HALO_Y, wp + 2*HALO_X)
  with the frame at (HALO_Y, HALO_X), flow (2, hp, wp) with zero pads,
  counts (hp / th, wp / tw) from the caller, base clamped to
  +-(HALO - bres - 1) -> (5, hp, wp) f32 (``_warp_subcols``);
- float32: a channels-last table (h, w, C) for C in ``CHANNELS`` (the
  channel counts of ``_warp5_tiled``'s callers), flow (h, w, 2), each
  tile's real-pixel count ``frame_counts`` (derived from the geometry, so
  the caller passes None or that tensor), base clamped to +-max_base ->
  (h, w, C) f32 (``_warp5_tiled``).

``warp_tiles`` launches K8 once on CUDA tensors (counted in
``warp_tiles.launches``): one thread-block cluster of S CTAs per tile
(``tiles_plan``) that reduces the tile's base and samples it in the same
launch. On CPU tensors it runs ``warp_tiles_plain``. ``warp_tiles_nobase``
is the bf16 layout with base 0 (the tool's variant "Z", the floor of the
tap stream), a separate instance of the kernel without the reduction.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ripcurrents_tpu_torch import kernels
from ripcurrents_tpu_torch.flow import fused_update as fu
from ripcurrents_tpu_torch.flow.fused_update import HALO_X, HALO_Y

# Base clamp of the frame layout (the JAX _warp5_tiled's max_base).
MAX_BASE = 96


def _hat(d: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(d - s), 0.0, 1.0)


def warp5_shift_plain(r1: torch.Tensor, flow: torch.Tensor,
                      budget: int) -> torch.Tensor:
    """Plain PyTorch version of K7: r1 (H, W, 5) f32 warped by flow
    (H, W, 2) f32 -> (H, W, 5) f32, the same roundings and order."""
    h, w = r1.shape[0], r1.shape[1]
    dev = r1.device
    dx, dy = flow[..., 0], flow[..., 1]
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    fx, fy = torch.floor(dx), torch.floor(dy)
    lo, hi = -float(budget), float(budget + 1)

    def taps(f, d):
        out = []
        for s in (f, f + 1.0):
            use = (s >= lo) & (s <= hi)
            out.append((torch.where(use, _hat(d, s), 0.0),
                        torch.where(use, s, 0.0).long()))
        return out

    tx, ty = taps(fx, dx), taps(fy, dy)
    acc = torch.zeros_like(r1)
    for wy, sy in ty:
        row = torch.zeros_like(r1)
        yy = ys + sy
        for wx, sx in tx:
            xx = xs + sx
            inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            v = r1[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
            row = row + wx[..., None] * torch.where(inb[..., None], v, 0.0)
        acc = acc + wy[..., None] * row
    return acc


def warp5_shift(r1: torch.Tensor, flow: torch.Tensor,
                budget: int) -> torch.Tensor:
    """K7: the warp of r1 (H, W, 5) f32 by flow (H, W, 2) f32 within
    +-budget -> (H, W, 5) f32. Values where |flow| > budget are not the
    bilinear sample (callers mask them)."""
    h, w = r1.shape[0], r1.shape[1]
    for t, name, c in ((r1, "r1", 5), (flow, "flow", 2)):
        if t.dtype != torch.float32 or tuple(t.shape) != (h, w, c) or \
                not t.is_contiguous() or t.device != r1.device:
            raise ValueError(f"{name}: expected contiguous float32 "
                             f"{(h, w, c)} on {r1.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if budget < 0:
        raise ValueError(f"budget must be >= 0, got {budget}")
    if not kernels.launches_on(r1.device):
        return warp5_shift_plain(r1, flow, budget)
    out = torch.empty_like(r1)
    err = kernels.entry("warp5_shift")(
        r1.data_ptr(), flow.data_ptr(), out.data_ptr(), h, w, budget,
        torch.cuda.current_stream(r1.device).cuda_stream)
    kernels.check(err, "warp5_shift")
    warp5_shift.launches += 1
    return out


warp5_shift.launches = 0


# ---------------------------------------------------------------------------
# K8: the tiled base + residual warp
# ---------------------------------------------------------------------------

# Channel counts of the frame layout: the Farneback table (5), and the
# gray (1) and colour (3) frames of _warp5_tiled's other callers.
CHANNELS = (1, 3, 5)
# K8's CTA sizes: the plan takes one of these (kMaxThreads in
# csrc/warp_tiles.cu is the largest), about PIX_PER_THREAD pixels a thread.
THREADS = (128, 256, 512)
PIX_PER_THREAD = 16


@functools.lru_cache(maxsize=64)
def frame_counts(h: int, w: int, th: int, tw: int,
                 device: torch.device) -> torch.Tensor:
    """Real-pixel count (>= 1) of every (th, tw) tile of an (h, w) frame:
    (ceil(h / th), ceil(w / tw)) float32 on `device`."""
    y0 = np.arange(-(-h // th)) * th
    x0 = np.arange(-(-w // tw)) * tw
    rows = np.minimum(y0 + th, h) - y0
    cols = np.minimum(x0 + tw, w) - x0
    counts = np.maximum(rows[:, None] * cols[None, :], 1)
    return torch.from_numpy(counts.astype(np.float32)).to(device)


def tiles_plan(rows: int, cols: int, th: int, tw: int,
               active: dict) -> dict:
    """K8's launch for rows x cols pixels (the frame, or the halo layout's
    padded (hp, wp)) in (th, tw) tiles: S CTAs per tile, CTA r taking the
    tile's rows [r * th // S, (r + 1) * th // S), each of T threads, the
    least of THREADS that gives a thread at most PIX_PER_THREAD pixels of
    the largest slab (else the largest). S is the largest power of two
    <= min(MAX_CLUSTER, th) at which the card holds every cluster of the
    call at once (tiles <= active[T][S], `active` mapping a CTA size to
    {S: clusters of S CTAs the card holds}: no cluster waits for another),
    else 1. The no-base instance takes the same plan, unclustered.
    -> {"S", "ctas", "threads", "grid": (S, ntx, nty)}."""
    nty, ntx = -(-rows // th), -(-cols // tw)
    tiles = nty * ntx

    def threads(s):
        pixels = -(-th // s) * min(tw, cols)
        return next((t for t in THREADS if t * PIX_PER_THREAD >= pixels),
                    THREADS[-1])

    s = 1
    while 2 * s <= min(fu.MAX_CLUSTER, th) and \
            tiles <= active[threads(2 * s)].get(2 * s, 0):
        s *= 2
    return {"S": s, "ctas": tiles * s, "threads": threads(s),
            "grid": (s, ntx, nty)}


@functools.lru_cache(maxsize=1)
def tile_clusters() -> dict:
    """{T: {S: K8 clusters of S CTAs of T threads the card holds at once}}
    for T in THREADS, the least over K8's clustered instances."""
    return {t: kernels.active_clusters("warp_tiles_active_clusters",
                                       fu.MAX_CLUSTER, t) for t in THREADS}


@functools.lru_cache(maxsize=256)
def _launch_plan(rows: int, cols: int, th: int, tw: int) -> dict:
    return tiles_plan(rows, cols, th, tw, tile_clusters())


def tile_bases_plain(flow_cf: torch.Tensor, counts: torch.Tensor, th: int,
                     tw: int, lim_x: int, lim_y: int) -> torch.Tensor:
    """The integer base of every tile: flow_cf (2, FH, FW), zero beyond
    it up to whole tiles, -> (2, nty, ntx) float32 (x, y)."""
    nty, ntx = counts.shape
    _, fh, fw = flow_cf.shape
    f = F.pad(flow_cf.double(), (0, ntx * tw - fw, 0, nty * th - fh))
    sums = f.reshape(2, nty, th, ntx, tw).sum(dim=(2, 4))
    q = torch.round(sums.float() / counts)          # half to even
    lim = torch.tensor([lim_x, lim_y], dtype=torch.float32,
                       device=flow_cf.device)[:, None, None]
    return torch.minimum(torch.maximum(q, -lim), lim)


def _sample_plain(table_cf: torch.Tensor, origin: tuple[int, int],
                  flow_cf: torch.Tensor, base, th: int, tw: int, bres: int,
                  out_hw: tuple[int, int]) -> torch.Tensor:
    """The bilinear read of table_cf (C, TR, TC) (0 outside it; pixel
    (0, 0) at `origin`) at pixel + base + clamped residual for the
    out_hw pixels of flow_cf (2, FH, FW); base (2, nty, ntx) or None (0)
    -> (C, oh, ow) float32."""
    oh, ow = out_hw
    dev = flow_cf.device
    dx, dy = flow_cf[0, :oh, :ow], flow_cf[1, :oh, :ow]
    if base is None:
        bx = by = torch.zeros_like(dx)
    else:
        full = base.repeat_interleave(th, dim=1).repeat_interleave(tw, dim=2)
        bx, by = full[0, :oh, :ow], full[1, :oh, :ow]
    rx = torch.clamp(dx - bx, -float(bres), float(bres))
    ry = torch.clamp(dy - by, -float(bres), float(bres))
    flx, fly = torch.floor(rx), torch.floor(ry)
    wx0 = 1.0 - (rx - flx)
    wx1 = 1.0 - wx0
    wy0 = 1.0 - (ry - fly)
    wy1 = 1.0 - wy0
    tr, tc = table_cf.shape[1], table_cf.shape[2]
    r0 = (torch.arange(oh, device=dev)[:, None] + origin[0] + by.long() +
          fly.long())
    c0 = (torch.arange(ow, device=dev)[None, :] + origin[1] + bx.long() +
          flx.long())
    tab = table_cf.to(torch.float32)

    def tap(i, j):
        r, c = r0 + i, c0 + j
        inb = (r >= 0) & (r < tr) & (c >= 0) & (c < tc)
        v = tab[:, r.clamp(0, tr - 1), c.clamp(0, tc - 1)]
        return torch.where(inb, v, 0.0)

    a = wx0 * tap(0, 0) + wx1 * tap(0, 1)
    b = wx0 * tap(1, 0) + wx1 * tap(1, 1)
    return wy0 * a + wy1 * b


def _check_tiles(table, flow, counts, th, tw, bres, max_base):
    """Validate K8's inputs; -> (halo layout?, geometry)."""
    dev = flow.device
    if table.dim() != 3 or flow.dim() != 3:
        raise ValueError("expected a 3-d table and flow: (5, Hp+2*HALO_Y, "
                         "Wp+2*HALO_X) and (2, Hp, Wp), or (h, w, C) and "
                         "(h, w, 2)")
    if table.dtype == torch.bfloat16:
        hp, wp = flow.shape[1], flow.shape[2]
        want = {"table": (table, torch.bfloat16,
                          (5, hp + 2 * HALO_Y, wp + 2 * HALO_X)),
                "flow": (flow, torch.float32, (2, hp, wp))}
        if counts is not None:
            want["counts"] = (counts, torch.float32,
                              (hp // max(th, 1), wp // max(tw, 1)))
        bad_geom = (th < 1 or tw < 1 or tw % 4 or hp % th or wp % tw or
                    not 0 <= bres < HALO_Y - 1)
        geom = (hp, wp)
    else:
        h, w, c = table.shape
        if c not in CHANNELS:
            raise ValueError(f"table: {c} channels; the frame layout takes "
                             f"{CHANNELS}")
        want = {"table": (table, torch.float32, (h, w, c)),
                "flow": (flow, torch.float32, (h, w, 2))}
        if counts is not None:
            want["counts"] = (counts, torch.float32,
                              (-(-h // max(th, 1)), -(-w // max(tw, 1))))
        bad_geom = th < 1 or tw < 1 or bres < 0 or max_base < 0
        geom = (h, w)
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
                not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: expected contiguous {dtype} "
                             f"{tuple(shape)} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if table.numel() >= 2 ** 31:
        raise ValueError("table: 2^31 elements or more (32-bit offsets)")
    if bad_geom:
        raise ValueError(f"bad geometry: {tuple(flow.shape)} tile "
                         f"{(th, tw)} bres {bres} max_base {max_base}")
    return table.dtype == torch.bfloat16, geom


def warp_tiles_plain(table: torch.Tensor, flow: torch.Tensor,
                     counts: "torch.Tensor | None", th: int, tw: int,
                     bres: int, max_base: int = MAX_BASE) -> torch.Tensor:
    """Plain PyTorch version of K8 (same roundings), either layout (the
    frame layout takes its counts from ``frame_counts``)."""
    if table.dtype == torch.bfloat16:
        hp, wp = flow.shape[1], flow.shape[2]
        base = tile_bases_plain(flow, counts, th, tw, HALO_X - bres - 1,
                                HALO_Y - bres - 1)
        return _sample_plain(table, (HALO_Y, HALO_X), flow, base, th, tw,
                             bres, (hp, wp))
    h, w = table.shape[0], table.shape[1]
    flow_cf = flow.permute(2, 0, 1)
    base = tile_bases_plain(flow_cf, frame_counts(h, w, th, tw, flow.device),
                            th, tw, max_base, max_base)
    out = _sample_plain(table.permute(2, 0, 1), (0, 0), flow_cf, base, th,
                        tw, bres, (h, w))
    return out.permute(1, 2, 0).contiguous()


def warp_tiles(table: torch.Tensor, flow: torch.Tensor,
               counts: "torch.Tensor | None", th: int, tw: int, bres: int,
               max_base: int = MAX_BASE) -> torch.Tensor:
    """K8: the tiled base + residual warp of `table` by `flow` -> the
    samples, float32, in the table's layout (see the module docstring).
    The halo layout needs `counts`; the frame layout takes None or
    ``frame_counts``' tensor."""
    halo, (gh, gw) = _check_tiles(table, flow, counts, th, tw, bres,
                                  max_base)
    if halo and counts is None:
        raise ValueError("halo layout: counts (hp / th, wp / tw) needed")
    dev = flow.device
    if not kernels.launches_on(dev):
        return warp_tiles_plain(table, flow, counts, th, tw, bres, max_base)
    plan = _launch_plan(gh, gw, th, tw)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if flow.data_ptr() % 16:
        raise ValueError("warp_tiles: flow must be 16-byte aligned (float4 "
                         "loads)")
    if halo:
        out = torch.empty((5, gh, gw), dtype=torch.float32, device=dev)
        err = kernels.entry("warp_tiles_halo")(
            table.data_ptr(), flow.data_ptr(), counts.data_ptr(),
            out.data_ptr(), gh, gw, th, tw, bres, plan["S"],
            plan["threads"], stream)
    else:
        c = table.shape[2]
        out = torch.empty((gh, gw, c), dtype=torch.float32, device=dev)
        err = kernels.entry("warp_tiles_frame")(
            table.data_ptr(), flow.data_ptr(), out.data_ptr(), gh, gw, c, th,
            tw, bres, max_base, plan["S"], plan["threads"], stream)
    kernels.check(err, "warp_tiles")
    warp_tiles.launches += 1
    return out


warp_tiles.launches = 0


def warp_tiles_nobase_plain(table: torch.Tensor, flow: torch.Tensor,
                            th: int, tw: int, bres: int) -> torch.Tensor:
    """Plain PyTorch version of ``warp_tiles_nobase``."""
    hp, wp = flow.shape[1], flow.shape[2]
    return _sample_plain(table, (HALO_Y, HALO_X), flow, None, th, tw, bres,
                         (hp, wp))


def warp_tiles_nobase(table: torch.Tensor, flow: torch.Tensor, th: int,
                      tw: int, bres: int) -> torch.Tensor:
    """K8's halo layout with base 0 and no base pass: the taps and weights
    alone at residual clamp(flow, +-bres) (the tool's floor, variant "Z").
    table (5, hp + 2*HALO_Y, wp + 2*HALO_X) bf16, flow (2, hp, wp) f32
    -> (5, hp, wp) f32."""
    if table.dtype != torch.bfloat16:
        raise ValueError(f"table: expected bfloat16, got {table.dtype}")
    _, (hp, wp) = _check_tiles(table, flow, None, th, tw, bres, 0)
    dev = flow.device
    if not kernels.launches_on(dev):
        return warp_tiles_nobase_plain(table, flow, th, tw, bres)
    plan = _launch_plan(hp, wp, th, tw)
    out = torch.empty((5, hp, wp), dtype=torch.float32, device=dev)
    err = kernels.entry("warp_tiles_halo_nobase")(
        table.data_ptr(), flow.data_ptr(), out.data_ptr(), hp, wp, th, tw,
        bres, plan["S"], plan["threads"],
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "warp_tiles_nobase")
    warp_tiles_nobase.launches += 1
    return out


warp_tiles_nobase.launches = 0
