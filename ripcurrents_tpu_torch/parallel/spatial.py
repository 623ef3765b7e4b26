"""Spatially-sharded dense flow with an explicit halo exchange (port of
``ripcurrents_tpu/parallel/spatial.py``).

Frame rows are split over the mesh's 'space' axis: each rank holds one
row band, fetches the rows it needs from its two ring neighbours
(``dist.batch_isend_irecv`` on its 'space' group), computes Farneback on
its slab through the port's own ``flow/farneback.py: farneback`` (so the
fused engine's K5, K6, K1, K2 and K4, or the tiled engine's K5, K6 and
K8, run per slab on the card) and keeps its band's rows. Where JAX
passes one sharded global array under shard_map, each rank here passes
its own band (``mesh.shard_streams`` cuts a frame into bands) and gets
its band's flow back.

Accuracy: flow at a pixel depends on a finite neighbourhood (pyramid
levels x [poly window + blur window + warp base range]); the slab is
computed as if its edges were frame edges, so border artefacts live
within that radius of the slab edge and are cropped away with the halo.
The slab passes its place in the frame to the engine
(``farneback(..., slab=Slab(...))``), so the fused engine's warp base
blocks follow the frame's row tiles at every level. A slab inside the frame also
passes the rows this rank owns and a sum over the 'space' group: before
each K1 launch the ranks add up their own rows' flow sums of every block
(one small all-reduce), so each block's base is the whole frame's, as
one process computes it, even where the block is cut by a slab's edge
(at the coarse levels one block spans the whole frame). Bounded
deviations from the single-device result:

- the replicate-padded slabs keep the bases of the rows they hold, and
  the tiled warp's tiles follow the slab (its size and first row, as
  JAX's slabs do): keep `halo` a multiple of the tiled warp's tile
  height (64 by default) for its grid to align with the frame's. A shifted base moves the residual's clamp,
  so ill-conditioned pixels can flip;
- with the replicate-pad slabs (band / 2 < halo <= band) the frame's
  outermost rows see the border ramp at the slab edge instead of the
  true frame edge. The clamped slabs (2 * halo <= band) put the true
  frame edge at the slab edge on the edge ranks.

``spatial_stream_init`` / ``spatial_stream_step`` are the stream form:
each rank carries its slab's expansions and exchanges only the new
frame's halo rows each step; ``stream_halo`` derives the halo from a
preset.

A 'space' group on gloo (ranks sharing a card) takes CPU tensors only,
so its halo rows are staged through host memory; on NCCL they move as
device tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow.farneback import (Slab, _level_iters,
                                                  _per_level,
                                                  _residual_schedule,
                                                  farneback,
                                                  farneback_precompute,
                                                  farneback_stream)
from ripcurrents_tpu_torch.parallel.mesh import (Mesh, exchanged,
                                                 space_all_reduce)


def exchange_rows(mesh: Mesh, x: torch.Tensor, rows: int,
                  label: str = "halo rows"):
    """Swap `rows` boundary rows of x (..., band, W) with the ring
    neighbours on the 'space' axis: this rank's first rows go to the
    previous rank and its last rows to the next. -> (the previous rank's
    last rows, the next rank's first rows), each None on the frame's
    edge (the outermost ranks send nothing around the ring). `label`
    names the exchange in the mesh's tally."""
    n, idx = mesh.space, mesh.coords["space"]
    peers = [(side, j) for side, j in (("above", idx - 1), ("below", idx + 1))
             if 0 <= j < n]
    edges = torch.stack([x[..., :rows, :], x[..., -rows:, :]])
    with exchanged(mesh, edges, nbytes=edges[0].numel() *
                   edges.element_size() * len(peers),
                   label=label) as (send, back):
        ops, got = [], {}
        for side, j in peers:
            peer = mesh.rank - idx + j
            got[side] = torch.empty_like(send[0])
            ops += [dist.P2POp(dist.isend, send[int(side == "below")],
                               peer, mesh.group),
                    dist.P2POp(dist.irecv, got[side], peer, mesh.group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        got = {k: back(v) for k, v in got.items()}
    return got.get("above"), got.get("below")


def _exchange_halo(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """[previous rank's last rows, x, next rank's first rows] along the
    row axis of x (..., band, W). The edge ranks get a replicate-padded
    halo (the frame border) instead."""
    above, below = exchange_rows(mesh, x, halo)
    if above is None:
        above = x[..., :1, :].expand(*x.shape[:-2], halo, x.shape[-1])
    if below is None:
        below = x[..., -1:, :].expand(*x.shape[:-2], halo, x.shape[-1])
    return torch.cat([above, x, below], dim=-2)


def _clamped_slab(x: torch.Tensor, halo: int, mesh: Mesh):
    """This rank's (band + 2 * halo)-row slab: a contiguous window of the
    FULL frame clamped into bounds. Interior ranks get [start - halo,
    end + halo); the edge ranks slide the window inward so the TRUE
    frame edge lands at the slab edge, where the engine applies its
    border ramp. Needs 2 * halo <= band (the window reaches at most one
    neighbour). -> (slab, keep0): keep0 is the row offset of this rank's
    band inside the slab."""
    n, idx = mesh.space, mesh.coords["space"]
    band = x.shape[-2]
    two = min(2 * halo, band)
    above, below = exchange_rows(mesh, x, two)
    # comp covers frame rows [base, base + rows of comp)
    start = idx * band
    base = start - (two if above is not None else 0)
    comp = torch.cat([t for t in (above, x, below) if t is not None],
                     dim=-2)
    w0 = min(max(start - halo, 0), n * band - band - 2 * halo)
    off = w0 - base
    return comp[..., off:off + band + 2 * halo, :], start - w0


def slab_of(x: torch.Tensor, halo: int, mesh: Mesh,
            edges: str = "replicate"):
    """This rank's slab of x (..., band, W): the clamped slab when
    2 * halo <= band, else the band with `halo` rows of each neighbour:
    at the frame's edges either `halo` replicated rows (edges=
    "replicate", the JAX package's slab) or none (edges="frame": the
    slab ends at the frame's edge, as the clamped slab does, and the
    edge ranks' slabs are `halo` rows shorter). -> (slab, keep0,
    origin): the band's first row inside the slab and the slab's first
    row in the frame (negative for a replicate-padded top)."""
    band = x.shape[-2]
    if 2 * halo <= band:
        slab, keep0 = _clamped_slab(x, halo, mesh)
    elif edges == "replicate":
        slab, keep0 = _exchange_halo(x, halo, mesh), halo
    else:
        above, below = exchange_rows(mesh, x, halo)
        slab = torch.cat([t for t in (above, x, below) if t is not None],
                         dim=-2)
        keep0 = 0 if above is None else halo
    return slab, keep0, mesh.coords["space"] * band - keep0


def stream_halo(p: FarnebackParams, hw: "tuple[int, int] | None" = None
                ) -> int:
    """The halo rows of preset p's slabs: at each level k the reach of
    one pixel's flow in level pixels, the applicability's 2.5 sigma
    (ceil) plus the window blur's half-width per iteration plus the warp
    residual, scaled by 2^k (1 / pyr_scale^k) and summed over the levels,
    rounded up to a multiple of 4 * 2^levels so that every level of the
    slab's pyramid starts on a row of the frame's. hw (the frame size)
    picks the residual and iterations as the engine does (the >= 1 MP
    overrides). For the legacy preset (3 levels, poly_n 15 at sigma 1.2,
    box 3 x 2 iterations, residual 4): 3 + 2 + 4 = 9 level pixels, 9 x
    (1 + 2 + 4) = 63 -> 64 rows."""
    wr, it_sched = _residual_schedule(*(hw or (0, 0)), p)
    rows = 0.0
    for k in range(p.levels + 1):
        reach = (math.ceil(2.5 * p.poly_sigma) +
                 (p.winsize // 2) * _level_iters(p, it_sched, k) +
                 _per_level(wr, k))
        rows += reach / p.pyr_scale ** k
    step = 4 * round(1 / p.pyr_scale ** p.levels)
    return int(-(-math.ceil(rows) // step) * step)


def _frame_slab(mesh: Mesh, origin: int, band: int) -> Slab:
    """The engine's Slab of this rank's slab inside the frame: its origin,
    the rank's own band rows and the group's sum, so its warp bases are
    the whole frame's."""
    start = mesh.coords["space"] * band
    return Slab(origin, mesh.space * band, (start, start + band),
                lambda t: space_all_reduce(mesh, t, label="K1 base sums"))


class SpatialStream(NamedTuple):
    """A rank's carried slab state: the previous frame's expansion tables
    of this rank's slab."""
    exp: tuple


def spatial_stream_init(band: torch.Tensor, p: FarnebackParams,
                        mesh: Mesh, halo: int) -> SpatialStream:
    """The stream state from this rank's (band, W) rows of the first
    frame (one halo exchange). The slabs end at the frame's edges
    (``slab_of`` with edges="frame"); the halo comes from the two ring
    neighbours only, so it must fit in one band."""
    if halo > band.shape[0]:
        raise ValueError(f"halo={halo} exceeds the per-shard row band "
                         f"({band.shape[0]}); use fewer shards or a taller "
                         f"frame")
    slab, _, origin = slab_of(band, halo, mesh, "frame")
    return SpatialStream(farneback_precompute(
        slab, p, _frame_slab(mesh, origin, band.shape[0])))


def spatial_stream_step(state: SpatialStream, band: torch.Tensor,
                        p: FarnebackParams, mesh: Mesh, halo: int):
    """One stream step with the frame's rows split over the 'space' axis:
    this rank's (band, W) rows of the next frame -> (the band's flow
    (band, W, 2), the new state). The new frame's halo rows are exchanged
    with the ring neighbours; the slab's expansions are made once and
    carried to the next step, so a step runs the stream's kernels once
    on a slab of band + 2 * halo rows (K5/K6 per level, the level loop)."""
    slab, keep0, origin = slab_of(band, halo, mesh, "frame")
    flow, exp = farneback_stream(state.exp, slab, p,
                                 slab=_frame_slab(mesh, origin,
                                                  band.shape[0]))
    return flow[keep0:keep0 + band.shape[0]], SpatialStream(exp)


def farneback_spatial(prev: torch.Tensor, nxt: torch.Tensor,
                      p: FarnebackParams, mesh: Mesh,
                      halo: int = 128) -> torch.Tensor:
    """Dense flow with frame rows split over the mesh's 'space' axis.

    prev / nxt: this rank's (band, W) row bands of the two frames (every
    rank of the row passes the same band height; ``shard_streams`` checks
    that the frame height divides). Returns this band's flow (band, W, 2)
    float32. The halo is exchanged with the two ring neighbours only, so
    it must fit in one band. Both engines keep the interior within float
    noise of one process's farneback (the slab passes its place in the
    frame, so the block grids are the frame's; the clamped slabs also
    sum the fused engine's bases over the group)."""
    if prev.shape != nxt.shape or prev.dtype != nxt.dtype:
        raise ValueError(f"prev {prev.dtype} {tuple(prev.shape)} and nxt "
                         f"{nxt.dtype} {tuple(nxt.shape)} differ")
    n, band = mesh.space, prev.shape[0]
    if halo > band:
        raise ValueError(
            f"halo={halo} exceeds the per-shard row band ({band}); use a "
            f"smaller halo, fewer shards, or a taller frame")
    if n == 1:
        # One shard: no halo to exchange, and plain farneback is the
        # exact answer.
        return farneback(prev.float(), nxt.float(), p)
    slab, keep0, origin = slab_of(torch.stack([prev, nxt]), halo, mesh)
    place = _frame_slab(mesh, origin, band) if 2 * halo <= band else \
        Slab(origin, n * band)
    return farneback(slab[0].float(), slab[1].float(), p,
                     slab=place)[keep0:keep0 + band]
