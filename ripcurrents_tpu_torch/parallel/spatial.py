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
Two bounded deviations from the single-device result:

- the engines' block grids depend on the level's size (the fused
  engine's row tiles ``fused_update._row_tile``, the tiled warp's
  ``farneback._adaptive_tile``). Keep `halo` a multiple of the warp tile
  height (64 by default) so the slab's tile grid aligns with the full
  frame's; a misaligned grid shifts the per-tile warp bases and
  ill-conditioned pixels can flip (a few percent tail);
- with the replicate-pad slabs (band / 2 < halo <= band) the frame's
  outermost rows see the border ramp at the slab edge instead of the
  true frame edge. The clamped slabs (2 * halo <= band) put the true
  frame edge at the slab edge on the edge ranks.

A 'space' group on gloo (ranks sharing a card) takes CPU tensors only,
so its halo rows are staged through host memory; on NCCL they move as
device tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow.farneback import farneback
from ripcurrents_tpu_torch.parallel.mesh import Mesh


def exchange_rows(mesh: Mesh, x: torch.Tensor, rows: int):
    """Swap `rows` boundary rows of x (..., band, W) with the ring
    neighbours on the 'space' axis: this rank's first rows go to the
    previous rank and its last rows to the next. -> (the previous rank's
    last rows, the next rank's first rows), each None on the frame's
    edge (the outermost ranks send nothing around the ring)."""
    n, idx = mesh.space, mesh.coords["space"]
    staged = x.device.type != "cpu" and \
        dist.get_backend(mesh.group) == dist.Backend.GLOO
    send = x.cpu() if staged else x
    shape = x.shape[:-2] + (rows, x.shape[-1])
    ops, got = [], {}
    for side, j, rows_out in (("above", idx - 1, send[..., :rows, :]),
                              ("below", idx + 1, send[..., -rows:, :])):
        if 0 <= j < n:
            peer = mesh.rank - idx + j
            got[side] = torch.empty(shape, dtype=send.dtype,
                                    device=send.device)
            ops += [dist.P2POp(dist.isend, rows_out.contiguous(), peer,
                               mesh.group),
                    dist.P2POp(dist.irecv, got[side], peer, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        got = {k: v.to(x.device) for k, v in got.items()}
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


def farneback_spatial(prev: torch.Tensor, nxt: torch.Tensor,
                      p: FarnebackParams, mesh: Mesh,
                      halo: int = 128) -> torch.Tensor:
    """Dense flow with frame rows split over the mesh's 'space' axis.

    prev / nxt: this rank's (band, W) row bands of the two frames (every
    rank of the row passes the same band height; ``shard_streams`` checks
    that the frame height divides). Returns this band's flow (band, W, 2)
    float32. The halo is exchanged with the two ring neighbours only, so
    it must fit in one band. The tiled engine (warp_impl="tiled") keeps
    the interior within float noise of one process's farneback; the
    fused engine, windowed()'s default, does not yet (its row tiles
    follow the slab's height: at 1080p on 2 ranks 8.8% of interior
    pixels differ by more than 0.1 px)."""
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
    x = torch.stack([prev, nxt])
    if 2 * halo <= band:
        slab, keep0 = _clamped_slab(x, halo, mesh)
        return farneback(slab[0].float(), slab[1].float(),
                         p)[keep0:keep0 + band]
    slab = _exchange_halo(x, halo, mesh)
    return farneback(slab[0].float(), slab[1].float(), p)[halo:-halo]
