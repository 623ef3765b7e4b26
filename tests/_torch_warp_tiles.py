"""Inputs and helpers shared by the ``test_torch_warp_tiles_*.py`` files:
K8 (warp_tiles) in one launch per call, on the CPU: its host plan, its
base-sum order, its tile counts and its channel counts.

K8 runs one thread-block cluster of S CTAs per tile (``tiles_plan``); CTA
r of a tile sums the flow of its rows [r * th // S, (r + 1) * th // S) in
double (16-byte units of the flow array, unit k to thread k mod T, each
thread in that order, a shuffle tree, the warps in order), the CTAs
exchange their slab sums and add them in rank order, and every CTA samples
its rows at the base. These tests:

- walk the plan over every level of the tiled engine's 640x480 pyramid,
  both ``bench_warp`` 1080p geometries and a ragged 75x107 frame: every
  pixel covered by exactly one CTA, S within the card's cluster limits;
- emulate that sum order on the CPU and hold the base it gives to
  ``tile_bases_plain`` bit for bit, clamped and half-to-even tiles
  included, and the kernel's in-kernel tile count to ``frame_counts``;
- hold the plain version and the port's ``_warp5_tiled`` to JAX's
  ``_warp5_tiled`` for 1 and 3 channels (dense_lk's gray table at bres 2,
  feature_stab's colour frame at bres 6): values within 1e-5 of the
  channel's scale (the TPU form sums (2*bres+1)^2 taps, the port the two
  nonzero ones per axis), ``inside`` identical;
- and, on a card (marker ``cuda``), K8 against its plain version bit for
  bit for C = 1, 3 and 5.
"""

import numpy as np
import torch

from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb
from ripcurrents_tpu_torch.flow import fused_update as fu
from ripcurrents_tpu_torch.flow import warp_kernel as wk

REL = 1e-5

# Clusters of K8 an NVIDIA H100 80GB HBM3 holds at once, by CTA size and
# cluster size (``tile_clusters``, printed by chip_smoke.py [1]), and a
# card that holds no 16-CTA cluster.
H100 = {128: {1: 1056, 2: 528, 4: 248, 8: 124, 16: 58},
        256: {1: 528, 2: 264, 4: 124, 8: 62, 16: 28},
        512: {1: 264, 2: 132, 4: 62, 8: 30, 16: 14}}
NO16 = {t: {**a, 16: 0} for t, a in H100.items()}


def _tiled_levels(h, w):
    """((lh, lw), tile) of every level of the tiled engine's pyramid."""
    p = FarnebackParams.subtract_average()
    out = []
    for k in range(p.levels, -1, -1):
        _, lh, lw, _, _ = tfb._level_geometry(h, w, p, k)
        out.append(((lh, lw), tfb._adaptive_tile(lh, lw, p.warp_tile)))
    return out


GEOMETRIES = {
    "tiled 640x480": _tiled_levels(480, 640),
    "bench_warp 1080p": [((1080, 1920), (120, 384)),
                         ((1080, 1920), (120, 640))],
    "ragged 75x107": [((75, 107), (64, 256)), ((75, 107), (24, 128))],
}


def _slabs(plan, th, tw, h, w):
    """Each CTA's (rows, cols) of the frame, as the kernel derives them."""
    s, ntx, nty = plan["grid"]
    for ty in range(nty):
        for tx in range(ntx):
            for r in range(s):
                y0, x0 = ty * th, tx * tw
                ya, yb = y0 + r * th // s, min(y0 + (r + 1) * th // s, h)
                yield (ya, max(ya, yb)), (x0, min(x0 + tw, w))


def _threads(th, tw, w, s):
    """The least CTA size that gives a thread at most PIX_PER_THREAD
    pixels of the largest slab of S = s, else the largest."""
    pixels = -(-th // s) * min(tw, w)
    fit = [t for t in wk.THREADS if t * wk.PIX_PER_THREAD >= pixels]
    return fit[0] if fit else wk.THREADS[-1]


def _check_plan(plan, hw, tile, active):
    (h, w), (th, tw) = hw, tile
    s, t = plan["S"], plan["threads"]
    tiles = -(-h // th) * -(-w // tw)
    assert s & (s - 1) == 0 and 1 <= s <= min(fu.MAX_CLUSTER, th)
    assert plan["ctas"] == tiles * s and plan["grid"][0] == s
    assert t == _threads(th, tw, w, s) and t % 32 == 0
    # every cluster resident at once, and S the largest such power of two
    assert s == 1 or tiles <= active[t][s]
    s2 = 2 * s
    assert s2 > min(fu.MAX_CLUSTER, th) or \
        tiles > active[_threads(th, tw, w, s2)][s2]
    cover = np.zeros((h, w), np.int32)
    for (ya, yb), (xa, xb) in _slabs(plan, th, tw, h, w):
        cover[ya:yb, xa:xb] += 1
    assert (cover == 1).all()


def _units(flow_cf, ya, yb, xa, xb, halo):
    """The float4 units a CTA of rows [ya, yb) x columns [xa, xb) sums,
    in the kernel's order, as (n, 4) (dx, dy) pairs per float: frame
    layout, the (h, w, 2) array's aligned units over each row's floats
    (others' floats zero); halo layout, 4 columns of both planes."""
    _, h, w = flow_cf.shape
    f = flow_cf.double().numpy()
    if halo:
        blk = f[:, ya:yb, xa:xb].reshape(2, -1, 4)      # (2, units, 4)
        return blk[0], blk[1]
    flat = np.ascontiguousarray(f.transpose(1, 2, 0)).reshape(-1)
    upr = (2 * (xb - xa) + 3) // 4 + 1
    vx, vy = [], []
    for y in range(ya, yb):
        lo = 2 * (y * w + xa)
        hi = lo + 2 * (xb - xa)
        for j in range(upr):
            f0 = (lo & ~3) + 4 * j
            v = [flat[i] if lo <= i < hi else 0.0 for i in range(f0, f0 + 4)]
            vx.append([v[0], v[2]])
            vy.append([v[1], v[3]])
    return np.array(vx).reshape(-1, 2), np.array(vy).reshape(-1, 2)


def _emulated_bases(flow_cf, th, tw, plan, counts, lim_x, lim_y, halo):
    """The kernel's base of every tile, its sums taken in its order:
    per thread t over units t, t + T, ... of its slab (each unit's floats
    in order), __shfl_down trees over each warp's 32 lanes, the warps in
    order, the slabs in rank order."""
    _, h, w = flow_cf.shape
    s, ntx, nty = plan["grid"]
    t = plan["threads"]
    sums = np.zeros((2, nty, ntx))
    for i, ((ya, yb), (xa, xb)) in enumerate(_slabs(plan, th, tw, h, w)):
        ty, tx = divmod(i // s, ntx)
        ux, uy = _units(flow_cf, ya, yb, xa, xb, halo)
        acc = np.zeros((2, t))
        for k0 in range(0, len(ux), t):                 # per thread, in order
            gx, gy = ux[k0:k0 + t], uy[k0:k0 + t]
            for j in range(gx.shape[1]):
                acc[0, :len(gx)] += gx[:, j]
                acc[1, :len(gy)] += gy[:, j]
        lanes = acc.reshape(2, t // 32, 32)
        for o in (16, 8, 4, 2, 1):
            shifted = np.concatenate([lanes[..., o:], lanes[..., 32 - o:]],
                                     axis=-1)
            lanes = lanes + shifted
        slab = np.zeros(2)
        for wsum in lanes[..., 0].T:                   # the warps in order
            slab = slab + wsum
        sums[:, ty, tx] += slab                        # ranks in order
    q = np.rint(sums.astype(np.float32) / counts.numpy())   # half to even
    lim = np.array([lim_x, lim_y], np.float32)[:, None, None]
    return np.minimum(np.maximum(q, -lim), lim)


def _flows(h, w, seed):
    """Flow (2, h, w): N(0, 3) plus a smooth field, and tiles made to hit
    a half-to-even tie (constant 2.5 / -1.5, exact in any sum order) and
    the base clamp (constant 40)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = np.stack([rng.normal(0, 3, (h, w)) + 6 * np.sin(xx / 50.0),
                  rng.normal(0, 3, (h, w)) - 4 * np.cos(yy / 40.0)])
    f[:, :24, :128] = np.array([2.5, -1.5])[:, None, None]
    f[:, 24:48, :128] = 40.0
    return torch.from_numpy(f.astype(np.float32))


def _kernel_counts(h, w, th, tw):
    """The kernel's tile count: (min(y0 + th, h) - y0) * (min(x0 + tw, w)
    - x0), at least 1 (csrc/warp_tiles.cu, frame layout)."""
    out = np.zeros((-(-h // th), -(-w // tw)), np.float32)
    for ty in range(out.shape[0]):
        for tx in range(out.shape[1]):
            y0, x0 = ty * th, tx * tw
            out[ty, tx] = max((min(y0 + th, h) - y0) * (min(x0 + tw, w) - x0),
                              1)
    return out
