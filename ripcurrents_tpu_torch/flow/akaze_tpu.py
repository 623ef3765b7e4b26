"""AKAZE-class features: nonlinear scale space, det-Hessian keypoints,
rotated binary descriptors (port of ``ripcurrents_tpu/flow/akaze_tpu.py``).

The reference's stabilize mode detects cv::AKAZE keypoints
(RipCurrents_main/main.cpp:1598-1652). This module follows the published
AKAZE recipe (Alcantarilla et al.), not OpenCV's implementation, with
dense tensor pieces:

- **nonlinear scale space**: Perona-Malik g2 diffusion in explicit Euler
  steps (tau = 0.23 < 0.25), each a 4-neighbour stencil with a replicate
  border; the contrast factor is the 70th percentile of the nonzero
  gradient magnitude. Octaves run the same steps at halved resolution.
- **detection**: scale-normalized det(Hessian) per evolution level, 3x3
  strict-max suppression and the adjacent-scale test, then one top-k
  across all levels.
- **orientation**: the intensity centroid (Rosin moments) over an 11x11
  disc of the diffused image at the keypoint's level.
- **descriptor**: M-LDB style: (intensity, dx, dy) sampled at a rotated
  4x4 cell grid scaled by the keypoint size, binarized by a fixed
  comparison-pair table and stored as +-1/16 rows, so Hamming matching
  is one matrix product (``feature_stab.match_descriptors``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ripcurrents_tpu_torch.flow.farneback import _grid
from ripcurrents_tpu_torch.flow.feature_stab import _interior, _strict_max3
from ripcurrents_tpu_torch.ops.conv import sep_filter2d


class Keypoints(NamedTuple):
    xy: torch.Tensor      # (N, 2) float32 (x, y) at base-image resolution
    score: torch.Tensor   # (N,) det-Hessian response (-inf for padding)
    size: torch.Tensor    # (N,) sigma at base resolution
    angle: torch.Tensor   # (N,) orientation, radians


def _gauss1d(sigma: float) -> np.ndarray:
    r = max(int(round(3 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _scharr_pair():
    d = np.asarray([-1.0, 0.0, 1.0], np.float32) * np.float32(0.5)
    s = np.asarray([3.0, 10.0, 3.0], np.float32) / np.float32(16.0)
    return d, s


def _grad(img: torch.Tensor):
    d, s = _scharr_pair()
    gx = sep_filter2d(img, s, d, border="replicate")
    gy = sep_filter2d(img, d, s, border="replicate")
    return gx, gy


def _pm_g2(gx, gy, k2):
    return 1.0 / (1.0 + (gx * gx + gy * gy) / k2)


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]


def _diffuse(img: torch.Tensor, k2: torch.Tensor, steps: int,
             tau: float) -> torch.Tensor:
    """`steps` explicit Perona-Malik steps; the conductivity is refreshed
    each step from the evolving image (4-neighbour stencil, replicate
    border)."""
    h, w = img.shape
    lv = img
    for _ in range(steps):
        gx, gy = _grad(lv)
        g = _pm_g2(gx, gy, k2)
        lp = _edge_pad(lv)
        gp = _edge_pad(g)

        def nb(dy, dx):
            return (lp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w],
                    gp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
        le, ge = nb(0, 1)
        lw_, gw_ = nb(0, -1)
        ls, gs = nb(1, 0)
        ln, gn = nb(-1, 0)
        div = (0.5 * (ge + g) * (le - lv) + 0.5 * (gw_ + g) * (lw_ - lv) +
               0.5 * (gs + g) * (ls - lv) + 0.5 * (gn + g) * (ln - lv))
        lv = lv + tau * div
    return lv


def _det_hessian(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Scale-normalized determinant of the Hessian, sigma^4 (Lxx Lyy -
    Lxy^2), second derivatives as chained Scharr first derivatives."""
    gx, gy = _grad(img)
    gxx, gxy = _grad(gx)
    _, gyy = _grad(gy)
    return (sigma ** 4) * (gxx * gyy - gxy * gxy)


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean pooling (the octave step)."""
    h, w = img.shape
    return img[:h - h % 2, :w - w % 2].reshape(
        h // 2, 2, w // 2, 2).mean(dim=(1, 3))


@functools.lru_cache(maxsize=8)
def _ldb_pairs(n_cells: int, n_bits: int, seed: int = 7) -> np.ndarray:
    """Fixed channel-consistent comparison-pair table: n_bits pairs
    (i, j, c) comparing channel c of cell i vs cell j (i != j)."""
    rng = np.random.default_rng(seed)
    pairs = set()
    out = []
    while len(out) < n_bits:
        i, j = rng.integers(0, n_cells, 2)
        c = int(rng.integers(0, 3))
        if i == j or (i, j, c) in pairs or (j, i, c) in pairs:
            continue
        pairs.add((i, j, c))
        out.append((i, j, c))
    return np.asarray(out, np.int32)


# Descriptor geometry: 4x4 cell grid, cell centres at +-{0.5, 1.5} *
# cell pitch, the pitch scaling with the keypoint size.
_GRID = np.stack(np.meshgrid((np.arange(4) - 1.5), (np.arange(4) - 1.5),
                             indexing="ij"), -1).reshape(16, 2)  # (y, x)


def _bilinear(img: torch.Tensor, y: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """img sampled bilinearly at (y, x), both clamped to [0, size -
    1.001] so the four taps stay inside."""
    h, w = img.shape
    y = torch.clamp(y, 0.0, h - 1.001)
    x = torch.clamp(x, 0.0, w - 1.001)
    y0 = torch.floor(y).to(torch.int32)
    x0 = torch.floor(x).to(torch.int32)
    fy = y - y0
    fx = x - x0
    y0, x0 = y0.long(), x0.long()
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * (1 - fx) * v00 + (1 - fy) * fx * v01 +
            fy * (1 - fx) * v10 + fy * fx * v11)


class _Level(NamedTuple):
    img: torch.Tensor     # diffused image at octave resolution
    gx: torch.Tensor
    gy: torch.Tensor
    resp: torch.Tensor    # det-Hessian response
    sigma: float          # at base resolution
    octave: int           # 2**octave = coordinate scale factor


def _build_levels(base: torch.Tensor, octaves: int, sublevels: int,
                  sigma0: float, tau: float, k2: torch.Tensor):
    """The nonlinear scale space: per octave, `sublevels` diffusion stops
    at evolution times t_i = sigma_i^2 / 2, sigma_i = sigma0 * 2^(o +
    s/S); the step count of each stop is fixed on the host."""
    levels = []
    img = base
    t_prev = 0.5 * sigma0 ** 2
    for o in range(octaves):
        for s in range(sublevels):
            sigma = sigma0 * 2.0 ** (o + (s + 1) / sublevels)
            t = 0.5 * sigma ** 2
            # evolution time at octave resolution scales by 4^-o
            steps = max(int(math.ceil((t - t_prev) * (0.25 ** o) / tau)), 1)
            img = _diffuse(img, k2, steps, tau)
            t_prev = t
            gx, gy = _grad(img)
            resp = _det_hessian(img, sigma * (0.5 ** o))
            levels.append(_Level(img, gx, gy, resp, sigma, o))
        if o + 1 < octaves:
            img = _downsample2(img)
    return levels


def _oct_to_base(v, octave: int):
    """Octave-pixel coordinate -> base-image coordinate (2x2 mean pooling
    puts octave pixel i at base position 2i + 0.5 per halving)."""
    sc = 2.0 ** octave
    return v * sc + 0.5 * (sc - 1.0)


def _base_to_oct(v, octave: int):
    s = 0.5 ** octave
    return (v + 0.5) * s - 0.5


def _select(lvl: torch.Tensor, per_level: list) -> torch.Tensor:
    """per_level[lvl[i]][i] for each keypoint i (``jnp.select`` over
    mutually exclusive levels)."""
    out = torch.zeros_like(per_level[0])
    for li in range(len(per_level) - 1, -1, -1):
        cond = (lvl == li).reshape((-1,) + (1,) * (out.dim() - 1))
        out = torch.where(cond, per_level[li], out)
    return out


def _refine(resp: torch.Tensor, octave: int, xy: torch.Tensor):
    """Sub-pixel offsets (N, 2) in base pixels: a 2-D quadratic fit of
    the response's 3x3 neighbourhood at each keypoint's rounded octave
    pixel (clamped inside), clamped to +-0.6 octave pixels, zero where
    the fit's determinant vanishes."""
    h, w = resp.shape
    y = torch.clamp(torch.round(_base_to_oct(xy[:, 1], octave))
                    .to(torch.int32), 1, h - 2).long()
    x = torch.clamp(torch.round(_base_to_oct(xy[:, 0], octave))
                    .to(torch.int32), 1, w - 2).long()

    def r(dy, dx):
        return resp[y + dy, x + dx]
    gx_ = 0.5 * (r(0, 1) - r(0, -1))
    gy_ = 0.5 * (r(1, 0) - r(-1, 0))
    hxx = r(0, 1) - 2.0 * r(0, 0) + r(0, -1)
    hyy = r(1, 0) - 2.0 * r(0, 0) + r(-1, 0)
    hxy = 0.25 * (r(1, 1) - r(1, -1) - r(-1, 1) + r(-1, -1))
    det = hxx * hyy - hxy * hxy
    ok = torch.abs(det) > 1e-18
    ox_ = torch.where(ok, -(hyy * gx_ - hxy * gy_) / det, 0.0)
    oy_ = torch.where(ok, -(hxx * gy_ - hxy * gx_) / det, 0.0)
    ox_ = torch.clamp(ox_, -0.6, 0.6)
    oy_ = torch.clamp(oy_, -0.6, 0.6)
    return torch.stack([ox_, oy_], dim=-1) * (2.0 ** octave)


def detect(gray: torch.Tensor, n: int = 256, octaves: int = 2,
           sublevels: int = 3, sigma0: float = 1.6,
           threshold: float = 1e-4, border: int = 10) -> tuple:
    """AKAZE-class keypoints of an (H, W) uint8 or float image.

    Returns (Keypoints, (levels, keypoint levels)); `describe` reuses the
    second."""
    dev = gray.device
    f = gray.to(torch.float32) / 255.0
    g0 = _gauss1d(sigma0)
    base = sep_filter2d(f, g0, g0, border="replicate")
    gx, gy = _grad(base)
    mag = torch.sqrt(gx * gx + gy * gy)
    # contrast factor: the 70th percentile of the NONZERO gradient
    # magnitude (flat-region zeros would drag it toward 0)
    nz = torch.where(mag > 1e-6, mag, math.nan)
    k = torch.nanquantile(nz.reshape(-1), 0.7)
    k = torch.where(torch.isnan(k), 1e-3, k)       # a flat frame
    k2 = torch.clamp(k * k, min=1e-8)
    levels = _build_levels(base, octaves, sublevels, sigma0, 0.23, k2)

    cand_scores, cand_xy, cand_size, cand_lvl = [], [], [], []
    for li, lv in enumerate(levels):
        r = lv.resp
        h, w = r.shape
        is_max = _strict_max3(r)
        # adjacent-scale check within the same octave resolution
        for m in (levels[li - 1] if li > 0 else None,
                  levels[li + 1] if li + 1 < len(levels) else None):
            if m is not None and m.octave == lv.octave:
                is_max = is_max & (r >= m.resp)
        b = max(border >> lv.octave, 3)
        keep = is_max & _interior(h, w, b, dev) & (r > threshold)
        cand_scores.append(torch.where(keep, r, -math.inf).reshape(-1))
        ys, xs = _grid(h, w, dev)
        cand_xy.append(torch.stack(
            [_oct_to_base(xs.reshape(-1), lv.octave),
             _oct_to_base(ys.reshape(-1), lv.octave)], dim=-1))
        cand_size.append(torch.full((h * w,), lv.sigma, device=dev))
        cand_lvl.append(torch.full((h * w,), li, dtype=torch.int32,
                                   device=dev))
    top, idx = torch.topk(torch.cat(cand_scores), n)
    kp_xy = torch.cat(cand_xy)[idx]
    kp_size = torch.cat(cand_size)[idx]
    kp_lvl = torch.cat(cand_lvl)[idx]

    kp_xy = kp_xy + _select(kp_lvl, [_refine(lv.resp, lv.octave, kp_xy)
                                     for lv in levels])

    # Orientation: intensity centroid (Rosin) over an 11x11 disc of the
    # keypoint's level's diffused image.
    rad = 5
    oy, ox = np.meshgrid(np.arange(-rad, rad + 1), np.arange(-rad, rad + 1),
                         indexing="ij")
    disc = torch.from_numpy((oy * oy + ox * ox <= rad * rad)
                            .astype(np.float32).reshape(-1)).to(dev)
    oyt = torch.from_numpy(oy.reshape(-1).astype(np.float32)).to(dev)
    oxt = torch.from_numpy(ox.reshape(-1).astype(np.float32)).to(dev)

    def orient(lv: _Level) -> torch.Tensor:
        y = _base_to_oct(kp_xy[:, 1:2], lv.octave) + oyt
        x = _base_to_oct(kp_xy[:, 0:1], lv.octave) + oxt
        v = _bilinear(lv.img, y, x) * disc
        return torch.atan2(torch.sum(v * oyt, dim=1),
                           torch.sum(v * oxt, dim=1))

    angle = _select(kp_lvl, [orient(lv) for lv in levels])
    return Keypoints(kp_xy, top, kp_size, angle), (levels, kp_lvl)


def describe(kps: Keypoints, ctx, n_bits: int = 256) -> torch.Tensor:
    """M-LDB-style binary descriptors as (N, n_bits) +-1/sqrt(n_bits)
    rows: (intensity, rotated dx, rotated dy) point-sampled at the 16
    rotated cell centres of each keypoint on its level's diffused image,
    binarized by the fixed comparison-pair table."""
    levels, kp_lvl = ctx
    dev = kps.xy.device
    pairs = torch.from_numpy(_ldb_pairs(16, n_bits)).long().to(dev)
    grid = torch.from_numpy(_GRID.astype(np.float32)).to(dev)

    def feats(lv: _Level) -> torch.Tensor:
        s = 0.5 ** lv.octave
        pitch = torch.clamp(kps.size * s, min=1.0)[:, None] * 1.5
        ca = torch.cos(kps.angle)[:, None]
        sa = torch.sin(kps.angle)[:, None]
        gy_u = grid[None, :, 0] * pitch
        gx_u = grid[None, :, 1] * pitch
        y = _base_to_oct(kps.xy[:, 1:2], lv.octave) + (sa * gx_u + ca * gy_u)
        x = _base_to_oct(kps.xy[:, 0:1], lv.octave) + (ca * gx_u - sa * gy_u)
        vi = _bilinear(lv.img, y, x)
        vx = _bilinear(lv.gx, y, x)
        vy = _bilinear(lv.gy, y, x)
        # rotate the gradients into the keypoint frame
        rx = ca * vx + sa * vy
        ry = -sa * vx + ca * vy
        return torch.stack([vi, rx, ry], dim=1)           # (N, 3, 16)

    f = _select(kp_lvl, [feats(lv) for lv in levels])
    a = f[:, pairs[:, 2], pairs[:, 0]]
    b = f[:, pairs[:, 2], pairs[:, 1]]
    bits = torch.where(a > b, 1.0, -1.0)
    return bits / np.float32(np.sqrt(n_bits))


def detect_and_describe(gray: torch.Tensor, n: int = 256, octaves: int = 2,
                        sublevels: int = 3):
    """Nonlinear scale space -> keypoints -> binary descriptors. Returns
    (Keypoints, (N, 256) +-1/16 rows)."""
    kps, ctx = detect(gray, n=n, octaves=octaves, sublevels=sublevels)
    return kps, describe(kps, ctx)
