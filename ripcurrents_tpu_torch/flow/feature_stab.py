"""Feature-based stabilization on the device (port of
``ripcurrents_tpu/flow/feature_stab.py``).

The reference stabilizes with AKAZE keypoints, brute-force cross-matching,
a RANSAC homography and an inverse warpPerspective (main.cpp:1556-1682).
This module does the same with dense tensor pieces:

- Harris corners: separable derivative and box filters, a 3x3 strict-max
  non-max suppression and one ``torch.topk``;
- descriptors: mean/std-normalized 8x8 patches, gathered for all corners
  at once, matched by one (N, 64) x (64, N) product, the mutual-nearest
  check and a ratio test (the reference's cross-check match,
  main.cpp:1605-1621);
- homography: fixed-trip RANSAC, every trial's 4-point DLT in one batched
  SVD and one inlier vote, refined on all inliers;
- correction: the near-identity homography becomes a displacement field,
  applied by the tiled base + residual warp ``farneback._warp5_tiled``
  (kernel K8 in its frame layout on the card).

Randomness. The RANSAC samples are 4 correspondences per trial picked by
the Gumbel top-k trick from noise ``-log(-log(U))``, U in (0, 1) as
``jax.random.gumbel`` draws it. The noise comes from an explicit
``torch.Generator`` on the step's device (``step_generator``); the stream
differs from JAX's, and a CUDA generator's from a CPU one's. Callers that
need given samples pass ``noise`` (trials, n) or ``sel`` (trials, 4) to
``ransac_homography`` / ``stabilize_pair`` instead.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ripcurrents_tpu_torch.flow.farneback import _grid, _warp5_tiled
from ripcurrents_tpu_torch.ops.conv import sep_filter2d

FEATURES = ("harris", "akaze")


class Corners(NamedTuple):
    xy: torch.Tensor       # (N, 2) float32 corner coordinates (x, y)
    score: torch.Tensor    # (N,) response (<= 0 or -inf for padded entries)


def _strict_max3(resp: torch.Tensor) -> torch.Tensor:
    """resp > the max of its 8 neighbours, the frame padded with -inf."""
    h, w = resp.shape
    pad = F.pad(resp, (1, 1, 1, 1), value=-math.inf)
    neigh = torch.stack([pad[dy:dy + h, dx:dx + w]
                         for dy in range(3) for dx in range(3)
                         if not (dy == 1 and dx == 1)])
    return resp > neigh.amax(dim=0)


def _interior(h: int, w: int, border: int, device) -> torch.Tensor:
    ys, xs = _grid(h, w, device)
    return (xs >= border) & (xs < w - border) & (ys >= border) & \
        (ys < h - border)


def harris_corners(img: torch.Tensor, n: int = 256, k: float = 0.04,
                   border: int = 12) -> Corners:
    """Top-n Harris corners of an (H, W) image with 3x3 non-max
    suppression. Entries past the last strict maximum score -inf."""
    f = img.to(torch.float32)
    d = (-0.5, 0.0, 0.5)
    s = (0.25, 0.5, 0.25)
    ix = sep_filter2d(f, s, d, border="replicate")
    iy = sep_filter2d(f, d, s, border="replicate")
    box = np.ones(5, np.float32) / np.float32(5.0)
    sxx = sep_filter2d(ix * ix, box, box, border="replicate")
    syy = sep_filter2d(iy * iy, box, box, border="replicate")
    sxy = sep_filter2d(ix * iy, box, box, border="replicate")
    resp = (sxx * syy - sxy * sxy) - k * (sxx + syy) ** 2
    h, w = resp.shape
    keep = _strict_max3(resp) & _interior(h, w, border, resp.device)
    masked = torch.where(keep, resp, -math.inf)
    score, idx = torch.topk(masked.reshape(-1), n)
    xy = torch.stack([(idx % w).to(torch.float32),
                      (idx // w).to(torch.float32)], dim=-1)
    return Corners(xy, score)


def patch_descriptors(img: torch.Tensor, xy: torch.Tensor,
                      patch: int = 8) -> torch.Tensor:
    """Mean/std-normalized patch descriptors, (N, patch*patch): each
    corner's patch starts at its truncated position less patch // 2,
    clamped into the frame, and all N patches are gathered at once."""
    f = img.to(torch.float32)
    h, w = f.shape
    half = patch // 2
    y0 = torch.clamp(xy[:, 1].to(torch.int32) - half, 0, h - patch)
    x0 = torch.clamp(xy[:, 0].to(torch.int32) - half, 0, w - patch)
    off = torch.arange(patch, device=f.device, dtype=torch.int32)
    rows = (y0[:, None] + off[None, :])[:, :, None]          # (N, p, 1)
    cols = (x0[:, None] + off[None, :])[:, None, :]          # (N, 1, p)
    d = f[rows.long(), cols.long()].reshape(xy.shape[0], patch * patch)
    d = d - d.mean(dim=1, keepdim=True)
    rms = torch.sqrt((d * d).mean(dim=1, keepdim=True))
    return d / torch.clamp(rms, min=1e-3)


def match_descriptors(da: torch.Tensor, db: torch.Tensor,
                      valid_a: torch.Tensor, valid_b: torch.Tensor,
                      max_ratio: float = 0.9):
    """Mutual-nearest matches by correlation (one matrix product).

    Returns (idx_b_for_a (N,), good (N,) bool)."""
    sim = da @ db.T
    sim = torch.where(valid_b[None, :], sim, -math.inf)
    sim = torch.where(valid_a[:, None], sim, -math.inf)
    best_ab = torch.argmax(sim, dim=1)
    best_ba = torch.argmax(sim, dim=0)
    mutual = best_ba[best_ab] == torch.arange(sim.shape[0],
                                              device=sim.device)
    top2 = torch.topk(sim, 2, dim=1).values
    distinct = top2[:, 1] < top2[:, 0] * max_ratio
    good = mutual & distinct & valid_a & (top2[:, 0] > 0.2)
    return best_ab, good


def _hartley(pts: torch.Tensor, w: torch.Tensor):
    """Weighted Hartley normalization of pts (..., M, 2) with weights
    (..., M): the weighted centroid goes to the origin and the mean
    radius to sqrt(2). Returns (normalized pts, s (...,), c (..., 2)):
    T = [[s, 0, -s cx], [0, s, -s cy], [0, 0, 1]]."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)
    c = (pts * w[..., None]).sum(-2) / wsum[..., None]
    d = (torch.linalg.vector_norm(pts - c[..., None, :], dim=-1) *
         w).sum(-1) / wsum
    s = math.sqrt(2.0) / torch.clamp(d, min=1e-9)
    return (pts - c[..., None, :]) * s[..., None, None], s, c


def _similarity(s: torch.Tensor, tx: torch.Tensor,
                ty: torch.Tensor) -> torch.Tensor:
    """[[s, 0, tx], [0, s, ty], [0, 0, 1]] for batched s, tx, ty."""
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    return torch.stack([torch.stack([s, z, tx], -1),
                        torch.stack([z, s, ty], -1),
                        torch.stack([z, z, o], -1)], -2)


def _dlt_homography(src: torch.Tensor, dst: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Weighted, Hartley-normalized DLT: the homography (..., 3, 3)
    mapping src -> dst from >= 4 weighted correspondences src, dst
    (..., M, 2) with weights (..., M); batched over the leading dims, so
    RANSAC's trials take one SVD. The result is T_dst^-1 Hn T_src."""
    src_n, s_s, c_s = _hartley(src, w)
    dst_n, s_d, c_d = _hartley(dst, w)
    x, y = src_n[..., 0], src_n[..., 1]
    u, v = dst_n[..., 0], dst_n[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    rows2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=-1)
    a = torch.cat([rows1 * w[..., None], rows2 * w[..., None]], dim=-2)
    # The null vector needs the full V: with 4 points A is (8, 9), and
    # the economy SVD's last row would be the smallest range-space vector.
    _, _, vh = torch.linalg.svd(a, full_matrices=True)
    hn = vh[..., -1, :].reshape(vh.shape[:-2] + (3, 3))
    t_s = _similarity(s_s, -s_s * c_s[..., 0], -s_s * c_s[..., 1])
    # T_d^-1 analytically: [[1/s, 0, cx], [0, 1/s, cy], [0, 0, 1]]
    td_inv = _similarity(1.0 / s_d, s_d * c_d[..., 0] / s_d,
                         s_d * c_d[..., 1] / s_d)
    return td_inv @ hn @ t_s


def _apply_h(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """pts (M, 2) mapped by h (..., 3, 3) -> (..., M, 2)."""
    p = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=-1)
    q = p @ h.transpose(-1, -2)
    qz = q[..., 2:]
    return q[..., :2] / torch.clamp(torch.abs(qz), min=1e-9) * \
        torch.sign(qz)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The RANSAC generator of one stream step: a ``torch.Generator`` on
    `device` seeded from (seed, step), so a step is a function of its
    inputs alone."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(np.random.SeedSequence([seed, step])
                      .generate_state(1, np.uint64)[0]) >> 1)
    return g


def gumbel_noise(generator: torch.Generator, trials: int, n: int,
                 device) -> torch.Tensor:
    """(trials, n) standard Gumbel noise -log(-log(U)), U uniform in
    [tiny, 1) as ``jax.random.gumbel`` draws it, from `generator`."""
    u = torch.rand((trials, n), generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def ransac_homography(src: torch.Tensor, dst: torch.Tensor,
                      good: torch.Tensor,
                      generator: "torch.Generator | None" = None,
                      trials: int = 64, thresh: float = 2.0,
                      noise: "torch.Tensor | None" = None,
                      sel: "torch.Tensor | None" = None):
    """Fixed-trip RANSAC + weighted-inlier refinement of the homography
    src -> dst over the `good` correspondences (src, dst (n, 2)).

    Each trial's 4 correspondences are the top 4 of Gumbel noise plus
    -1e9 on the bad ones: `sel` (trials, 4) gives them, else `noise`
    (trials, n), else noise drawn from `generator`. All trials are one
    batched DLT and one inlier vote; the best (first on ties) is refined
    on its inliers. Returns (H (3, 3), inlier count ())."""
    n = src.shape[0]
    gw = good.to(torch.float32)
    if sel is None:
        if noise is None:
            if generator is None:
                raise ValueError("ransac_homography: give a generator, "
                                 "noise or sel")
            noise = gumbel_noise(generator, trials, n, src.device)
        g = noise + torch.where(good, 0.0, -1e9)[None, :]
        sel = torch.topk(g, 4, dim=1).indices
    trials = sel.shape[0]
    hs = _dlt_homography(src[sel], dst[sel],
                         torch.ones(sel.shape, device=src.device))
    err = torch.sum((_apply_h(hs, src) - dst[None]) ** 2, dim=-1)
    inl = (err < thresh * thresh) & good[None, :]
    counts = inl.sum(dim=1)
    # the best trial as a (1,) index tensor: indexing by a 0-d tensor
    # would read it on the host
    best = torch.argmax(counts).reshape(1)
    w = inl.index_select(0, best)[0].to(torch.float32) + 1e-6 * gw
    h_ref = _dlt_homography(src, dst, w)
    h22 = h_ref[2, 2]
    h_ref = h_ref / torch.where(torch.abs(h22) > 1e-9, h22, 1.0)
    return h_ref, counts.index_select(0, best)[0]


def homography_displacement(h_mat: torch.Tensor, height: int,
                            width: int) -> torch.Tensor:
    """Sampling displacement d(x) = H x - x, (H, W, 2) contiguous: a warp
    that reads frame(x + d(x)) produces out(x) = frame(H x)."""
    ys, xs = _grid(height, width, h_mat.device)
    denom = h_mat[2, 0] * xs + h_mat[2, 1] * ys + h_mat[2, 2]
    denom = torch.where(torch.abs(denom) > 1e-9, denom, 1e-9)
    u = (h_mat[0, 0] * xs + h_mat[0, 1] * ys + h_mat[0, 2]) / denom
    v = (h_mat[1, 0] * xs + h_mat[1, 1] * ys + h_mat[1, 2]) / denom
    return torch.stack([u - xs, v - ys], dim=-1)


def warp_by_homography(frame: torch.Tensor,
                       h_mat: torch.Tensor) -> torch.Tensor:
    """out(x) = frame(H x), as cv2.warpPerspective(frame, inv(H)), for a
    near-identity H: the displacement field goes through the tiled base +
    residual warp at bres 6 (exact within +-6 px of each tile's mean
    shift), pixels whose sample leaves the frame are 0, and the result is
    rounded half to even into uint8. frame: (H, W, 3) or (H, W)."""
    hh, ww = frame.shape[0], frame.shape[1]
    disp = homography_displacement(h_mat, hh, ww)
    f = frame.to(torch.float32)
    if f.dim() == 2:
        f = f[..., None]
    out, inside = _warp5_tiled(f, disp, bres=6)
    out = torch.where(inside[..., None], out, 0.0)
    out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out[..., 0] if frame.dim() == 2 else out


def stabilize_pair(prev_gray: torch.Tensor, cur_gray: torch.Tensor,
                   cur_frame: torch.Tensor,
                   generator: "torch.Generator | None" = None,
                   n_corners: int = 256, features: str = "harris",
                   noise: "torch.Tensor | None" = None):
    """One stabilization step: detect and match prev -> cur, fit the
    homography by RANSAC, then warp the current frame back onto prev's
    geometry (main.cpp:1652-1659). Fewer than 8 inliers give the identity
    (a device-side select: no host sync). features: 'harris' (corners
    and patch descriptors) or 'akaze' (``flow/akaze_tpu.py``). RANSAC
    draws from `generator` unless `noise` (64, n_corners) is given.
    Returns (corrected frame, H, inlier count)."""
    if features == "akaze":
        from ripcurrents_tpu_torch.flow.akaze_tpu import detect_and_describe
        ca, da = detect_and_describe(prev_gray, n=n_corners)
        cb, db = detect_and_describe(cur_gray, n=n_corners)
    elif features == "harris":
        ca = harris_corners(prev_gray, n_corners)
        cb = harris_corners(cur_gray, n_corners)
        da = patch_descriptors(prev_gray, ca.xy)
        db = patch_descriptors(cur_gray, cb.xy)
    else:
        raise ValueError(f"features {features!r}: expected one of "
                         f"{FEATURES}")
    idx, good = match_descriptors(da, db, ca.score > 0, cb.score > 0)
    h_mat, n_inl = ransac_homography(ca.xy, cb.xy[idx], good, generator,
                                     noise=noise)
    eye = torch.eye(3, device=h_mat.device)
    h_mat = torch.where(n_inl >= 8, h_mat, eye)
    return warp_by_homography(cur_frame, h_mat), h_mat, n_inl
