"""Particle advection through flow fields (port of
``ripcurrents_tpu/dynamics/advect.py``: streamline(s), streamline_field,
get_delta, delta_field and the synthetic field of the validator;
ripcurrents_module.cpp:486-528, :608-679, main.cpp:303-443).

Every seed (or every pixel's particle) advances at once, with a sticky
`active` flag in place of the reference's early returns. Points are
(x, y) float32; flow is (H, W, 2). A sample at floor(x) outside
[1, W-2] (or floor(y) outside [1, H-2]) stops the particle, as in the
reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def sample_flow(flow: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear flow lookup with the reference's bounds rule.
    Returns (delta (..., 2), valid); delta is 0 where invalid."""
    h, w = flow.shape[0], flow.shape[1]
    xi = torch.floor(x)
    yi = torch.floor(y)
    valid = (xi >= 1) & (yi >= 1) & (xi + 2 <= w) & (yi + 2 <= h)
    xr = (x - xi)[..., None]
    yr = (y - yi)[..., None]
    xc = torch.clamp(xi.to(torch.int32), 0, w - 2).long()
    yc = torch.clamp(yi.to(torch.int32), 0, h - 2).long()
    d = (flow[yc, xc] * (1 - xr) * (1 - yr) +
         flow[yc, xc + 1] * xr * (1 - yr) +
         flow[yc + 1, xc] * (1 - xr) * yr +
         flow[yc + 1, xc + 1] * xr * yr)
    return torch.where(valid[..., None], d, 0.0), valid


class StreamlineResult(NamedTuple):
    points: torch.Tensor     # ([N,] iters+1, 2) visited positions
    final: torch.Tensor      # ([N,] 2) final positions
    seg_valid: torch.Tensor  # ([N,] iters) bool — segment i..i+1 was stepped


def streamlines(pts0: torch.Tensor, flow: torch.Tensor, dt: float,
                iterations: int, upper=math.inf) -> StreamlineResult:
    """Euler-advect (N, 2) seeds; each stops out of bounds or when
    |delta| > upper.
    The sticky `active` flag stays on the device: no step waits for it."""
    pt = pts0.to(torch.float32)
    active = torch.ones(pt.shape[0], dtype=torch.bool, device=pt.device)
    pts, oks = [pt], []
    for _ in range(iterations):
        d, valid = sample_flow(flow, pt[:, 0], pt[:, 1])
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        active = active & valid & (r <= upper)
        pt = torch.where(active[:, None], pt + d * dt, pt)
        pts.append(pt)
        oks.append(active)
    return StreamlineResult(torch.stack(pts, dim=1), pt,
                            torch.stack(oks, dim=1))


def streamline(pt0: torch.Tensor, flow: torch.Tensor, dt: float,
               iterations: int, upper=math.inf) -> StreamlineResult:
    """:func:`streamlines` of one (2,) seed: points (iters+1, 2), final
    (2,), seg_valid (iters,)."""
    res = streamlines(pt0[None], flow, dt, iterations, upper)
    return StreamlineResult(*(t[0] for t in res))


class FieldState(NamedTuple):
    disp: torch.Tensor   # (H, W, 2) displacement of each pixel's particle
    dist: torch.Tensor   # (H, W) accumulated path length


def init_field(h: int, w: int, device) -> FieldState:
    return FieldState(torch.zeros((h, w, 2), dtype=torch.float32,
                                  device=device),
                      torch.zeros((h, w), dtype=torch.float32,
                                  device=device))


def streamline_field(state: FieldState, flow: torch.Tensor, dt: float,
                     iterations: int, upper, row0: int = 0) -> FieldState:
    """Advance every pixel's particle through `flow` (invoked per frame
    with dt=2, iterations=1 from ripcurrents.cpp:229-231). disp is the
    displacement from the pixel's origin. The state may hold a row band
    of the frame, its first row at frame row `row0`; `flow` is the whole
    frame's, since the particles move anywhere in it."""
    h, w = state.dist.shape
    ys, xs = torch.meshgrid(
        torch.arange(row0, row0 + h, dtype=torch.float32,
                     device=flow.device),
        torch.arange(w, dtype=torch.float32, device=flow.device),
        indexing="ij")
    disp, dist = state
    for _ in range(iterations):
        d, valid = sample_flow(flow, disp[..., 0] + xs, disp[..., 1] + ys)
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        ok = valid & (r <= upper)
        disp = torch.where(ok[..., None], disp + d * (dt / iterations), disp)
        dist = torch.where(ok, dist + r, dist)
    return FieldState(disp, dist)


def get_delta(pts: torch.Tensor, flow: torch.Tensor, dt: float,
              upper) -> torch.Tensor:
    """One advection step for arbitrary points (..., 2), frozen when
    |delta| > upper (ripcurrents_module.cpp:650-679)."""
    d, valid = sample_flow(flow, pts[..., 0], pts[..., 1])
    r = torch.sqrt(torch.sum(d * d, dim=-1))
    ok = valid & (r <= upper)
    return torch.where(ok[..., None], pts + d * dt, pts)


def delta_field(flow: torch.Tensor, dt: float, upper) -> torch.Tensor:
    """averageVector's per-pixel displacement buffer: every pixel origin
    advected one step (ripcurrents_module.cpp:393-397) -> (H, W, 2)."""
    h, w = flow.shape[0], flow.shape[1]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=flow.device),
        torch.arange(w, dtype=torch.float32, device=flow.device),
        indexing="ij")
    d, valid = sample_flow(flow, xs, ys)
    r = torch.sqrt(torch.sum(d * d, dim=-1))
    ok = valid & (r <= upper)
    return torch.where(ok[..., None], d * dt, 0.0)


def circular_field(h: int, w: int, device="cpu") -> torch.Tensor:
    """The synthetic validation field of validate_streamlines
    (main.cpp:374-380): flow.x = -(row - H/2)/H * 100,
    flow.y = (col - W/2)/W * 100. -> (H, W, 2) float32 on `device`."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    fx = -(ys - h / 2.0) / h * 100.0
    fy = (xs - w / 2.0) / w * 100.0
    return torch.stack([fx, fy], dim=-1)
