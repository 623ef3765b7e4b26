"""Particle advection through flow fields (port of the legacy-path
functions of ``ripcurrents_tpu/dynamics/advect.py``: streamline and
streamline_field, ripcurrents_module.cpp:486-528, :608-648).

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
    points: torch.Tensor     # (N, iters+1, 2) visited positions
    final: torch.Tensor      # (N, 2) final positions
    seg_valid: torch.Tensor  # (N, iters) bool — segment i..i+1 was stepped


def streamlines(pts0: torch.Tensor, flow: torch.Tensor, dt: float,
                iterations: int, upper=math.inf) -> StreamlineResult:
    """Euler-advect (N, 2) seeds; each stops out of bounds or when
    |delta| > upper."""
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


class FieldState(NamedTuple):
    disp: torch.Tensor   # (H, W, 2) displacement of each pixel's particle
    dist: torch.Tensor   # (H, W) accumulated path length


def init_field(h: int, w: int, device) -> FieldState:
    return FieldState(torch.zeros((h, w, 2), dtype=torch.float32,
                                  device=device),
                      torch.zeros((h, w), dtype=torch.float32,
                                  device=device))


def streamline_field(state: FieldState, flow: torch.Tensor, dt: float,
                     iterations: int, upper) -> FieldState:
    """Advance every pixel's particle through `flow` (invoked per frame
    with dt=2, iterations=1 from ripcurrents.cpp:229-231). disp is the
    displacement from the pixel's origin."""
    h, w = flow.shape[0], flow.shape[1]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=flow.device),
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
