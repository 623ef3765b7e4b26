"""LK-tracked particle systems: Streakline, Timeline, PopulationMap (port
of ``ripcurrents_tpu/dynamics/particles.py``).

Functional states replacing the reference classes (Streakline.hpp /
Streakline.cpp, Timeline: ripcurrents_module.cpp:751-807, PopulationMap:
:1140-1196). Each `step` takes the previous and current gray frames,
tracks the vertices with pyramidal LK, and returns the new state; the
tensors stay on the device of the state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ripcurrents_tpu_torch.config import LKParams, XDIM, YDIM
from ripcurrents_tpu_torch.flow.lucas_kanade import pyr_lk


class StreaklineState(NamedTuple):
    """A growing chain of vertices; one new vertex is emitted at the
    generation point every frame (Streakline.cpp:45-48). With leading
    batch dims on every field it holds several systems."""
    gen_point: torch.Tensor   # (..., 2)
    vertices: torch.Tensor    # (..., capacity, 2); slot 0 is newest
    count: torch.Tensor       # (...) int32: live vertices


def streakline_init(gen_point, capacity: int,
                    device="cpu") -> StreaklineState:
    gp = torch.as_tensor(gen_point, dtype=torch.float32, device=device)
    return StreaklineState(gp, gp[None].repeat(capacity, 1),
                           torch.tensor(1, dtype=torch.int32, device=device))


def streakline_advance(state: StreaklineState, tracked: torch.Tensor,
                       xdim: int = XDIM, ydim: int = YDIM) -> StreaklineState:
    """Apply pre-tracked vertex positions (lets the pipeline run one shared
    pyr_lk call over the vertices of many particle systems)."""
    # Large jumps (>10% of frame dims) are rejected (Streakline.cpp:34-40).
    jump = (tracked - state.vertices).abs()
    bad = (jump[..., 0] > xdim * 0.1) | (jump[..., 1] > ydim * 0.1)
    tracked = torch.where(bad[..., None], state.vertices, tracked)
    verts = torch.cat([state.gen_point[..., None, :], tracked[..., :-1, :]],
                      dim=-2)
    count = torch.clamp(state.count + 1, max=state.vertices.shape[-2])
    return StreaklineState(state.gen_point, verts, count)


def streakline_step(state: StreaklineState, prev_gray, cur_gray,
                    p: LKParams = LKParams.particles(),
                    xdim: int = XDIM, ydim: int = YDIM) -> StreaklineState:
    """Standalone Streakline::runLK for ONE system (tracks + advances);
    pipelines tracking many systems run one shared pyr_lk call and use
    streakline_advance directly."""
    res = pyr_lk(prev_gray, cur_gray, state.vertices, p)
    return streakline_advance(state, res.points, xdim, ydim)


class TimelineState(NamedTuple):
    vertices: torch.Tensor  # (n+1, 2)


def timeline_init(line_start, line_end, num_vertices: int,
                  device="cpu") -> TimelineState:
    """Interpolates num_vertices+1 points along the segment
    (ripcurrents_module.cpp:751-763)."""
    s = torch.tensor(line_start, dtype=torch.float32)
    e = torch.tensor(line_end, dtype=torch.float32)
    t = torch.arange(num_vertices + 1, dtype=torch.float32)[:, None]
    return TimelineState((s + (e - s) / num_vertices * t).to(device))


def timeline_step(state: TimelineState, prev_gray, cur_gray,
                  p: LKParams = LKParams.particles()) -> TimelineState:
    res = pyr_lk(prev_gray, cur_gray, state.vertices, p)
    return TimelineState(res.points)


class PopulationState(NamedTuple):
    vertices: torch.Tensor  # (n, 2)


def population_init(rect_start, rect_end, num_vertices: int,
                    generator: torch.Generator, faithful_bias: bool = True,
                    device="cpu") -> PopulationState:
    """Random points for the dispersal map (ripcurrents_module.cpp:1140-1151),
    drawn from a CPU `generator`.

    faithful_bias=True replicates the reference's off-by-one quirk
    (rand()/RAND_MAX + 1), which lands points in
    [rect_end, 2*rect_end - rect_start] instead of inside the rectangle.
    """
    s = torch.tensor(rect_start, dtype=torch.float32)
    e = torch.tensor(rect_end, dtype=torch.float32)
    u = torch.rand((num_vertices, 2), generator=generator)
    if faithful_bias:
        u = u + 1.0
    return PopulationState((s + (e - s) * u).to(device))


def population_step(state: PopulationState, prev_gray, cur_gray,
                    p: LKParams = LKParams.particles()) -> PopulationState:
    res = pyr_lk(prev_gray, cur_gray, state.vertices, p)
    return PopulationState(res.points)
