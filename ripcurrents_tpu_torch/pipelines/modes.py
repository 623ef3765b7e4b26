"""The LK particle modes and the discrete-streamline helpers (port of
``timelines``, ``streaklines``, ``populationMap``, ``flowRedPoints``,
``_advect_and_draw_trails`` and ``_composite_trails`` from
``ripcurrents_tpu/pipelines/modes.py``).

One entry per compute_* function of the reference (RipCurrents_main/
main.cpp). Each factory takes (cfg, device) and returns (init, step);
``step(state, raw_frame) -> (state, out_u8)``. States are NamedTuples of
tensors on the factory's device; a step launches device work only and
never waits for it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ripcurrents_tpu_torch import resolve_device
from ripcurrents_tpu_torch.config import LKParams
from ripcurrents_tpu_torch.dynamics import advect
from ripcurrents_tpu_torch.dynamics import particles as parts
from ripcurrents_tpu_torch.flow.lucas_kanade import pyr_lk
from ripcurrents_tpu_torch.ops.colormap import apply_colormap
from ripcurrents_tpu_torch.pipelines.common import (ModeConfig, prep_frame,
                                                    register, to_device)
from ripcurrents_tpu_torch.viz import draw

BLUE = (100, 0, 0)    # CV_RGB(0,0,100)
RED = (0, 0, 100)     # CV_RGB(100,0,0)
GREEN = (0, 100, 0)   # CV_RGB(0,100,0)


def _frame_zero(dev) -> torch.Tensor:
    return torch.tensor(0, dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# timelines (the built binary's default mode, main.cpp:446-524)
# ---------------------------------------------------------------------------

class TimelinesState(NamedTuple):
    prev_gray: torch.Tensor
    timeline: parts.TimelineState
    framecount: torch.Tensor


@register("timelines")
def timelines(cfg: ModeConfig, device="cuda"):
    dev = resolve_device(device)

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        tl = parts.timeline_init(cfg.timeline_start, cfg.timeline_end,
                                 cfg.timeline_vertices, dev)
        return TimelinesState(gray, tl, _frame_zero(dev))

    def step(state, raw):
        resized, gray = prep_frame(to_device(raw, dev), cfg)
        tl = parts.timeline_step(state.timeline, state.prev_gray, gray,
                                 cfg.lk)
        out = draw.draw_polyline(resized, tl.vertices, RED, thickness=2)
        out = draw.draw_circles(out, tl.vertices, 4, BLUE)
        return TimelinesState(gray, tl, state.framecount + 1), out

    return init, step


# ---------------------------------------------------------------------------
# streaklines (main.cpp:92-175)
# ---------------------------------------------------------------------------

class StreaklinesState(NamedTuple):
    prev_gray: torch.Tensor
    gens: torch.Tensor       # (n, 2)
    verts: torch.Tensor      # (n, cap, 2)
    count: torch.Tensor      # (n,)
    framecount: torch.Tensor


@register("streaklines")
def streaklines(cfg: ModeConfig, device="cuda"):
    dev = resolve_device(device)
    n, cap = cfg.max_streaklines, cfg.streakline_capacity

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        gen = torch.Generator().manual_seed(cfg.seed)
        gens = torch.floor(
            torch.rand((n, 2), generator=gen) *
            torch.tensor([cfg.xdim, cfg.ydim], dtype=torch.float32)).to(dev)
        return StreaklinesState(
            gray, gens, gens[:, None, :].repeat(1, cap, 1),
            torch.ones(n, dtype=torch.int32, device=dev), _frame_zero(dev))

    def step(state, raw):
        resized, gray = prep_frame(to_device(raw, dev), cfg)
        # one shared tracker call over the vertices of every system
        res = pyr_lk(state.prev_gray, gray, state.verts.reshape(n * cap, 2),
                     cfg.lk)
        st = parts.streakline_advance(
            parts.StreaklineState(state.gens, state.verts, state.count),
            res.points.reshape(n, cap, 2), cfg.xdim, cfg.ydim)
        verts, count = st.vertices, st.count
        out = resized
        live = torch.arange(cap, device=dev)[None, :] < count[:, None]
        for i in range(n):
            out = draw.draw_circles(out, state.gens[i:i + 1], 3, GREEN)
            out = draw.draw_polyline(out, verts[i], RED, 1, valid=live[i])
            out = draw.draw_circles(out, verts[i], 2, BLUE, valid=live[i])
        return StreaklinesState(gray, state.gens, verts, count,
                                state.framecount + 1), out

    return init, step


# ---------------------------------------------------------------------------
# populationMap (main.cpp:790-868)
# ---------------------------------------------------------------------------

class PopulationMapState(NamedTuple):
    prev_gray: torch.Tensor
    pop: parts.PopulationState
    framecount: torch.Tensor


@register("populationMap")
def population_map(cfg: ModeConfig, device="cuda"):
    dev = resolve_device(device)
    x0, y0, x1, y1 = cfg.population_rect

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        pop = parts.population_init(
            (x0, y0), (x1, y1), cfg.population_vertices,
            torch.Generator().manual_seed(cfg.seed),
            cfg.population_faithful_bias, dev)
        return PopulationMapState(gray, pop, _frame_zero(dev))

    def step(state, raw):
        resized, gray = prep_frame(to_device(raw, dev), cfg)
        pop = parts.population_step(state.pop, state.prev_gray, gray, cfg.lk)
        # translucent dispersal dots (ripcurrents_module.cpp:1188-1195)
        overlay = draw.draw_circles(resized, pop.vertices, 10, RED)
        out = draw.blend(overlay, resized, 0.5, 0.5)
        return PopulationMapState(gray, pop, state.framecount + 1), out

    return init, step


# ---------------------------------------------------------------------------
# flowRedPoints (ripcurrents_module.cpp:732-749)
# ---------------------------------------------------------------------------

class RedPointsState(NamedTuple):
    prev_gray: torch.Tensor
    pts: torch.Tensor
    framecount: torch.Tensor


@register("flowRedPoints")
def flow_red_points(cfg: ModeConfig, device="cuda"):
    """An LK-advected red dot cloud seeded on a coarse grid."""
    dev = resolve_device(device)

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        step_px = max(cfg.xdim // 16, 8)
        ys, xs = np.mgrid[step_px // 2:cfg.ydim:step_px,
                          step_px // 2:cfg.xdim:step_px]
        pts = torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], -1)
                               .astype(np.float32)).to(dev)
        return RedPointsState(gray, pts, _frame_zero(dev))

    def step(state, raw):
        resized, gray = prep_frame(to_device(raw, dev), cfg)
        res = pyr_lk(state.prev_gray, gray, state.pts, LKParams.red_points())
        out = draw.draw_circles(resized, res.points, 2, RED)
        return RedPointsState(gray, res.points, state.framecount + 1), out

    return init, step


# ---------------------------------------------------------------------------
# discrete-streamline helpers (get_streamlines, ripcurrents_module.cpp:71-79)
# ---------------------------------------------------------------------------


def _advect_and_draw_trails(seeds, overlay_u8, flow, framecount, cfg,
                            dt=0.1, iters=100, upper=45.0):
    """Advance seeds through `flow`, drawing their trails onto the
    persistent 8-bit canvas with intensity framecount*255/totalframes."""
    res = advect.streamlines(seeds, flow, dt, iters, upper)
    shade = framecount.to(torch.float32) * 255.0 / cfg.total_frames
    shade = torch.clamp(shade, 0, 255).to(torch.uint8)
    # Every seed's trail is a polyline whose first point is valid; all
    # trails share one shade, so they are drawn in one scatter.
    valid = torch.cat([torch.ones_like(res.seg_valid[:, :1]),
                       res.seg_valid], dim=1)
    overlay_u8 = draw.draw_segments(
        overlay_u8, res.points[:, :-1].reshape(-1, 2),
        res.points[:, 1:].reshape(-1, 2),
        (valid[:, :-1] & valid[:, 1:]).reshape(-1), shade)
    return res.final, overlay_u8


def _composite_trails(frame_u8, overlay_u8):
    """applyColorMap(RAINBOW) + masked saturated add (get_streamlines)."""
    colored = apply_colormap(overlay_u8, "rainbow")
    mask = (overlay_u8 > 0)[..., None]
    added = torch.clamp(frame_u8.to(torch.int32) + colored.to(torch.int32),
                        max=255).to(torch.uint8)
    return torch.where(mask, added, frame_u8)
