"""The LK particle modes and the dense Farneback modes (port of
``timelines``, ``streaklines``, ``populationMap``, ``flowRedPoints``,
``streamlines``, ``timelinesOnSubtractAverageVector``, ``timelinesFarne``,
``subtructAverageVector``, ``subtructAverageVectorWithWindow``,
``shearRate`` and ``averageVector`` from
``ripcurrents_tpu/pipelines/modes.py``).

One entry per compute_* function of the reference (RipCurrents_main/
main.cpp). Each factory takes (cfg, device) and returns (init, step);
``step(state, raw_frame) -> (state, out_u8)``. States are NamedTuples of
tensors on the factory's device; a step launches device work only and
never waits for it.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import numpy as np
import torch

from ripcurrents_tpu_torch import resolve_device
from ripcurrents_tpu_torch.analysis import meanflow
from ripcurrents_tpu_torch.analysis.shear import shear_to_color
from ripcurrents_tpu_torch.config import FarnebackParams, LKParams
from ripcurrents_tpu_torch.dynamics import advect
from ripcurrents_tpu_torch.dynamics import particles as parts
from ripcurrents_tpu_torch.flow.lucas_kanade import pyr_lk
from ripcurrents_tpu_torch.ops.color import hsv_to_bgr
from ripcurrents_tpu_torch.ops.colormap import apply_colormap
from ripcurrents_tpu_torch.pipelines.common import (FlowStream, ModeConfig,
                                                    fb_preset,
                                                    flow_stream_init,
                                                    flow_stream_step,
                                                    prep_frame, register,
                                                    to_device)
from ripcurrents_tpu_torch.viz import draw
from ripcurrents_tpu_torch.viz.color import (color_wheel, shear_color_chart,
                                             vector_to_color)

BLUE = (100, 0, 0)    # CV_RGB(0,0,100)
RED = (0, 0, 100)     # CV_RGB(100,0,0)
GREEN = (0, 100, 0)   # CV_RGB(0,100,0)


def _frame_zero(dev) -> torch.Tensor:
    return torch.tensor(0, dtype=torch.int32, device=dev)


def _max_init(dev) -> torch.Tensor:
    return torch.tensor(1e-6, dtype=torch.float32, device=dev)


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
    persistent 8-bit canvas with intensity framecount*255/totalframes.
    Raises ValueError when cfg.total_frames is not positive (a source
    without a length gives the runner no count)."""
    if cfg.total_frames <= 0:
        raise ValueError("trails are shaded by the clip's frame count: give "
                         "ModeConfig.total_frames for frames without a "
                         "length")
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


# ---------------------------------------------------------------------------
# trail modes on Farneback flow (main.cpp:177-444, 870-1021)
# ---------------------------------------------------------------------------

class TrailsState(NamedTuple):
    """State of streamlines, timelinesOnSubtractAverageVector and
    timelinesFarne."""
    fstream: FlowStream
    seeds: torch.Tensor      # (n, 2)
    overlay: torch.Tensor    # (H, W) uint8 trail canvas
    framecount: torch.Tensor


def _trails_init(gray, seeds, fb, cfg, dev) -> TrailsState:
    return TrailsState(flow_stream_init(gray, fb), seeds,
                       torch.zeros((cfg.ydim, cfg.xdim), dtype=torch.uint8,
                                   device=dev), _frame_zero(dev))


@register("streamlines")
def streamlines_mode(cfg: ModeConfig, device="cuda"):
    dev = resolve_device(device)
    fb = fb_preset(FarnebackParams.streamlines(), cfg)

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        seeds = torch.tensor([[300.0, 300.0]], device=dev)  # main.cpp:240
        return _trails_init(gray, seeds, fb, cfg, dev)

    def step(state, raw):
        resized, gray = prep_frame(to_device(raw, dev), cfg)
        flow, fs = flow_stream_step(state.fstream, gray, fb)
        fc = state.framecount + 1
        seeds, overlay = _advect_and_draw_trails(
            state.seeds, state.overlay, flow, fc, cfg,
            upper=cfg.thresholds.upper_init)
        out = _composite_trails(resized, overlay)
        return TrailsState(fs, seeds, overlay, fc), out

    return init, step


@register("timelinesOnSubtractAverageVector")
def timelines_on_subtract(cfg: ModeConfig, device="cuda"):
    dev = resolve_device(device)
    fb = fb_preset(FarnebackParams.streamlines(), cfg)  # main.cpp:742

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        gen = torch.Generator().manual_seed(cfg.seed)
        seeds = torch.floor(
            torch.rand((cfg.n_streamline_seeds, 2), generator=gen) *
            torch.tensor([cfg.xdim, cfg.ydim], dtype=torch.float32)).to(dev)
        return _trails_init(gray, seeds, fb, cfg, dev)

    def step(state, raw):
        resized, gray = prep_frame(to_device(raw, dev), cfg)
        flow, fs = flow_stream_step(state.fstream, gray, fb)
        flow = meanflow.subtract_average(flow)
        fc = state.framecount + 1
        seeds, overlay = _advect_and_draw_trails(
            state.seeds, state.overlay, flow, fc, cfg,
            upper=cfg.thresholds.upper_init)
        out = _composite_trails(resized, overlay)
        return TrailsState(fs, seeds, overlay, fc), out

    return init, step


@register("timelinesFarne")
def timelines_farne(cfg: ModeConfig, device="cuda"):
    dev = resolve_device(device)
    fb = fb_preset(FarnebackParams.subtract_average(), cfg)  # main.cpp:961

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        # the vertex line (100,100)-(500,100), 20 vertices (main.cpp:873-889)
        tl = parts.timeline_init((100.0, 100.0), (500.0, 100.0), 20, dev)
        return _trails_init(gray, tl.vertices[:20], fb, cfg, dev)

    def step(state, raw):
        resized, gray = prep_frame(to_device(raw, dev), cfg)
        flow, fs = flow_stream_step(state.fstream, gray, fb)
        fc = state.framecount + 1
        seeds, overlay = _advect_and_draw_trails(
            state.seeds, state.overlay, flow, fc, cfg,
            upper=cfg.thresholds.upper_init)
        out = draw.draw_circles(resized, seeds[:1], 4, BLUE)
        out = draw.draw_polyline(out, seeds, RED, 2)
        out = draw.draw_circles(out, seeds[1:], 4, BLUE)
        out = draw.draw_frame_count(out, fc)
        return TrailsState(fs, seeds, overlay, fc), out

    return init, step


# ---------------------------------------------------------------------------
# mean-subtracted HSV modes (main.cpp:526-658, 1023-1192)
# ---------------------------------------------------------------------------

class SubtractAverageState(NamedTuple):
    fstream: FlowStream
    max_disp: torch.Tensor
    framecount: torch.Tensor


@register("subtructAverageVector", gray_input=True)
def subtract_average_vector(cfg: ModeConfig, device="cuda"):
    dev = resolve_device(device)
    fb = fb_preset(FarnebackParams.subtract_average(), cfg)

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        return SubtractAverageState(flow_stream_init(gray, fb),
                                    _max_init(dev), _frame_zero(dev))

    def step(state, raw):
        _, gray = prep_frame(to_device(raw, dev), cfg)
        flow, fs = flow_stream_step(state.fstream, gray, fb)
        colored = vector_to_color(meanflow.subtract_average(flow),
                                  state.max_disp)
        fc = state.framecount + 1
        out = draw.draw_frame_count(colored.bgr_u8, fc)
        return SubtractAverageState(fs, colored.max_displacement, fc), out

    return init, step


class WindowedState(NamedTuple):
    fstream: FlowStream
    ring: meanflow.RingMean
    max_disp: torch.Tensor
    framecount: torch.Tensor


@register("subtructAverageVectorWithWindow")
def subtract_average_windowed(cfg: ModeConfig, device="cuda"):
    dev = resolve_device(device)
    fb = fb_preset(FarnebackParams.windowed(), cfg)
    # the colour-wheel legend at the top right (main.cpp:1097, 1161-1162)
    legend = color_wheel(cfg.ydim // 8, device=dev)

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        ring = meanflow.ring_init(cfg.window_size, (cfg.ydim, cfg.xdim, 2),
                                  dev)
        return WindowedState(flow_stream_init(gray, fb), ring,
                             _max_init(dev), _frame_zero(dev))

    def step(state, raw):
        resized, gray = prep_frame(to_device(raw, dev), cfg)
        flow, fs = flow_stream_step(state.fstream, gray, fb)
        ring = meanflow.ring_update(state.ring, flow)
        colored = vector_to_color(ring.mean, state.max_disp)
        fc = state.framecount + 1
        overlay = draw.draw_frame_count(colored.bgr_u8, fc)
        overlay = draw.paste(overlay, legend, 0, cfg.xdim - cfg.ydim // 8)
        out = draw.blend(resized, overlay, 0.4, 0.6)
        return WindowedState(fs, ring, colored.max_displacement, fc), out

    return init, step


class ShearState(NamedTuple):
    fstream: FlowStream
    ring: meanflow.RingMean
    max_frob: torch.Tensor
    framecount: torch.Tensor


@register("shearRate")
def shear_rate(cfg: ModeConfig, device="cuda"):
    dev = resolve_device(device)
    fb = fb_preset(FarnebackParams.windowed(), cfg)
    # the shear colour-chart legend at the top right (main.cpp:1458-1462),
    # drawn from the hue mapping itself
    legend = shear_color_chart(cfg.ydim // 12, cfg.xdim // 4, device=dev)

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        ring = meanflow.ring_init(cfg.shear_window, (cfg.ydim, cfg.xdim, 2),
                                  dev)
        return ShearState(flow_stream_init(gray, fb), ring, _max_init(dev),
                          _frame_zero(dev))

    def step(state, raw):
        resized, gray = prep_frame(to_device(raw, dev), cfg)
        flow, fs = flow_stream_step(state.fstream, gray, fb)
        ring = meanflow.ring_update(state.ring, flow)
        sheared = shear_to_color(ring.mean, state.max_frob)
        fc = state.framecount + 1
        overlay = draw.draw_frame_count(hsv_to_bgr(sheared.hsv_u8), fc)
        overlay = draw.paste(overlay, legend, 0, cfg.xdim - cfg.xdim // 4)
        out = draw.blend(resized, overlay, 0.5, 0.5)
        return ShearState(fs, ring, sheared.max_frobenius, fc), out

    return init, step


# ---------------------------------------------------------------------------
# averageVector (ripcurrents_module.cpp:386-484)
# ---------------------------------------------------------------------------

class AverageVectorModeState(NamedTuple):
    fstream: FlowStream
    av: meanflow.AverageVectorState
    framecount: torch.Tensor


GOLD = (0, 215, 255)
LIME = (0, 255, 0)


@register("averageVector", gray_input=True)
def average_vector_mode(cfg: ModeConfig, device="cuda"):
    """The 300-frame counter-flow arrow detector as a standalone mode."""
    dev = resolve_device(device)
    fb = fb_preset(FarnebackParams.subtract_average(), cfg)
    center = torch.tensor([[cfg.xdim / 2.0, cfg.ydim / 2.0]], device=dev)

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        return AverageVectorModeState(
            flow_stream_init(gray, fb),
            meanflow.average_vector_init(cfg.ydim, cfg.xdim,
                                         cfg.average_buffer, dev),
            _frame_zero(dev))

    def step(state, raw):
        _, gray = prep_frame(to_device(raw, dev), cfg)
        flow, fs = flow_stream_step(state.fstream, gray, fb)
        av = meanflow.average_vector(state.av, flow,
                                     cfg.thresholds.upper_init)
        img = hsv_to_bgr(av.hsv_u8)
        a = av.global_angle_rad
        tip = center + torch.stack([torch.cos(a) * 10.0,
                                    torch.sin(a) * 50.0])[None]
        img = draw.draw_circles(img, center, 3, GOLD)
        img = draw.draw_arrows(img, center, tip,
                               torch.ones(1, dtype=torch.bool, device=dev),
                               GOLD, 2, 0.2)
        # counter-flow grid arrows (rows and columns 1..GRID_COUNT-1)
        gc = av.grid_angle_deg.shape[0]
        ch, cw = cfg.ydim // gc, cfg.xdim // gc
        ys, xs = np.mgrid[1:gc, 1:gc]
        anchors = torch.from_numpy(np.stack(
            [xs.ravel() * cw, ys.ravel() * ch], -1).astype(np.float32)).to(dev)
        ang = av.grid_angle_deg[1:, 1:].reshape(-1) * math.pi / 180.0
        tips = anchors + torch.stack([torch.cos(ang), torch.sin(ang)],
                                     -1) * 10.0
        mask = av.counter_mask[1:, 1:].reshape(-1)
        img = draw.draw_circles(img, anchors, 1, LIME, valid=mask)
        img = draw.draw_arrows(img, anchors, tips, mask, LIME, 1, 0.4)
        return AverageVectorModeState(fs, av.state, state.framecount + 1), img

    return init, step
