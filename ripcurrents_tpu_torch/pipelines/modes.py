"""The LK particle modes and the dense Farneback modes (port of
``timelines``, ``streaklines``, ``populationMap``, ``flowRedPoints``,
``streamlines``, ``timelinesOnSubtractAverageVector``, ``timelinesFarne``,
``subtructAverageVector``, ``subtructAverageVectorWithWindow``,
``shearRate`` and ``averageVector``) and the temporal exposure and
stabilization modes (``averageHSV``, ``timex``, ``brightColor``,
``phaseCorrelate``, ``stabilizeTPU`` and ``globalOrientation``) of
``ripcurrents_tpu/pipelines/modes.py``.

One entry per compute_* function of the reference (RipCurrents_main/
main.cpp). Each factory takes (cfg, device) and returns (init, step);
``step(state, raw_frame) -> (state, out_u8)``. States are NamedTuples of
tensors on the factory's device. A step launches device work and does
not wait for it, with two exceptions: ``stabilizeTPU``'s step waits on
the card 6 times a Harris frame (the frame upload, its frame count and
RANSAC's SVDs; see its docstring), and a step that bins a histogram with
``torch.bincount`` (``ops/hist.py``: legacy, android) waits twice, as
bincount reads its input's min and max from a CUDA tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import numpy as np
import torch

from ripcurrents_tpu_torch import resolve_device
from ripcurrents_tpu_torch.analysis import meanflow
from ripcurrents_tpu_torch.analysis.motion import global_orientation_step
from ripcurrents_tpu_torch.analysis.shear import shear_to_color
from ripcurrents_tpu_torch.config import FarnebackParams, LKParams
from ripcurrents_tpu_torch.dynamics import advect
from ripcurrents_tpu_torch.dynamics import particles as parts
from ripcurrents_tpu_torch.flow.feature_stab import (FEATURES,
                                                     stabilize_pair,
                                                     step_generator)
from ripcurrents_tpu_torch.flow.lucas_kanade import pyr_lk
from ripcurrents_tpu_torch.flow.phasecorr import (hanning_window,
                                                  phase_correlate)
from ripcurrents_tpu_torch.ops.color import hsv_to_bgr, rgb_to_hsv
from ripcurrents_tpu_torch.ops.colormap import apply_colormap
from ripcurrents_tpu_torch.ops.image import bgr_to_gray
from ripcurrents_tpu_torch.ops.warp import translate
from ripcurrents_tpu_torch.parallel.mesh import (space_all_reduce,
                                                 space_gather_rows)
from ripcurrents_tpu_torch.pipelines.common import (FlowStream, ModeConfig,
                                                    fb_preset,
                                                    flow_stream_init,
                                                    flow_stream_step,
                                                    prep_frame, register,
                                                    space_rows, to_device)
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


@register("timelines", space=True)
def timelines(cfg: ModeConfig, device="cuda", mesh=None):
    """The space form (mesh.space K > 1; ``common.SPACE_MODES``): each
    rank resizes its band of the frame, the bands' grays are gathered
    into the whole frame on every rank (its pyramid is built on each),
    and each rank tracks through K3 only the vertices whose row lies in
    its band (the edge bands take those above and below the frame); one
    sum over the group gives every rank all vertices. A vertex's track
    does not depend on the others, so the vertices and the drawn band
    equal the one-process step's bit for bit. Picking a rank's vertices
    reads their count on the host (one wait on the card a frame)."""
    dev = resolve_device(device)
    rows = space_rows(cfg, mesh)

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True,
                             rows=rows)
        tl = parts.timeline_init(cfg.timeline_start, cfg.timeline_end,
                                 cfg.timeline_vertices, dev)
        return TimelinesState(space_gather_rows(mesh, gray, "gray bands")
                              if rows else gray, tl, _frame_zero(dev))

    def track(state, gray):
        if rows is None:
            return parts.timeline_step(state.timeline, state.prev_gray,
                                       gray, cfg.lk)
        verts = state.timeline.vertices
        band = rows[1] - rows[0]
        owner = torch.clamp(torch.div(torch.floor(verts[:, 1]), band,
                                      rounding_mode="floor"),
                            0, mesh.space - 1)
        mine = torch.nonzero(owner == mesh.coords["space"]).squeeze(1)
        new = torch.zeros_like(verts)
        if mine.numel():
            new[mine] = parts.timeline_step(
                parts.TimelineState(verts[mine]), state.prev_gray, gray,
                cfg.lk).vertices
        return parts.TimelineState(space_all_reduce(mesh, new,
                                                    label="vertices"))

    def step(state, raw, src=None):
        resized, gray = prep_frame(to_device(raw, dev), cfg, rows=rows,
                                   src=src)
        if rows is not None:
            gray = space_gather_rows(mesh, gray, "gray bands")
        tl = track(state, gray)
        row0 = 0 if rows is None else rows[0]
        out = draw.draw_polyline(resized, tl.vertices, RED, thickness=2,
                                 band=(row0, cfg.ydim))
        out = draw.draw_circles(out, tl.vertices, 4, BLUE, row0=row0)
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
                            dt=0.1, iters=100, upper=45.0, band=None):
    """Advance seeds through `flow`, drawing their trails onto the
    persistent 8-bit canvas with intensity framecount*255/totalframes
    (a row band of it with band=(row0, frame_h), ``draw.draw_segments``).
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
        (valid[:, :-1] & valid[:, 1:]).reshape(-1), shade, band=band)
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


# ---------------------------------------------------------------------------
# temporal exposure modes (main.cpp:1195-1382)
# ---------------------------------------------------------------------------

def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


@register("averageHSV")
def average_hsv(cfg: ModeConfig, device="cuda"):
    """averageHSV (ripcurrents_module.cpp:365-376, driven from the dead
    main_old.cpp:360): the ring mean of the last BUFFER_FRAME frames. The
    reference's quirk is kept: despite the name it never converts to HSV
    (its cvtColor is commented out at ripcurrents_module.cpp:367) and
    averages the BGR frame. The state is the ring itself
    (``meanflow.RingMean``; 1.1 GB of float32 at 640x480 and 300
    frames, copied by each out-of-place step)."""
    dev = resolve_device(device)

    def init(first_raw):
        return meanflow.ring_init(cfg.average_buffer,
                                  (cfg.ydim, cfg.xdim, 3), dev)

    def step(state, raw):
        resized, _ = prep_frame(to_device(raw, dev), cfg)
        state = meanflow.average_hsv_update(state, resized)
        return state, _u8(state.mean)

    return init, step


class TimexState(NamedTuple):
    sum_rgb: torch.Tensor     # (H, W, 3) float32 running sum
    framecount: torch.Tensor


@register("timex")
def timex(cfg: ModeConfig, device="cuda"):
    """compute_timex (main.cpp:1195-1263): the running mean of the raw
    frames."""
    dev = resolve_device(device)

    def init(first_raw):
        return TimexState(torch.zeros((cfg.ydim, cfg.xdim, 3),
                                      dtype=torch.float32, device=dev),
                          _frame_zero(dev))

    def step(state, raw):
        resized, _ = prep_frame(to_device(raw, dev), cfg)
        s = meanflow.timex_update(state.sum_rgb, resized)
        fc = state.framecount + 1
        out = draw.draw_frame_count(_u8(s / fc.to(torch.float32)), fc)
        return TimexState(s, fc), out

    return init, step


class BrightColorState(NamedTuple):
    buffer: torch.Tensor      # (window, H, W, 3) uint8 HSV
    idx: torch.Tensor         # () int32 next slot
    framecount: torch.Tensor


@register("brightColor")
def bright_color(cfg: ModeConfig, device="cuda"):
    """compute_brightColor (main.cpp:1265-1382) over a ring of the last
    ``bright_window`` frames. The reference's quirks are kept: it converts
    BGR data with RGB2HSV (main.cpp:1303) and HSV2RGB's output is written
    to a BGR frame. The new frame goes into a new buffer; the state's is
    not written."""
    dev = resolve_device(device)

    def init(first_raw):
        return BrightColorState(
            torch.zeros((cfg.bright_window, cfg.ydim, cfg.xdim, 3),
                        dtype=torch.uint8, device=dev),
            _frame_zero(dev), _frame_zero(dev))

    def step(state, raw):
        resized, _ = prep_frame(to_device(raw, dev), cfg)
        buf = state.buffer.index_copy(0, state.idx.reshape(1).long(),
                                      rgb_to_hsv(resized)[None])
        reduced = meanflow.bright_color_reduce(buf, cfg.bright_option)
        fc = state.framecount + 1
        out = draw.draw_frame_count(
            torch.flip(hsv_to_bgr(reduced), dims=(-1,)), fc)
        return BrightColorState(buf, (state.idx + 1) % cfg.bright_window,
                                fc), out

    return init, step


# ---------------------------------------------------------------------------
# stabilization modes
# ---------------------------------------------------------------------------

class PhaseCorrelateState(NamedTuple):
    prev_resized: torch.Tensor  # the compensated previous frame (BGR u8)
    framecount: torch.Tensor


def _crop(img: torch.Tensor, y: int, x: int, h: int, w: int) -> torch.Tensor:
    """img[y:y+h, x:x+w] with the start clamped so that the crop fits, as
    ``jax.lax.dynamic_slice`` clamps it."""
    y = min(max(y, 0), img.shape[0] - h)
    x = min(max(x, 0), img.shape[1] - w)
    return img[y:y + h, x:x + w]


@register("phaseCorrelate")
def phase_correlate_mode(cfg: ModeConfig, device="cuda"):
    """compute_phaseCorrelate (main.cpp:1684-1775): the translation of a
    beach ROI between the compensated previous frame and the new one,
    undone by a bilinear translation. Every frame is resized with
    INTER_AREA (main.cpp:1736)."""
    dev = resolve_device(device)
    win = hanning_window(cfg.phase_roi[3], cfg.phase_roi[2], dev)

    def init(first_raw):
        resized, _ = prep_frame(to_device(first_raw, dev), cfg, first=True)
        return PhaseCorrelateState(resized, _frame_zero(dev))

    def step(state, raw):
        resized, _ = prep_frame(to_device(raw, dev), cfg, first=True)
        shift = phase_shift(state.prev_resized, resized, cfg.phase_roi, win)
        corrected = translate(resized, -shift[0], -shift[1])
        return PhaseCorrelateState(corrected, state.framecount + 1), \
            corrected

    return init, step


def phase_shift(prev_resized: torch.Tensor, resized: torch.Tensor, roi,
                window: torch.Tensor) -> torch.Tensor:
    """phaseCorrelate's (dx, dy): the translation of the ROI (x, y, w, h)
    from the compensated previous frame to the new one, both (H, W, 3)
    uint8 BGR. The mode undoes it with ``translate``."""
    rx, ry, rw, rh = roi
    pg = bgr_to_gray(prev_resized).to(torch.float32)
    cg = bgr_to_gray(resized).to(torch.float32)
    return phase_correlate(_crop(pg, ry, rx, rh, rw),
                           _crop(cg, ry, rx, rh, rw), window).shift


class StabilizeState(NamedTuple):
    prev_gray: torch.Tensor     # gray of the previous corrected frame
    framecount: torch.Tensor


@register("stabilizeTPU")
def stabilize_tpu(cfg: ModeConfig, device="cuda"):
    """Feature stabilization on the device (flow/feature_stab.py): Harris
    corners and patch matching (default) or the AKAZE-class engine
    (``stab_features="akaze"``, flow/akaze_tpu.py), a RANSAC homography
    and the tiled-warp correction; the on-device counterpart of the
    reference's AKAZE pipeline (main.cpp:1556-1682). As the reference
    does, each frame is registered to the previous *corrected* frame
    (main.cpp:1659: prev = correction).

    RANSAC draws from a generator on the device seeded from (cfg.seed,
    framecount) (``feature_stab.step_generator``), so a step is a
    function of its state and frame. Unlike the other modes' steps, this
    one waits on the card: reading the count waits for the previous
    step, and each of RANSAC's two SVD calls waits twice."""
    dev = resolve_device(device)
    if cfg.stab_features not in FEATURES:
        raise ValueError(f"stab_features {cfg.stab_features!r}: expected "
                         f"one of {FEATURES}")

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        return StabilizeState(gray, _frame_zero(dev))

    def step(state, raw):
        resized, gray = prep_frame(to_device(raw, dev), cfg)
        gen = step_generator(cfg.seed, int(state.framecount), dev)
        corrected, _, _ = stabilize_pair(state.prev_gray, gray, resized, gen,
                                         features=cfg.stab_features)
        return StabilizeState(bgr_to_gray(corrected),
                              state.framecount + 1), corrected

    return init, step


class GlobalOrientationState(NamedTuple):
    prev_gray: torch.Tensor
    framecount: torch.Tensor


@register("globalOrientation", gray_input=True)
def global_orientation_mode(cfg: ModeConfig, device="cuda"):
    """globalOrientation (ripcurrents_module.cpp:319-359) as a mode: the
    motion-history image, the global direction arrow and a 30-px grid of
    local orientation arrows."""
    dev = resolve_device(device)
    center = torch.tensor([[cfg.xdim / 2.0, cfg.ydim / 2.0]], device=dev)
    ys, xs = np.mgrid[0:cfg.ydim:30, 0:cfg.xdim:30]
    grid = torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], -1).astype(
        np.float32)).to(dev)
    gy, gx = grid[:, 1].long(), grid[:, 0].long()
    one = torch.ones(1, dtype=torch.bool, device=dev)
    every = torch.ones(grid.shape[0], dtype=torch.bool, device=dev)

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        return GlobalOrientationState(gray, _frame_zero(dev))

    def step(state, raw):
        _, gray = prep_frame(to_device(raw, dev), cfg)
        res = global_orientation_step(state.prev_gray, gray)
        out = _u8(res.mhi_norm * 255.0)[..., None].repeat(1, 1, 3)
        ar = res.angle_deg * math.pi / 180.0
        tip = center + torch.stack([torch.cos(ar) * 10.0,
                                    torch.sin(ar) * 50.0])[None, :]
        out = draw.draw_circles(out, center, 3, GOLD)
        out = draw.draw_arrows(out, center, tip, one, GOLD, 2, 0.2)
        gr = res.orientation.orientation_deg[gy, gx] * math.pi / 180.0
        tips = grid + torch.stack([torch.cos(gr), torch.sin(gr)], -1) * 10.0
        out = draw.draw_circles(out, grid, 1, (0, 215, 0))
        out = draw.draw_arrows(out, grid, tips, every, (0, 215, 0), 1, 0.4)
        return GlobalOrientationState(gray, state.framecount + 1), out

    return init, step
