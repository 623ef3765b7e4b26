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

Every mode has a space form (factory(cfg, device, mesh); ``common.
register``): each rank resizes its band of rows, except as said of
android and phaseCorrelate below. The particle modes,
the four mean-subtracted HSV modes, the three trail modes and
globalOrientation gather the bands' grays into the whole frame on every
rank (``_space_prep``), stabilizeTPU the bands' colour frames, and
every rank computes the whole frame's flow, tracks, homography or
orientation; android and phaseCorrelate, which resize every frame with
INTER_AREA, are fed the whole frame on every rank (``common.
AREA_INPUT``) and exchange nothing. What is kept per pixel (the rings,
the trail canvas) and what is drawn are the band's. The exposure modes
averageHSV, timex and brightColor keep per-pixel state only: each rank
resizes and keeps its band and exchanges nothing. Each mode's docstring
says what else is exchanged; frames and states equal one process's bit
for bit. An exchange on a gloo group waits on the card
(``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import math

import numpy as np
import torch

from ripcurrents_tpu_torch import resolve_device
from ripcurrents_tpu_torch.analysis import meanflow
from ripcurrents_tpu_torch.analysis.motion import global_orientation_step
from ripcurrents_tpu_torch.analysis import shear
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


def owned_points(pts: torch.Tensor, rows: "tuple[int, int]",
                 frame_h: int) -> torch.Tensor:
    """Which of pts (N, 2) (x, y) the rank holding rows [i0, i1) of a
    frame_h-row frame tracks, as a bool (N,): those whose row (floor(y))
    lies in its band; the first band also takes the rows above the frame
    and NaN rows, the last band those at or below its bottom. Each point
    goes to exactly one band of a frame cut into bands."""
    y = torch.floor(pts[:, 1])
    own = (y >= rows[0]) & (y < rows[1])
    if rows[0] == 0:
        own |= (y < 0) | torch.isnan(y)
    if rows[1] == frame_h:
        own |= y >= frame_h
    return own


def track_points(pts: torch.Tensor, prev_gray: torch.Tensor,
                 gray: torch.Tensor, p: LKParams, mesh=None,
                 rows: "tuple[int, int] | None" = None) -> torch.Tensor:
    """pyr_lk's tracked points (N, 2) of pts from prev_gray to gray.

    On a 'space' group (`rows`, this rank's band of ``space_rows``; the
    grays are the whole frames) each rank tracks through K3 only the
    points ``owned_points`` gives it, with no launch when it owns none,
    and one sum over the group gives every rank all points. The other
    ranks' entries are -0.0, which added to any float leaves it as it is
    (NaN, 0.0 and -0.0 included), so the sum equals one process's call
    bit for bit: a point's track does not depend on the others. Picking
    a rank's points reads their count on the host (one wait on the card
    a call)."""
    if rows is None:
        return pyr_lk(prev_gray, gray, pts, p).points
    mine = torch.nonzero(owned_points(pts, rows, gray.shape[-2])).squeeze(1)
    new = torch.full_like(pts, -0.0)
    if mine.numel():
        new[mine] = pyr_lk(prev_gray, gray, pts[mine], p).points
    return space_all_reduce(mesh, new, label="vertices")


def _space_prep(raw, cfg: ModeConfig, dev, mesh, rows, src=None,
                first=False, colour=False):
    """``prep_frame`` of this rank's band (`rows`, ``space_rows``) ->
    (the band of the resized frame, the whole frame's gray: the bands'
    grays gathered over the 'space' group); prep_frame's own with rows
    None. `colour`: the bands' resized BGR frames are gathered instead
    (3 x the bytes) -> (the whole resized frame, its gray)."""
    resized, gray = prep_frame(to_device(raw, dev), cfg, first=first,
                               rows=rows, src=src)
    if rows is None:
        return resized, gray
    if colour:
        resized = space_gather_rows(mesh, resized, "frame bands")
        return resized, bgr_to_gray(resized)
    return resized, space_gather_rows(mesh, gray, "gray bands")


def _band(cfg: ModeConfig, rows) -> "tuple[int, int]":
    """(first frame row, row count) of this rank's band (`rows`,
    ``space_rows``): the whole frame's with rows None."""
    i0, i1 = rows or (0, cfg.ydim)
    return i0, i1 - i0


def shear_rows(rows: "tuple[int, int]", frame_h: int,
               offset: int = shear.OFFSET) -> "tuple[int, int]":
    """The frame rows a shearRate rank keeps its ring over: its band
    `rows` and `offset` more on each side, clipped to the frame, which
    ``shear_frobenius`` needs to give the band's rows exactly."""
    return max(rows[0] - offset, 0), min(rows[1] + offset, frame_h)


def android_rows(rows: "tuple[int, int]", frame_h: int,
                 localwin: int = 20) -> "tuple[int, int]":
    """The frame rows an android rank keeps its accumulator over: its
    band `rows` and every row of each window of ``classify.
    android_local_rip`` that covers a pixel of the band. The windows are
    2 x localwin rows tall, anchored every localwin rows on the frame's
    grid below frame_h - 2 x localwin, so the band's pixels read those
    anchored in (i0 - 2 x localwin, i1)."""
    win = 2 * localwin
    i0, i1 = rows
    anchors = [a for a in range(0, max(frame_h - win, 0), localwin)
               if i0 - win < a < i1]
    if not anchors:
        return rows
    return min(i0, anchors[0]), max(i1, anchors[-1] + win)


@register("timelines")
def timelines(cfg: ModeConfig, device="cuda", mesh=None):
    """The space form (mesh.space K > 1; ``common.SPACE_MODES``): each
    rank resizes its band of the frame, the bands' grays are gathered
    into the whole frame on every rank (its pyramid is built on each),
    and each rank tracks through K3 only the vertices whose row lies in
    its band (``track_points``); one sum over the group gives every rank
    all vertices, and each draws its band. The vertices and the drawn
    band equal the one-process step's bit for bit."""
    dev = resolve_device(device)
    rows = space_rows(cfg, mesh)

    def init(first_raw):
        _, gray = _space_prep(first_raw, cfg, dev, mesh, rows, first=True)
        tl = parts.timeline_init(cfg.timeline_start, cfg.timeline_end,
                                 cfg.timeline_vertices, dev)
        return TimelinesState(gray, tl, _frame_zero(dev))

    def step(state, raw, src=None):
        resized, gray = _space_prep(raw, cfg, dev, mesh, rows, src)
        tl = parts.TimelineState(track_points(
            state.timeline.vertices, state.prev_gray, gray, cfg.lk, mesh,
            rows))
        row0 = 0 if rows is None else rows[0]
        out = draw.draw_polyline(resized, tl.vertices, RED, thickness=2,
                                 band=(row0, cfg.ydim))
        out = draw.draw_circles(out, tl.vertices, 4, BLUE,
                                 band=(row0, cfg.ydim))
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
def streaklines(cfg: ModeConfig, device="cuda", mesh=None):
    """The space form as timelines': every system's vertices in one
    ``track_points`` call (one K3 launch a rank), the systems advanced
    from the summed points on every rank, each rank drawing its band."""
    dev = resolve_device(device)
    n, cap = cfg.max_streaklines, cfg.streakline_capacity
    rows = space_rows(cfg, mesh)
    row0 = 0 if rows is None else rows[0]

    def init(first_raw):
        _, gray = _space_prep(first_raw, cfg, dev, mesh, rows, first=True)
        gen = torch.Generator().manual_seed(cfg.seed)
        gens = torch.floor(
            torch.rand((n, 2), generator=gen) *
            torch.tensor([cfg.xdim, cfg.ydim], dtype=torch.float32)).to(dev)
        return StreaklinesState(
            gray, gens, gens[:, None, :].repeat(1, cap, 1),
            torch.ones(n, dtype=torch.int32, device=dev), _frame_zero(dev))

    def step(state, raw, src=None):
        resized, gray = _space_prep(raw, cfg, dev, mesh, rows, src)
        # one shared tracker call over the vertices of every system
        tracked = track_points(state.verts.reshape(n * cap, 2),
                               state.prev_gray, gray, cfg.lk, mesh, rows)
        st = parts.streakline_advance(
            parts.StreaklineState(state.gens, state.verts, state.count),
            tracked.reshape(n, cap, 2), cfg.xdim, cfg.ydim)
        verts, count = st.vertices, st.count
        out = resized
        live = torch.arange(cap, device=dev)[None, :] < count[:, None]
        for i in range(n):
            out = draw.draw_circles(out, state.gens[i:i + 1], 3, GREEN,
                                    band=(row0, cfg.ydim))
            out = draw.draw_polyline(out, verts[i], RED, 1, valid=live[i],
                                     band=(row0, cfg.ydim))
            out = draw.draw_circles(out, verts[i], 2, BLUE, valid=live[i],
                                    band=(row0, cfg.ydim))
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
def population_map(cfg: ModeConfig, device="cuda", mesh=None):
    """The space form as timelines': the vertices through
    ``track_points``, the dots drawn and blended on the rank's band (the
    blend is per pixel). A rectangle inside one band leaves the other
    ranks with no point and no launch."""
    dev = resolve_device(device)
    x0, y0, x1, y1 = cfg.population_rect
    rows = space_rows(cfg, mesh)

    def init(first_raw):
        _, gray = _space_prep(first_raw, cfg, dev, mesh, rows, first=True)
        pop = parts.population_init(
            (x0, y0), (x1, y1), cfg.population_vertices,
            torch.Generator().manual_seed(cfg.seed),
            cfg.population_faithful_bias, dev)
        return PopulationMapState(gray, pop, _frame_zero(dev))

    def step(state, raw, src=None):
        resized, gray = _space_prep(raw, cfg, dev, mesh, rows, src)
        pop = parts.PopulationState(track_points(
            state.pop.vertices, state.prev_gray, gray, cfg.lk, mesh, rows))
        # translucent dispersal dots (ripcurrents_module.cpp:1188-1195)
        overlay = draw.draw_circles(resized, pop.vertices, 10, RED,
                                    band=(_band(cfg, rows)[0], cfg.ydim))
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
def flow_red_points(cfg: ModeConfig, device="cuda", mesh=None):
    """An LK-advected red dot cloud seeded on a coarse grid. The space
    form as timelines': the dots through ``track_points``, each rank
    drawing its band."""
    dev = resolve_device(device)
    rows = space_rows(cfg, mesh)

    def init(first_raw):
        _, gray = _space_prep(first_raw, cfg, dev, mesh, rows, first=True)
        step_px = max(cfg.xdim // 16, 8)
        ys, xs = np.mgrid[step_px // 2:cfg.ydim:step_px,
                          step_px // 2:cfg.xdim:step_px]
        pts = torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], -1)
                               .astype(np.float32)).to(dev)
        return RedPointsState(gray, pts, _frame_zero(dev))

    def step(state, raw, src=None):
        resized, gray = _space_prep(raw, cfg, dev, mesh, rows, src)
        pts = track_points(state.pts, state.prev_gray, gray,
                           LKParams.red_points(), mesh, rows)
        out = draw.draw_circles(resized, pts, 2, RED,
                                band=(_band(cfg, rows)[0], cfg.ydim))
        return RedPointsState(gray, pts, state.framecount + 1), out

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
    overlay: torch.Tensor    # (H or band, W) uint8 trail canvas
    framecount: torch.Tensor


def _trail_mode(cfg: ModeConfig, device, mesh, preset: FarnebackParams,
                seeds, subtract: bool = False, vertex_line: bool = False):
    """(init, step) of a trail mode: the flow of `preset` (less its mean
    with `subtract`), the seeds (``seeds(dev)``, (n, 2)) advected through
    it and their trails drawn on the carried canvas; the output frame is
    the frame with the canvas composited (``_composite_trails``), or with
    `vertex_line` the frame with the seeds drawn (``draw_vertex_line``).

    The space form (mesh.space K > 1; ``common.SPACE_MODES``): the bands'
    grays are gathered (``_space_prep``, the step's one exchange) and
    every rank computes the whole frame's flow, since the 100-step
    advection samples it wherever a seed goes. Every rank advects all
    seeds, the same on every rank (the flow is one process's bit for bit
    and the seeds come from the config), and keeps and draws the trail
    canvas over its band's rows only. Frames and states equal one
    process's bit for bit."""
    dev = resolve_device(device)
    fb = fb_preset(preset, cfg)
    rows = space_rows(cfg, mesh)
    row0, band_h = _band(cfg, rows)
    band = (row0, cfg.ydim)

    def init(first_raw):
        _, gray = _space_prep(first_raw, cfg, dev, mesh, rows, first=True)
        return TrailsState(flow_stream_init(gray, fb), seeds(dev),
                           torch.zeros((band_h, cfg.xdim), dtype=torch.uint8,
                                       device=dev), _frame_zero(dev))

    def step(state, raw, src=None):
        resized, gray = _space_prep(raw, cfg, dev, mesh, rows, src)
        flow, fs = flow_stream_step(state.fstream, gray, fb)
        if subtract:
            flow = meanflow.subtract_average(flow)
        fc = state.framecount + 1
        moved, overlay = _advect_and_draw_trails(
            state.seeds, state.overlay, flow, fc, cfg,
            upper=cfg.thresholds.upper_init, band=band)
        out = draw_vertex_line(resized, moved, fc, band) if vertex_line \
            else _composite_trails(resized, overlay)
        return TrailsState(fs, moved, overlay, fc), out

    return init, step


def draw_vertex_line(frame_u8, seeds, fc, band=None):
    """timelinesFarne's output: the vertices as circles joined by a
    polyline, and the frame count. With band=(row0, frame_h), frame_u8
    is rows [row0, row0 + its height) of a frame_h-row frame and gets
    those rows of the whole frame's drawing."""
    out = draw.draw_circles(frame_u8, seeds[:1], 4, BLUE, band=band)
    out = draw.draw_polyline(out, seeds, RED, 2, band=band)
    out = draw.draw_circles(out, seeds[1:], 4, BLUE, band=band)
    return draw.draw_frame_count(out, fc, row0=band[0] if band else 0)


@register("streamlines")
def streamlines_mode(cfg: ModeConfig, device="cuda", mesh=None):
    """The space form as ``_trail_mode``'s."""
    return _trail_mode(
        cfg, device, mesh, FarnebackParams.streamlines(),
        lambda dev: torch.tensor([[300.0, 300.0]], device=dev))  # main.cpp:240


@register("timelinesOnSubtractAverageVector")
def timelines_on_subtract(cfg: ModeConfig, device="cuda", mesh=None):
    """The space form as ``_trail_mode``'s: the mean subtracted is the
    whole flow's, which every rank holds."""
    def seeds(dev):
        gen = torch.Generator().manual_seed(cfg.seed)
        return torch.floor(
            torch.rand((cfg.n_streamline_seeds, 2), generator=gen) *
            torch.tensor([cfg.xdim, cfg.ydim], dtype=torch.float32)).to(dev)

    return _trail_mode(cfg, device, mesh,
                       FarnebackParams.streamlines(),  # main.cpp:742
                       seeds, subtract=True)


@register("timelinesFarne")
def timelines_farne(cfg: ModeConfig, device="cuda", mesh=None):
    """The space form as ``_trail_mode``'s; each rank draws the vertex
    line and the frame count on its band (``draw_vertex_line``)."""
    def seeds(dev):
        # the vertex line (100,100)-(500,100), 20 vertices (main.cpp:873-889)
        return parts.timeline_init((100.0, 100.0), (500.0, 100.0), 20,
                                   dev).vertices[:20]

    return _trail_mode(cfg, device, mesh,
                       FarnebackParams.subtract_average(),  # main.cpp:961
                       seeds, vertex_line=True)


# ---------------------------------------------------------------------------
# mean-subtracted HSV modes (main.cpp:526-658, 1023-1192)
# ---------------------------------------------------------------------------

class SubtractAverageState(NamedTuple):
    fstream: FlowStream
    max_disp: torch.Tensor
    framecount: torch.Tensor


@register("subtructAverageVector", gray_input=True)
def subtract_average_vector(cfg: ModeConfig, device="cuda", mesh=None):
    """The space form (mesh.space K > 1; ``common.SPACE_MODES``): the
    bands' grays are gathered (``_space_prep``, the step's one exchange)
    and every rank computes the whole frame's flow and subtracts its mean
    as one process does; it colours and labels its band's rows. The new
    running maximum is the whole flow's, which every rank holds. Frames
    and states equal one process's bit for bit."""
    dev = resolve_device(device)
    fb = fb_preset(FarnebackParams.subtract_average(), cfg)
    rows = space_rows(cfg, mesh)
    row0, _ = _band(cfg, rows)

    def init(first_raw):
        _, gray = _space_prep(first_raw, cfg, dev, mesh, rows, first=True)
        return SubtractAverageState(flow_stream_init(gray, fb),
                                    _max_init(dev), _frame_zero(dev))

    def step(state, raw, src=None):
        _, gray = _space_prep(raw, cfg, dev, mesh, rows, src)
        flow, fs = flow_stream_step(state.fstream, gray, fb)
        colored = vector_to_color(meanflow.subtract_average(flow),
                                  state.max_disp, rows)
        fc = state.framecount + 1
        out = draw.draw_frame_count(colored.bgr_u8, fc, row0=row0)
        return SubtractAverageState(fs, colored.max_displacement, fc), out

    return init, step


class WindowedState(NamedTuple):
    fstream: FlowStream
    ring: meanflow.RingMean
    max_disp: torch.Tensor
    framecount: torch.Tensor


@register("subtructAverageVectorWithWindow")
def subtract_average_windowed(cfg: ModeConfig, device="cuda", mesh=None):
    """The space form: every rank computes the whole frame's flow from the
    gathered grays (``_space_prep``) and keeps the window's ring over its
    band's rows only (the ring is per pixel); the running maximum is a
    max over the group of the bands' (the step's second exchange), and
    the frame count and the legend are drawn on the band. Frames, the
    ring's rows and the maximum equal one process's bit for bit."""
    dev = resolve_device(device)
    fb = fb_preset(FarnebackParams.windowed(), cfg)
    rows = space_rows(cfg, mesh)
    row0, band_h = _band(cfg, rows)
    # the colour-wheel legend at the top right (main.cpp:1097, 1161-1162)
    legend = color_wheel(cfg.ydim // 8, device=dev)

    def init(first_raw):
        _, gray = _space_prep(first_raw, cfg, dev, mesh, rows, first=True)
        ring = meanflow.ring_init(cfg.window_size, (band_h, cfg.xdim, 2),
                                  dev)
        return WindowedState(flow_stream_init(gray, fb), ring,
                             _max_init(dev), _frame_zero(dev))

    def step(state, raw, src=None):
        resized, gray = _space_prep(raw, cfg, dev, mesh, rows, src)
        flow, fs = flow_stream_step(state.fstream, gray, fb)
        ring = meanflow.ring_update(state.ring, flow[row0:row0 + band_h])
        colored = vector_to_color(ring.mean, state.max_disp)
        fc = state.framecount + 1
        overlay = draw.draw_frame_count(colored.bgr_u8, fc, row0=row0)
        overlay = draw.paste(overlay, legend, 0, cfg.xdim - cfg.ydim // 8,
                             band=(row0, cfg.ydim))
        out = draw.blend(resized, overlay, 0.4, 0.6)
        new_max = space_all_reduce(mesh, colored.max_displacement, "max",
                                   label="max")
        return WindowedState(fs, ring, new_max, fc), out

    return init, step


class ShearState(NamedTuple):
    fstream: FlowStream
    ring: meanflow.RingMean
    max_frob: torch.Tensor
    framecount: torch.Tensor


@register("shearRate")
def shear_rate(cfg: ModeConfig, device="cuda", mesh=None):
    """The space form: every rank computes the whole frame's flow from the
    gathered grays (``_space_prep``) and keeps the ring over its band and
    ``shear.OFFSET`` rows on each side (``shear_rows``), cut from that
    whole flow, so the shear's differences across rows need no halo
    exchange; the band's rows are coloured, the running maximum is a max
    over the group of the bands' (the step's second exchange). Frames,
    the ring's rows and the maximum equal one process's bit for bit."""
    dev = resolve_device(device)
    fb = fb_preset(FarnebackParams.windowed(), cfg)
    rows = space_rows(cfg, mesh)
    row0, _ = _band(cfg, rows)
    s0, s1 = shear_rows(rows, cfg.ydim) if rows else (0, cfg.ydim)
    # the shear colour-chart legend at the top right (main.cpp:1458-1462),
    # drawn from the hue mapping itself
    legend = shear_color_chart(cfg.ydim // 12, cfg.xdim // 4, device=dev)

    def init(first_raw):
        _, gray = _space_prep(first_raw, cfg, dev, mesh, rows, first=True)
        ring = meanflow.ring_init(cfg.shear_window, (s1 - s0, cfg.xdim, 2),
                                  dev)
        return ShearState(flow_stream_init(gray, fb), ring, _max_init(dev),
                          _frame_zero(dev))

    def step(state, raw, src=None):
        resized, gray = _space_prep(raw, cfg, dev, mesh, rows, src)
        flow, fs = flow_stream_step(state.fstream, gray, fb)
        ring = meanflow.ring_update(state.ring, flow[s0:s1])
        sheared = shear.shear_to_color(ring.mean, state.max_frob,
                                       band=(s0, cfg.ydim), rows=rows)
        fc = state.framecount + 1
        overlay = draw.draw_frame_count(hsv_to_bgr(sheared.hsv_u8), fc,
                                        row0=row0)
        overlay = draw.paste(overlay, legend, 0, cfg.xdim - cfg.xdim // 4,
                             band=(row0, cfg.ydim))
        out = draw.blend(resized, overlay, 0.5, 0.5)
        new_max = space_all_reduce(mesh, sheared.max_frobenius, "max",
                                   label="max")
        return ShearState(fs, ring, new_max, fc), out

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
def average_vector_mode(cfg: ModeConfig, device="cuda", mesh=None):
    """The 300-frame counter-flow arrow detector as a standalone mode.

    The space form: every rank computes the whole frame's flow from the
    gathered grays (``_space_prep``) and keeps the ring of deltas over its
    band's rows only; the bands' ring means are gathered once a frame
    (the step's second exchange), and from that whole mean every rank
    computes the global angle, the grid angles, the counter-flow mask
    and the new maximum as one process does (``meanflow.
    average_vector``). The HSV field, the circles and the arrows are
    drawn on the band. Frames, the ring's rows and the maximum equal one
    process's bit for bit."""
    dev = resolve_device(device)
    fb = fb_preset(FarnebackParams.subtract_average(), cfg)
    rows = space_rows(cfg, mesh)
    row0, band_h = _band(cfg, rows)
    band = (row0, cfg.ydim)
    center = torch.tensor([[cfg.xdim / 2.0, cfg.ydim / 2.0]], device=dev)

    def whole_mean(m):
        return space_gather_rows(mesh, m, "ring mean")

    def init(first_raw):
        _, gray = _space_prep(first_raw, cfg, dev, mesh, rows, first=True)
        return AverageVectorModeState(
            flow_stream_init(gray, fb),
            meanflow.average_vector_init(band_h, cfg.xdim,
                                         cfg.average_buffer, dev),
            _frame_zero(dev))

    def step(state, raw, src=None):
        _, gray = _space_prep(raw, cfg, dev, mesh, rows, src)
        flow, fs = flow_stream_step(state.fstream, gray, fb)
        av = meanflow.average_vector(state.av, flow,
                                     cfg.thresholds.upper_init, rows=rows,
                                     gather=whole_mean)
        img = hsv_to_bgr(av.hsv_u8)
        a = av.global_angle_rad
        tip = center + torch.stack([torch.cos(a) * 10.0,
                                    torch.sin(a) * 50.0])[None]
        img = draw.draw_circles(img, center, 3, GOLD, band=band)
        img = draw.draw_arrows(img, center, tip,
                               torch.ones(1, dtype=torch.bool, device=dev),
                               GOLD, 2, 0.2, band=band)
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
        img = draw.draw_circles(img, anchors, 1, LIME, valid=mask,
                                band=band)
        img = draw.draw_arrows(img, anchors, tips, mask, LIME, 1, 0.4,
                               band=band)
        return AverageVectorModeState(fs, av.state, state.framecount + 1), img

    return init, step


# ---------------------------------------------------------------------------
# temporal exposure modes (main.cpp:1195-1382)
# ---------------------------------------------------------------------------

def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


@register("averageHSV")
def average_hsv(cfg: ModeConfig, device="cuda", mesh=None):
    """averageHSV (ripcurrents_module.cpp:365-376, driven from the dead
    main_old.cpp:360): the ring mean of the last BUFFER_FRAME frames. The
    reference's quirk is kept: despite the name it never converts to HSV
    (its cvtColor is commented out at ripcurrents_module.cpp:367) and
    averages the BGR frame. The state is the ring itself
    (``meanflow.RingMean``; 1.1 GB of float32 at 640x480 and 300
    frames, copied by each out-of-place step). The space form keeps the
    ring over the band's rows (1/K of it a rank)."""
    dev = resolve_device(device)
    rows = space_rows(cfg, mesh)
    band_h = _band(cfg, rows)[1]

    def init(first_raw):
        return meanflow.ring_init(cfg.average_buffer,
                                  (band_h, cfg.xdim, 3), dev)

    def step(state, raw, src=None):
        resized, _ = prep_frame(to_device(raw, dev), cfg, rows=rows,
                                src=src)
        state = meanflow.average_hsv_update(state, resized)
        return state, _u8(state.mean)

    return init, step


class TimexState(NamedTuple):
    sum_rgb: torch.Tensor     # (H or band, W, 3) float32 running sum
    framecount: torch.Tensor


@register("timex")
def timex(cfg: ModeConfig, device="cuda", mesh=None):
    """compute_timex (main.cpp:1195-1263): the running mean of the raw
    frames. The space form keeps the sum over the band's rows."""
    dev = resolve_device(device)
    rows = space_rows(cfg, mesh)
    row0, band_h = _band(cfg, rows)

    def init(first_raw):
        return TimexState(torch.zeros((band_h, cfg.xdim, 3),
                                      dtype=torch.float32, device=dev),
                          _frame_zero(dev))

    def step(state, raw, src=None):
        resized, _ = prep_frame(to_device(raw, dev), cfg, rows=rows,
                                src=src)
        s = meanflow.timex_update(state.sum_rgb, resized)
        fc = state.framecount + 1
        out = draw.draw_frame_count(_u8(s / fc.to(torch.float32)), fc,
                                    row0=row0)
        return TimexState(s, fc), out

    return init, step


class BrightColorState(NamedTuple):
    buffer: torch.Tensor      # (window, H or band, W, 3) uint8 HSV
    idx: torch.Tensor         # () int32 next slot
    framecount: torch.Tensor


@register("brightColor")
def bright_color(cfg: ModeConfig, device="cuda", mesh=None):
    """compute_brightColor (main.cpp:1265-1382) over a ring of the last
    ``bright_window`` frames. The reference's quirks are kept: it converts
    BGR data with RGB2HSV (main.cpp:1303) and HSV2RGB's output is written
    to a BGR frame. The new frame goes into a new buffer; the state's is
    not written. The space form keeps the ring over the band's rows (the
    reduction is per pixel)."""
    dev = resolve_device(device)
    rows = space_rows(cfg, mesh)
    row0, band_h = _band(cfg, rows)

    def init(first_raw):
        return BrightColorState(
            torch.zeros((cfg.bright_window, band_h, cfg.xdim, 3),
                        dtype=torch.uint8, device=dev),
            _frame_zero(dev), _frame_zero(dev))

    def step(state, raw, src=None):
        resized, _ = prep_frame(to_device(raw, dev), cfg, rows=rows,
                                src=src)
        buf = state.buffer.index_copy(0, state.idx.reshape(1).long(),
                                      rgb_to_hsv(resized)[None])
        reduced = meanflow.bright_color_reduce(buf, cfg.bright_option)
        fc = state.framecount + 1
        out = draw.draw_frame_count(
            torch.flip(hsv_to_bgr(reduced), dims=(-1,)), fc, row0=row0)
        return BrightColorState(buf, (state.idx + 1) % cfg.bright_window,
                                fc), out

    return init, step


# ---------------------------------------------------------------------------
# stabilization modes
# ---------------------------------------------------------------------------

class PhaseCorrelateState(NamedTuple):
    # the compensated previous frame (BGR u8); a space rank keeps only
    # the ROI's rows of it (``roi_rows``)
    prev_resized: torch.Tensor
    framecount: torch.Tensor


def roi_rows(cfg: ModeConfig) -> "tuple[int, int]":
    """The frame rows [y, y + h) of phaseCorrelate's ROI (x, y, w, h),
    its start clamped so that it fits, as ``jax.lax.dynamic_slice``
    clamps it."""
    y, h = cfg.phase_roi[1], cfg.phase_roi[3]
    y = min(max(y, 0), cfg.ydim - h)
    return y, y + h


@register("phaseCorrelate", area_input=True)
def phase_correlate_mode(cfg: ModeConfig, device="cuda", mesh=None):
    """compute_phaseCorrelate (main.cpp:1684-1775): the translation of a
    beach ROI between the compensated previous frame and the new one,
    undone by a bilinear translation. Every frame is resized with
    INTER_AREA (main.cpp:1736).

    The space form: each rank is fed the whole frame (``common.
    AREA_INPUT``), resizes it as one process does and computes the
    shift, with no exchange; each translates only its band's rows, which read |dy| + 1 rows past the
    band, and the ROI's rows (``roi_rows``), which it keeps as the state:
    the next shift reads no other row. Frames and the kept rows equal
    one process's bit for bit."""
    dev = resolve_device(device)
    win = hanning_window(cfg.phase_roi[3], cfg.phase_roi[2], dev)
    rows = space_rows(cfg, mesh)
    keep = roi_rows(cfg) if rows else None

    def init(first_raw):
        resized, _ = prep_frame(to_device(first_raw, dev), cfg, first=True)
        return PhaseCorrelateState(
            resized if keep is None else resized[keep[0]:keep[1]],
            _frame_zero(dev))

    def step(state, raw, src=None):
        resized, _ = prep_frame(to_device(raw, dev), cfg, first=True)
        shift = phase_shift(state.prev_resized, resized, cfg.phase_roi,
                            win, prev_row0=keep[0] if keep else 0)
        out = translate(resized, -shift[0], -shift[1], rows=rows)
        prev = out if keep is None else translate(
            resized, -shift[0], -shift[1], rows=keep)
        return PhaseCorrelateState(prev, state.framecount + 1), out

    return init, step


def phase_shift(prev_resized: torch.Tensor, resized: torch.Tensor, roi,
                window: torch.Tensor, prev_row0: int = 0) -> torch.Tensor:
    """phaseCorrelate's (dx, dy): the translation of the ROI (x, y, w, h)
    from the compensated previous frame to the new one, both (H, W, 3)
    uint8 BGR (prev_resized may hold rows [prev_row0, ...) only, the
    ROI's among them), the ROI's start clamped so that it fits. The mode
    undoes it with ``translate``."""
    rx, ry, rw, rh = roi
    y = min(max(ry, 0), resized.shape[0] - rh)
    x = min(max(rx, 0), resized.shape[1] - rw)
    pg = bgr_to_gray(prev_resized[y - prev_row0:y - prev_row0 + rh,
                                  x:x + rw])
    cg = bgr_to_gray(resized[y:y + rh, x:x + rw])
    return phase_correlate(pg.to(torch.float32), cg.to(torch.float32),
                           window).shift


class StabilizeState(NamedTuple):
    prev_gray: torch.Tensor     # gray of the previous corrected frame
    framecount: torch.Tensor


@register("stabilizeTPU")
def stabilize_tpu(cfg: ModeConfig, device="cuda", mesh=None):
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
    step, and each of RANSAC's two SVD calls waits twice.

    The space form: each rank resizes its band, the bands are gathered
    into the whole colour frame on every rank (``_space_prep``, one
    exchange) and every rank runs the whole step: the features, RANSAC
    from the same generator (so the same H), K8's warp of the whole frame
    and the corrected frame's gray, which it keeps whole. Each outputs
    its band's rows."""
    dev = resolve_device(device)
    if cfg.stab_features not in FEATURES:
        raise ValueError(f"stab_features {cfg.stab_features!r}: expected "
                         f"one of {FEATURES}")
    rows = space_rows(cfg, mesh)

    def init(first_raw):
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        return StabilizeState(gray, _frame_zero(dev))

    def step(state, raw, src=None):
        resized, gray = _space_prep(raw, cfg, dev, mesh, rows, src,
                                    colour=True)
        gen = step_generator(cfg.seed, int(state.framecount), dev)
        corrected, _, _ = stabilize_pair(state.prev_gray, gray, resized, gen,
                                         features=cfg.stab_features)
        out = corrected if rows is None else corrected[rows[0]:rows[1]]
        return StabilizeState(bgr_to_gray(corrected),
                              state.framecount + 1), out

    return init, step


class GlobalOrientationState(NamedTuple):
    prev_gray: torch.Tensor
    framecount: torch.Tensor


@register("globalOrientation", gray_input=True)
def global_orientation_mode(cfg: ModeConfig, device="cuda", mesh=None):
    """globalOrientation (ripcurrents_module.cpp:319-359) as a mode: the
    motion-history image, the global direction arrow and a 30-px grid of
    local orientation arrows.

    The space form: the bands' grays are gathered (``_space_prep``, one
    exchange) and every rank runs the whole step, since its maximum,
    12-bin vote and weighted mean are reductions over the frame that
    band sums, added, would round otherwise; each rank colours its band
    of the motion-history image and draws its band of the circles and
    arrows."""
    dev = resolve_device(device)
    rows = space_rows(cfg, mesh)
    row0, band_h = _band(cfg, rows)
    band = (row0, cfg.ydim)
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

    def step(state, raw, src=None):
        _, gray = _space_prep(raw, cfg, dev, mesh, rows, src)
        res = global_orientation_step(state.prev_gray, gray)
        mhi = res.mhi_norm[row0:row0 + band_h]
        out = _u8(mhi * 255.0)[..., None].repeat(1, 1, 3)
        ar = res.angle_deg * math.pi / 180.0
        tip = center + torch.stack([torch.cos(ar) * 10.0,
                                    torch.sin(ar) * 50.0])[None, :]
        out = draw.draw_circles(out, center, 3, GOLD, band=band)
        out = draw.draw_arrows(out, center, tip, one, GOLD, 2, 0.2,
                               band=band)
        gr = res.orientation.orientation_deg[gy, gx] * math.pi / 180.0
        tips = grid + torch.stack([torch.cos(gr), torch.sin(gr)], -1) * 10.0
        out = draw.draw_circles(out, grid, 1, (0, 215, 0), band=band)
        out = draw.draw_arrows(out, grid, tips, every, (0, 215, 0), 1, 0.4,
                               band=band)
        return GlobalOrientationState(gray, state.framecount + 1), out

    return init, step
