"""The legacy full rip-current detection pipeline, one step per frame.

Port of ``ripcurrents_tpu/pipelines/legacy.py`` (the reference's
ripcurrents.cpp:53-540): frame -> Farneback (box, winsize 3) -> per-pixel
streamline field + displacement/distance/ratio JET views + particle
density -> discrete streamline trails -> polar -> cumulative histograms ->
UPPER / UPPER2d / prop_above_upper -> fast/slow classification -> wave
accumulation (after frame 30) -> duty-cycle mask -> elliptical morphology
edges -> red-edge overlay.

All temporal state is an explicit ``LegacyState`` of tensors on the
device; a step launches device work only and never waits for it.

The space form (``make_legacy(cfg, mesh=mesh)`` with mesh.space K > 1)
splits the frame's rows over the mesh's 'space' group: each rank holds
one band of ydim / K rows of the frame and of every per-pixel state and
computes the step on it. Per frame it exchanges, on the group:

- the new frame's halo rows for its Farneback slab
  (``parallel/spatial.py: spatial_stream_step``; the halo from
  ``stream_halo``, 64 rows for the legacy preset), so the stream's
  kernels (K5, K6, K1, K2, K4) run on a slab of band + 2 x halo rows;
- the band flows, gathered into the whole frame's flow on every rank
  (the per-pixel particles and the 250 replicated seeds sample it
  anywhere in the frame);
- the maxima of the three JET fields, the density scatter (a full-frame
  0/1 map, max-reduced: its particles cross bands) and the histogram
  counts (summed, exact), so every rank derives the same thresholds;
- ``morphology.EDGE_HALO`` rows of the rip mask for ``rip_edges``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ripcurrents_tpu_torch import resolve_device
from ripcurrents_tpu_torch.analysis import classify as cls
from ripcurrents_tpu_torch.config import FarnebackParams, Thresholds
from ripcurrents_tpu_torch.dynamics import advect
from ripcurrents_tpu_torch.ops import hist as histops
from ripcurrents_tpu_torch.ops import morphology as morph
from ripcurrents_tpu_torch.ops.color import hsv_to_bgr
from ripcurrents_tpu_torch.ops.colormap import apply_colormap, normalize_to_u8
from ripcurrents_tpu_torch.ops.polar import flow_to_polar
from ripcurrents_tpu_torch.parallel import spatial
from ripcurrents_tpu_torch.parallel.mesh import (space_all_reduce,
                                                 space_gather_rows)
from ripcurrents_tpu_torch.pipelines.common import (FlowStream, ModeConfig,
                                                    fb_preset,
                                                    flow_stream_init,
                                                    flow_stream_step,
                                                    prep_frame, register,
                                                    space_rows, to_device)
from ripcurrents_tpu_torch.pipelines.modes import (_advect_and_draw_trails,
                                                   _composite_trails)
from ripcurrents_tpu_torch.viz.color import histogram_wheel


class LegacyState(NamedTuple):
    fstream: "FlowStream | spatial.SpatialStream"
    field: advect.FieldState          # per-pixel streamline field
    seeds: torch.Tensor               # (N, 2) discrete streamline particles
    overlay: torch.Tensor             # (H, W) uint8 trail canvas
    hist: histops.FlowHistogram       # cumulative across frames
    upper: torch.Tensor               # current UPPER estimate
    accumulator: torch.Tensor         # (H, W) fast-pixel counts
    framecount: torch.Tensor          # () int32


class LegacyOutputs(NamedTuple):
    """One frame's outputs: the reference's imshow windows and its three
    video writers."""
    overlay_bgr: torch.Tensor         # red-edge composite (video_borders)
    streamlines_bgr: torch.Tensor     # discrete trails (video_streamlines)
    density_bgr: torch.Tensor         # particle positions (streamlines_only)
    displacement_bgr: torch.Tensor    # JET displacement field
    distance_bgr: torch.Tensor        # JET total-motion field
    ratio_bgr: torch.Tensor           # JET displacement/distance ratio
    flow_hsv_bgr: torch.Tensor        # classified polar flow view
    duty_bgr: torch.Tensor            # accumulated duty visualization
    hist_wheel_bgr: torch.Tensor      # per-frame threshold wheel
    mask: torch.Tensor                # (H, W) uint8 rip mask (pre-edges)


def space_halo(cfg: ModeConfig) -> int:
    """The halo rows of the space form's Farneback slabs
    (``spatial.stream_halo`` of the legacy preset at the working size)."""
    return spatial.stream_halo(fb_preset(FarnebackParams.legacy(), cfg),
                               (cfg.ydim, cfg.xdim))


def make_legacy(cfg: ModeConfig, device="cuda", mesh=None):
    """-> (init(first_raw) -> LegacyState, step(state, raw) ->
    (LegacyState, LegacyOutputs)). Raw frames are (H, W, 3) uint8 BGR,
    as numpy arrays or tensors. device="cuda" (the default) raises when
    no card is available; pass device="cpu" for the plain versions.

    With `mesh` (mesh.space > 1) the step is the space form (module
    doc): init takes the whole first frame; step(state, raw, src=None)
    takes a frame or, with src=(a0, src_h), its source rows from a0
    (``prep_frame``), and returns the outputs' rows of this rank's band
    (the threshold wheel whole). Every rank of the group steps together."""
    dev = resolve_device(device)
    fb = fb_preset(FarnebackParams.legacy(), cfg)
    thr = Thresholds(upper_init=100.0)   # ripcurrents.cpp:145
    rows = space_rows(cfg, mesh)
    row0, band_h = (0, cfg.ydim) if rows is None else (rows[0],
                                                       rows[1] - rows[0])
    if rows is not None:
        halo = space_halo(cfg)

    def init(first_raw) -> LegacyState:
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True,
                             rows=rows)
        gen = torch.Generator().manual_seed(cfg.seed)
        seeds = torch.floor(
            torch.rand((cfg.legacy_seeds, 2), generator=gen) *
            torch.tensor([cfg.xdim, cfg.ydim], dtype=torch.float32))
        return LegacyState(
            flow_stream_init(gray, fb) if rows is None else
            spatial.spatial_stream_init(gray, fb, mesh, halo),
            advect.init_field(band_h, cfg.xdim, dev), seeds.to(dev),
            torch.zeros((band_h, cfg.xdim), dtype=torch.uint8, device=dev),
            histops.empty_histogram(cfg.hist, dev),
            torch.tensor(thr.upper_init, dtype=torch.float32, device=dev),
            torch.zeros((band_h, cfg.xdim), dtype=torch.float32,
                        device=dev),
            torch.tensor(0, dtype=torch.int32, device=dev))

    def step(state: LegacyState, raw, src=None):
        resized, gray = prep_frame(to_device(raw, dev), cfg, rows=rows,
                                   src=src)
        fc = state.framecount + 1
        if rows is None:
            flow, fs = flow_stream_step(state.fstream, gray, fb)
            frame_flow = flow
        else:
            flow, fs = spatial.spatial_stream_step(state.fstream, gray, fb,
                                                   mesh, halo)
            frame_flow = space_gather_rows(mesh, flow, "flow bands")

        # per-pixel streamline field (ripcurrents.cpp:229-231; dt=2, 1 iter)
        field = advect.streamline_field(state.field, frame_flow, 2.0, 1,
                                        state.upper, row0)
        disp_mag = torch.sqrt(torch.sum(field.disp ** 2, dim=-1))
        ratio_f = disp_mag / torch.clamp(field.dist, min=1e-12)
        top = space_all_reduce(mesh, torch.stack(
            [disp_mag.max(), field.dist.max(), ratio_f.max()]), "max",
            "field maxima")
        displacement = apply_colormap(normalize_to_u8(disp_mag, top[0]),
                                      "jet")
        distance = apply_colormap(normalize_to_u8(field.dist, top[1]), "jet")
        ratio = apply_colormap(normalize_to_u8(ratio_f, top[2]), "jet")

        # particle position density scatter (ripcurrents.cpp:262-279); the
        # band's particles land anywhere in the frame
        ys, xs = torch.meshgrid(
            torch.arange(row0, row0 + band_h, dtype=torch.float32,
                         device=dev),
            torch.arange(cfg.xdim, dtype=torch.float32, device=dev),
            indexing="ij")
        px = torch.floor(field.disp[..., 0] + xs).to(torch.int32)
        py = torch.floor(field.disp[..., 1] + ys).to(torch.int32)
        ok = (px >= 1) & (py >= 1) & (px + 2 <= cfg.xdim) & \
            (py + 2 <= cfg.ydim)
        flat = torch.where(ok, py * cfg.xdim + px, 0).reshape(-1).long()
        density = torch.zeros(cfg.ydim * cfg.xdim, dtype=torch.float32,
                              device=dev).scatter_reduce(
            0, flat, ok.to(torch.float32).reshape(-1), reduce="amax")
        if rows is not None:
            density = space_all_reduce(mesh, density.to(torch.uint8), "max",
                                       "density")
        density = density.reshape(cfg.ydim, cfg.xdim)[row0:row0 + band_h]
        density_bgr = (density.to(torch.float32)[..., None] *
                       255).to(torch.uint8).repeat(1, 1, 3)

        # discrete streamlines (dt=2, 1 iteration per frame,
        # ripcurrents.cpp:283-285); the seeds are the same on every rank
        seeds, overlay = _advect_and_draw_trails(
            state.seeds, state.overlay, frame_flow, fc, cfg, dt=2.0,
            iters=1, upper=state.upper, band=(row0, cfg.ydim))
        streamlines_bgr = _composite_trails(resized, overlay)

        # polar + cumulative histograms -> thresholds
        mag, ang = flow_to_polar(flow)
        counts = space_all_reduce(mesh, histops.bin_counts(mag, ang,
                                                           cfg.hist),
                                  label="histogram")
        hist = histops.accumulate(state.hist,
                                  histops.from_counts(counts, cfg.hist))
        th = histops.thresholds(hist, cfg.hist)

        # per-frame threshold wheel (ripcurrents.cpp:368)
        wheel = histogram_wheel(th.upper2d, th.prop_above_upper, cfg.hist,
                                size=min(cfg.ydim, cfg.xdim))

        # classification + display form (angle, sat, val/upper2d)
        res = cls.classify(ang, mag, th.upper, thr.mid, thr.lower,
                           th.upper2d, cfg.hist)
        flow_bgr = torch.clamp(torch.round(
            hsv_to_bgr(res.display_hsv.to(torch.float32)) * 255), 0,
            255).to(torch.uint8)

        # temporal accumulation of fast pixels (after frame 30)
        accumulator = cls.accumulate_waves(state.accumulator, res.fast_mask,
                                           fc, warmup=30)
        viz = cls.duty_cycle_viz(accumulator, fc)
        duty_bgr = torch.clamp(torch.round(viz.out * 255), 0,
                               255).to(torch.uint8)

        # morphology edges + red burn-in
        if rows is None:
            edges = morph.rip_edges(viz.outmask)
        else:
            edges = morph.rip_edges(viz.outmask, *spatial.exchange_rows(
                mesh, viz.outmask, morph.EDGE_HALO, "mask halo"))
        out = cls.burn_mask_red(resized, edges)

        new_state = LegacyState(fs, field, seeds, overlay, hist, th.upper,
                                accumulator, fc)
        return new_state, LegacyOutputs(out, streamlines_bgr, density_bgr,
                                        displacement, distance, ratio,
                                        flow_bgr, duty_bgr, wheel,
                                        viz.outmask)

    return init, step


@register("legacy")
def legacy_mode(cfg: ModeConfig, device="cuda", mesh=None):
    """Registry wrapper returning just the red-edge overlay frame."""
    init, step = make_legacy(cfg, device=device, mesh=mesh)

    def step_overlay(state, raw, src=None):
        state, outs = step(state, raw, src)
        return state, outs.overlay_bgr

    return init, step_overlay
