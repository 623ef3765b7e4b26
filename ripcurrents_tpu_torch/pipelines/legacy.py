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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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
from ripcurrents_tpu_torch.pipelines.common import (FlowStream, ModeConfig,
                                                    flow_stream_init,
                                                    flow_stream_step,
                                                    prep_frame)
from ripcurrents_tpu_torch.pipelines.modes import (_advect_and_draw_trails,
                                                   _composite_trails)
from ripcurrents_tpu_torch.viz.color import histogram_wheel


class LegacyState(NamedTuple):
    fstream: FlowStream
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


def make_legacy(cfg: ModeConfig, device="cuda"):
    """-> (init(first_raw) -> LegacyState, step(state, raw) ->
    (LegacyState, LegacyOutputs)). Raw frames are (H, W, 3) uint8 BGR,
    as numpy arrays or tensors. device="cuda" (the default) raises when
    no card is available; pass device="cpu" for the plain versions."""
    dev = resolve_device(device)
    fb = FarnebackParams.legacy()
    thr = Thresholds(upper_init=100.0)   # ripcurrents.cpp:145

    def to_dev(raw):
        return torch.as_tensor(np.asarray(raw) if not torch.is_tensor(raw)
                               else raw).to(dev)

    def init(first_raw) -> LegacyState:
        _, gray = prep_frame(to_dev(first_raw), cfg, first=True)
        gen = torch.Generator().manual_seed(cfg.seed)
        seeds = torch.floor(
            torch.rand((cfg.legacy_seeds, 2), generator=gen) *
            torch.tensor([cfg.xdim, cfg.ydim], dtype=torch.float32))
        return LegacyState(
            flow_stream_init(gray, fb),
            advect.init_field(cfg.ydim, cfg.xdim, dev), seeds.to(dev),
            torch.zeros((cfg.ydim, cfg.xdim), dtype=torch.uint8, device=dev),
            histops.empty_histogram(cfg.hist, dev),
            torch.tensor(thr.upper_init, dtype=torch.float32, device=dev),
            torch.zeros((cfg.ydim, cfg.xdim), dtype=torch.float32,
                        device=dev),
            torch.tensor(0, dtype=torch.int32, device=dev))

    def step(state: LegacyState, raw):
        resized, gray = prep_frame(to_dev(raw), cfg)
        fc = state.framecount + 1
        flow, fs = flow_stream_step(state.fstream, gray, fb)

        # per-pixel streamline field (ripcurrents.cpp:229-231; dt=2, 1 iter)
        field = advect.streamline_field(state.field, flow, 2.0, 1,
                                        state.upper)
        disp_mag = torch.sqrt(torch.sum(field.disp ** 2, dim=-1))
        displacement = apply_colormap(normalize_to_u8(disp_mag), "jet")
        distance = apply_colormap(normalize_to_u8(field.dist), "jet")
        ratio = apply_colormap(normalize_to_u8(
            disp_mag / torch.clamp(field.dist, min=1e-12)), "jet")

        # particle position density scatter (ripcurrents.cpp:262-279)
        ys, xs = torch.meshgrid(
            torch.arange(cfg.ydim, dtype=torch.float32, device=dev),
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
        density_bgr = (density.reshape(cfg.ydim, cfg.xdim)[..., None] *
                       255).to(torch.uint8).repeat(1, 1, 3)

        # discrete streamlines (dt=2, 1 iteration per frame,
        # ripcurrents.cpp:283-285)
        seeds, overlay = _advect_and_draw_trails(
            state.seeds, state.overlay, flow, fc, cfg, dt=2.0, iters=1,
            upper=state.upper)
        streamlines_bgr = _composite_trails(resized, overlay)

        # polar + cumulative histograms -> thresholds
        mag, ang = flow_to_polar(flow)
        hist = histops.accumulate(state.hist,
                                  histops.bin_flow(mag, ang, cfg.hist))
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
        edges = morph.rip_edges(viz.outmask)
        out = cls.burn_mask_red(resized, edges)

        new_state = LegacyState(fs, field, seeds, overlay, hist, th.upper,
                                accumulator, fc)
        return new_state, LegacyOutputs(out, streamlines_bgr, density_bgr,
                                        displacement, distance, ratio,
                                        flow_bgr, duty_bgr, wheel,
                                        viz.outmask)

    return init, step
