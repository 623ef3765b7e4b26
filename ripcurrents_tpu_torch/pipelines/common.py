"""Shared pipeline plumbing: the mode registry, configuration, frame prep,
the flow stream and the detector-core scan (port of the parts of
``ripcurrents_tpu/pipelines/common.py`` that the ported modes need)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from ripcurrents_tpu_torch import resolve_device
from ripcurrents_tpu_torch.analysis import classify as cls
from ripcurrents_tpu_torch.config import (FarnebackParams, HistogramParams,
                                          LKParams, Thresholds, XDIM, YDIM)
from ripcurrents_tpu_torch.flow.farneback import (farneback_precompute,
                                                  farneback_stream)
from ripcurrents_tpu_torch.ops import hist as histops
from ripcurrents_tpu_torch.ops.image import (bgr_to_gray, resize_area,
                                             resize_bilinear)
from ripcurrents_tpu_torch.ops.polar import flow_to_polar


@dataclasses.dataclass(frozen=True)
class ModeConfig:
    """Static configuration threaded into every mode factory: the fields
    of the ported modes, with the reference's values as defaults."""
    xdim: int = XDIM
    ydim: int = YDIM
    total_frames: int = 0        # CAP_PROP_FRAME_COUNT; 0 = filled by runner
    seed: int = 0                # seed of the random seed points
    thresholds: Thresholds = Thresholds()
    hist: HistogramParams = HistogramParams()
    lk: LKParams = LKParams.particles()
    timeline_start: Tuple[float, float] = (10.0, 150.0)
    timeline_end: Tuple[float, float] = (XDIM - 10.0, 400.0)
    timeline_vertices: int = 200
    max_streaklines: int = 5
    streakline_capacity: int = 256
    population_rect: Tuple[float, float, float, float] = (250, 150, 300, 200)
    population_vertices: int = 50
    population_faithful_bias: bool = True
    window_size: int = 10        # subtructAverageVectorWithWindow
    average_buffer: int = 300    # averageHSV/averageVector ring (BUFFER_FRAME)
    shear_window: int = 100
    timex_window: int = 500
    bright_window: int = 50
    bright_option: int = 0
    n_streamline_seeds: int = 20
    legacy_seeds: int = 250
    phase_roi: Tuple[int, int, int, int] = (XDIM - 50, 50, 50, 50)
    # Optional Farneback warp overrides applied on top of each mode's
    # call-site preset (None = keep the preset's choice).
    warp_impl: "str | None" = None
    warp_residual: "int | None" = None
    warp_subcol: "int | None" = None
    # stabilizeTPU's feature engine: 'harris' (corners + patch
    # descriptors) or 'akaze' (nonlinear-scale-space det-Hessian keypoints
    # + rotated binary descriptors, flow/akaze_tpu.py; the reference's
    # detector family, main.cpp:1598).
    stab_features: str = "harris"


def fb_preset(preset: FarnebackParams, cfg: ModeConfig) -> FarnebackParams:
    """Apply the ModeConfig warp overrides to a call-site preset."""
    kw = {}
    if cfg.warp_impl is not None:
        kw["warp_impl"] = cfg.warp_impl
    if cfg.warp_residual is not None:
        kw["warp_residual"] = cfg.warp_residual
        # An explicit residual must take effect: the engine prefers
        # warp_residual_hires on >= 1 MP frames, which would swallow it.
        kw["warp_residual_hires"] = None
    if cfg.warp_subcol is not None:
        kw["warp_subcol"] = cfg.warp_subcol
    return dataclasses.replace(preset, **kw) if kw else preset


def to_device(raw, device: torch.device) -> torch.Tensor:
    """A raw frame (numpy array or tensor) as a tensor on `device`."""
    return torch.as_tensor(raw).to(device)


def prep_frame(raw_bgr_u8: torch.Tensor, cfg: ModeConfig,
               first: bool = False, rows: "tuple[int, int] | None" = None,
               src: "tuple[int, int] | None" = None):
    """Resize to the working resolution + grayscale (main.cpp:142-144);
    first frames use INTER_AREA (main.cpp:125). -> (resized BGR, gray).

    Gray-input modes (GRAY_INPUT) may be fed 2-D gray frames; the colour
    canvas is then None (those modes never read it).

    A row band (a mode step split over a 'space' group): rows=(i0, i1)
    returns only those rows of the working frame, resizing only the
    source rows they read; raw then holds source rows [a0, a0 + its
    height) of a src_h-row frame, src=(a0, src_h) (default: the whole
    frame). A first frame is resized whole and cut, so its band equals
    the whole frame's rows bit for bit whatever the weights."""
    target = (cfg.ydim, cfg.xdim)
    if rows is not None and first:
        resized, gray = prep_frame(raw_bgr_u8, cfg, first=True)
        cut = slice(*rows)
        return (None if resized is None else resized[cut]), gray[cut]
    resize = resize_area if first else resize_bilinear
    band = {} if rows is None else {"rows": tuple(rows), "src": src}
    if raw_bgr_u8.dim() == 2:
        a0, src_h = src or (0, raw_bgr_u8.shape[0])
        if (src_h, raw_bgr_u8.shape[1]) == target:
            return None, (raw_bgr_u8 if rows is None else
                          raw_bgr_u8[rows[0] - a0:rows[1] - a0])
        return None, resize(raw_bgr_u8, target, **band)
    resized = resize(raw_bgr_u8, target, **band)
    return resized, bgr_to_gray(resized)


class FlowStream(NamedTuple):
    """Carried Farneback stream state: the previous frame's per-level
    expansion tables, so each frame is expanded once per stream."""
    exp: tuple


def flow_stream_init(gray: torch.Tensor, fb: FarnebackParams) -> FlowStream:
    return FlowStream(farneback_precompute(gray, fb))


def flow_stream_step(fs: FlowStream, gray: torch.Tensor,
                     fb: FarnebackParams):
    """-> (flow (H, W, 2) to the new frame, updated FlowStream)."""
    flow, exp = farneback_stream(fs.exp, gray, fb)
    return flow, FlowStream(exp)


def detector_mask_scan(grays, fb: FarnebackParams, hp=None,
                       upper_init: float = 100.0, warmup: int = 30,
                       device="cuda") -> torch.Tensor:
    """The detector core: the duty-cycle rip-mask path of the legacy
    pipeline (flow -> polar -> cumulative histogram -> top-5% UPPER ->
    classify -> accumulate -> 10%-duty mask; ripcurrents.cpp:300-439)
    without its visualizations. grays: (T, H, W) grayscale frames (numpy
    or tensor), uploaded one at a time. Returns the last frame's (H, W)
    uint8 mask (255 = candidate rip zone) on `device`. A host loop over
    the frames."""
    dev = resolve_device(device)
    hp = hp or HistogramParams()
    thr = Thresholds(upper_init=upper_init)
    h, w = grays.shape[1:]
    fs = flow_stream_init(to_device(grays[0], dev), fb)
    hist = histops.empty_histogram(hp, dev)
    accumulator = torch.zeros((h, w), dtype=torch.float32, device=dev)
    fc = torch.zeros((), dtype=torch.int32, device=dev)
    mask = None
    for t in range(1, grays.shape[0]):
        fc = fc + 1
        flow, fs = flow_stream_step(fs, to_device(grays[t], dev), fb)
        mag, ang = flow_to_polar(flow)
        hist = histops.accumulate(hist, histops.bin_flow(mag, ang, hp))
        th = histops.thresholds(hist, hp)
        res = cls.classify(ang, mag, th.upper, thr.mid, thr.lower,
                           th.upper2d, hp)
        accumulator = cls.accumulate_waves(accumulator, res.fast_mask, fc,
                                           warmup=warmup)
        mask = cls.duty_cycle_viz(accumulator, fc).outmask
    return mask


# registry: name -> factory(cfg, device="cuda") -> (init_fn, step_fn)
# init_fn(first_raw_frame) -> state
# step_fn(state, raw_frame) -> (state, out_frame_u8)
MODES: Dict[str, Callable] = {}

# Modes whose step reads only the grayscale frame (their output is a pure
# flow visualization, never the color canvas): they may be fed 2-D gray
# frames.
GRAY_INPUT: set = set()

# Modes with a space form: factory(cfg, device, mesh=mesh) with
# mesh.space > 1 splits the step's rows over the mesh's 'space' group;
# init takes the whole first frame, step(state, raw, src=None) a frame
# or its source rows (``prep_frame``'s `src`) and returns the band's
# output rows.
SPACE_MODES: set = set()


def register(name: str, gray_input: bool = False, space: bool = False):
    def deco(fn):
        MODES[name] = fn
        if gray_input:
            GRAY_INPUT.add(name)
        if space:
            SPACE_MODES.add(name)
        return fn
    return deco


def space_rows(cfg: ModeConfig, mesh) -> "tuple[int, int] | None":
    """This rank's rows [i0, i1) of the working frame when `mesh` splits
    rows over a 'space' group of more than one rank, else None."""
    if mesh is None or mesh.space == 1:
        return None
    if cfg.ydim % mesh.space:
        raise ValueError(f"--mesh-space {mesh.space} does not divide the "
                         f"frame height {cfg.ydim}")
    band = cfg.ydim // mesh.space
    i0 = mesh.coords["space"] * band
    return i0, i0 + band
