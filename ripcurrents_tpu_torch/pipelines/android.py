"""The Android/mobile rip-detection pipeline, one step per frame (port of
``ripcurrents_tpu/pipelines/android.py``).

rip_main (RipCurrents_android/app/src/main/jni/ripcurrents.cpp:81-347):
Farneback (0.5, 3, 5, 3, 15, 1.2, box), 2-frame flow averaging
(STABILIZE=2), cartToPolar, a cumulative 100-bin top-3% threshold,
classify and rescale, temporal accumulation, the duty visualization and
the 40x40 local-window hi/low duty coincidence detector, which marks rip
pixels red after a 90-frame warmup.

The reference processes 1 of every 3 frames: that is a decode policy of
the runner; this step consumes the frames it is handed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ripcurrents_tpu_torch import resolve_device
from ripcurrents_tpu_torch.analysis import classify as cls
from ripcurrents_tpu_torch.config import (ANDROID_OVERLAY_WARMUP,
                                          FarnebackParams, HistogramParams,
                                          Thresholds)
from ripcurrents_tpu_torch.ops import hist as histops
from ripcurrents_tpu_torch.ops.image import bgr_to_gray, resize_area
from ripcurrents_tpu_torch.ops.polar import flow_to_polar
from ripcurrents_tpu_torch.pipelines.common import (FlowStream, ModeConfig,
                                                    fb_preset,
                                                    flow_stream_init,
                                                    flow_stream_step,
                                                    register, to_device)

STABILIZE = 2  # jni/ripcurrents.cpp:10


class AndroidState(NamedTuple):
    """hist and histsum are cumulative: the jni declares them outside its
    loop and never resets them (jni:126-127)."""
    fstream: FlowStream
    stable: torch.Tensor       # (STABILIZE, H, W, 2) flow accumulation
    accumulator: torch.Tensor  # (H, W) fast-pixel counts
    hist: torch.Tensor         # (bins,) int32
    histsum: torch.Tensor      # () int32
    i: torch.Tensor            # () int32 frames stepped


def make_android(cfg: ModeConfig, device="cuda"):
    """-> (init(first_raw) -> AndroidState, step(state, raw) ->
    (AndroidState, overlay BGR uint8)). device="cuda" (the default)
    raises without a card; device="cpu" runs the plain versions."""
    dev = resolve_device(device)
    fb = fb_preset(FarnebackParams.android(), cfg)
    hist_p = HistogramParams.android()
    thr = Thresholds(upper_init=100.0)

    def prep(raw):
        resized = resize_area(to_device(raw, dev), (cfg.ydim, cfg.xdim))
        return resized, bgr_to_gray(resized)           # jni:141,163

    def init(first_raw) -> AndroidState:
        _, gray = prep(first_raw)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return AndroidState(
            flow_stream_init(gray, fb),
            torch.zeros((STABILIZE, cfg.ydim, cfg.xdim, 2),
                        dtype=torch.float32, device=dev),
            torch.zeros((cfg.ydim, cfg.xdim), dtype=torch.float32,
                        device=dev),
            torch.zeros(hist_p.bins, dtype=torch.int32, device=dev),
            zero, zero)

    def step(state: AndroidState, raw):
        resized, gray = prep(raw)
        i = state.i + 1
        flow_raw, fs = flow_stream_step(state.fstream, gray, fb)

        # STABILIZE-frame averaging (jni:178-182): every buffer accumulates
        # each frame's flow; the one indexed i % STABILIZE is consumed (the
        # mean of the last STABILIZE flows) and reset. The sum is a new
        # tensor, so the held state's buffers are not written.
        stable = state.stable + flow_raw[None]
        slot = (i % STABILIZE).reshape(1).long()
        current = stable.index_select(0, slot)[0] * (1.0 / STABILIZE)
        stable = stable.index_fill(0, slot, 0.0)

        mag, ang = flow_to_polar(current)
        # the cumulative histogram's top-3% threshold sharpens over the
        # whole clip (jni:195-213)
        dh, ds = histops.bin_1d(mag, hist_p)
        hist = state.hist + dh
        histsum = state.histsum + ds
        # Overflow guard: the jni's cumulative int counters would wrap
        # after ~2^31/(640*480) ~ 7k frames; halving both past 2^30 keeps
        # the top-3% threshold (it depends only on the hist/histsum ratio)
        # and is a no-op on clips short enough for the reference.
        big = histsum > (1 << 30)
        hist = torch.where(big, hist // 2, hist)
        histsum = torch.where(big, histsum // 2, histsum)
        upper = histops.upper_from_1d(hist, histsum, hist_p)

        _, _, fast = cls.classify_android(ang, mag, upper, thr.mid,
                                          thr.lower)
        accumulator = state.accumulator + fast
        out = cls.android_duty_viz(accumulator, i)
        rip_mask = cls.android_local_rip(out, localwin=20)

        # the red overlay after the warmup (jni:313-320)
        warm = i > ANDROID_OVERLAY_WARMUP
        overlay = resized.clone()
        overlay[..., 2] = torch.where(warm & (rip_mask > 0), 255,
                                      resized[..., 2].to(torch.int32)).to(
            torch.uint8)
        return AndroidState(fs, stable, accumulator, hist, histsum,
                            i), overlay

    return init, step


@register("android")
def android_mode(cfg: ModeConfig, device="cuda"):
    return make_android(cfg, device=device)
