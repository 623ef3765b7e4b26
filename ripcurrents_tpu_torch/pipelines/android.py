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

The space form (mesh.space K > 1): each rank is fed the whole frame
(``common.AREA_INPUT``), resizes it with INTER_AREA as one process does
and computes the whole frame's flow, its STABILIZE mean and the
cumulative histogram of its magnitude, so the threshold is one
process's with no exchange (the STABILIZE buffers stay whole: the
histogram reads the whole mean flow). The accumulator, the duty and the
local windows are kept over the band's rows and the rows of every
window that covers them (``modes.android_rows``); the red overlay is the
band's. Frames and states equal one process's bit for bit.
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
from ripcurrents_tpu_torch.ops.polar import flow_to_polar
from ripcurrents_tpu_torch.pipelines.common import (FlowStream, ModeConfig,
                                                    fb_preset,
                                                    flow_stream_init,
                                                    flow_stream_step,
                                                    prep_frame, register,
                                                    space_rows, to_device)
from ripcurrents_tpu_torch.pipelines.modes import android_rows

STABILIZE = 2  # jni/ripcurrents.cpp:10


class AndroidState(NamedTuple):
    """hist and histsum are cumulative: the jni declares them outside its
    loop and never resets them (jni:126-127)."""
    fstream: FlowStream
    stable: torch.Tensor       # (STABILIZE, H, W, 2) flow accumulation
    accumulator: torch.Tensor  # (H, W) fast-pixel counts (a space rank:
    #                            its ``android_rows``)
    hist: torch.Tensor         # (bins,) int32
    histsum: torch.Tensor      # () int32
    i: torch.Tensor            # () int32 frames stepped


def make_android(cfg: ModeConfig, device="cuda", mesh=None):
    """-> (init(first_raw) -> AndroidState, step(state, raw, src=None) ->
    (AndroidState, overlay BGR uint8)). device="cuda" (the default)
    raises without a card; device="cpu" runs the plain versions. `mesh`
    with a 'space' axis of K > 1: the space form (module doc)."""
    dev = resolve_device(device)
    fb = fb_preset(FarnebackParams.android(), cfg)
    hist_p = HistogramParams.android()
    thr = Thresholds(upper_init=100.0)
    rows = space_rows(cfg, mesh)
    k0, k1 = android_rows(rows, cfg.ydim) if rows else (0, cfg.ydim)
    b0, b1 = rows or (0, cfg.ydim)

    def init(first_raw) -> AndroidState:
        _, gray = prep_frame(to_device(first_raw, dev), cfg, first=True)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return AndroidState(
            flow_stream_init(gray, fb),
            torch.zeros((STABILIZE, cfg.ydim, cfg.xdim, 2),
                        dtype=torch.float32, device=dev),
            torch.zeros((k1 - k0, cfg.xdim), dtype=torch.float32,
                        device=dev),
            torch.zeros(hist_p.bins, dtype=torch.int32, device=dev),
            zero, zero)

    def step(state: AndroidState, raw, src=None):
        # jni:141,163: INTER_AREA and gray, of the whole frame (AREA_INPUT)
        resized, gray = prep_frame(to_device(raw, dev), cfg, first=True)
        resized = resized[b0:b1]
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

        _, _, fast = cls.classify_android(ang[k0:k1], mag[k0:k1], upper,
                                          thr.mid, thr.lower)
        accumulator = state.accumulator + fast
        out = cls.android_duty_viz(accumulator, i)
        rip_mask = cls.android_local_rip(out, localwin=20,
                                         band=(k0, cfg.ydim))[b0 - k0:
                                                              b1 - k0]

        # the red overlay after the warmup (jni:313-320)
        warm = i > ANDROID_OVERLAY_WARMUP
        overlay = resized.clone()
        overlay[..., 2] = torch.where(warm & (rip_mask > 0), 255,
                                      resized[..., 2].to(torch.int32)).to(
            torch.uint8)
        return AndroidState(fs, stable, accumulator, hist, histsum,
                            i), overlay

    return init, step


@register("android", area_input=True)
def android_mode(cfg: ModeConfig, device="cuda", mesh=None):
    return make_android(cfg, device=device, mesh=mesh)
