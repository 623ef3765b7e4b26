"""Speed classification and temporal wave accumulation (port of
``ripcurrents_tpu/analysis/classify.py``): create_flow,
create_accumulationbuffer and create_output
(ripcurrents_module.cpp:153-244) and their android variants
(jni/ripcurrents.cpp:223-246, :264-284, :289-320)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ripcurrents_tpu_torch.config import HistogramParams


class ClassifyResult(NamedTuple):
    display_hsv: torch.Tensor  # (H, W, 3) float32 HSV (deg, [0,1], [0,1])
    waterclass: torch.Tensor   # (H, W, 3) float32 classifier colors
    fast_mask: torch.Tensor    # (H, W) float32 1.0 where val > UPPER


def classify(ang: torch.Tensor, mag: torch.Tensor, upper, mid, lower,
             upper2d: torch.Tensor,
             p: HistogramParams = HistogramParams()) -> ClassifyResult:
    """Per-pixel fast/slow classification; the HSV display has H = angle,
    V = mag / UPPER2d[direction], S = 1 where saturated else 0.7."""
    d = torch.clamp((ang * p.directions / 360.0).to(torch.int32),
                    0, p.directions - 1)
    val = mag
    fast = val > upper
    wx = torch.where(fast, 0.5, 0.0)
    wz = torch.where(~fast & (val > mid), 1.0,
                     torch.where(~fast & (val > lower), 0.5, 0.0))
    wy = torch.where(~fast & (val <= lower), 0.5, 0.0)
    waterclass = torch.stack([wx, wy, wz], dim=-1)
    v = val / upper2d[d.long()]
    s = torch.where(v > 1.0, 1.0, 0.7)
    display = torch.stack([ang, s, v], dim=-1)
    return ClassifyResult(display, waterclass, fast.to(torch.float32))


class AccumulatorViz(NamedTuple):
    out: torch.Tensor      # (H, W, 3) float32 wave-duty visualization
    outmask: torch.Tensor  # (H, W) uint8 255 where duty < 10%


def accumulate_waves(accumulator: torch.Tensor, fast_mask: torch.Tensor,
                     framecount, warmup: int = 30) -> torch.Tensor:
    """accumulator += fast_mask once past the warmup frame
    (ripcurrents.cpp:414-416)."""
    return torch.where(framecount > warmup, accumulator + fast_mask,
                       accumulator)


def duty_cycle_viz(accumulator: torch.Tensor, framecount) -> AccumulatorViz:
    """Accumulated wave duty and the low-duty mask
    (ripcurrents_module.cpp:196-211)."""
    val = accumulator.to(torch.int32).to(torch.float32)
    fc = torch.as_tensor(framecount, device=accumulator.device).to(
        torch.float32)
    hi = val > 0.1 * fc
    mid = hi & (val < 0.2 * fc)
    out = torch.stack([torch.where(hi & ~mid, 1.0, 0.0),
                       torch.where(~hi, 0.5, 0.0),
                       torch.where(mid, 1.0, 0.0)], dim=-1)
    outmask = torch.where(~hi, 255, 0).to(torch.uint8)
    return AccumulatorViz(out, outmask)


def burn_mask_red(subframe_bgr_u8: torch.Tensor,
                  mask_u8: torch.Tensor) -> torch.Tensor:
    """create_output (ripcurrents_module.cpp:225-244): red channel to 255
    wherever the mask is nonzero."""
    out = subframe_bgr_u8.clone()
    out[..., 2] = torch.where(mask_u8 > 0, 255,
                              subframe_bgr_u8[..., 2].to(torch.int32)).to(
        torch.uint8)
    return out


# --- android variants (jni/ripcurrents.cpp) --------------------------------

def classify_android(ang: torch.Tensor, mag: torch.Tensor, upper, mid,
                     lower):
    """jni/ripcurrents.cpp:223-246: classify, and rescale the magnitude
    into [0, 1] -> (rescaled, waterclass (H, W, 3), fast mask)."""
    fast = mag > upper
    rescaled = torch.where(fast, mag,
                           torch.where(mag > lower,
                                       (mag - lower) / (upper - lower), 0.0))
    wx = torch.where(fast, 0.5, 0.0)
    wz = torch.where(~fast & (mag > mid), 1.0,
                     torch.where(~fast & (mag > lower), 0.5, 0.0))
    wy = torch.where(~fast & (mag <= lower), 0.5, 0.0)
    return rescaled, torch.stack([wx, wy, wz], dim=-1), fast.to(torch.float32)


def android_duty_viz(accumulator: torch.Tensor, i) -> torch.Tensor:
    """jni/ripcurrents.cpp:271-284: the duty fraction in three bands,
    (H, W, 3): hi (x), low below 5% (y), mid 5-20% (z)."""
    fi = torch.as_tensor(i, device=accumulator.device).to(torch.float32)
    val = accumulator.to(torch.int32).to(torch.float32)
    frac = val / fi
    hi = val > 0.05 * fi
    mid = hi & (val < 0.2 * fi)
    return torch.stack([torch.where(hi & ~mid, frac, 0.0),
                        torch.where(~hi, frac, 0.0),
                        torch.where(mid, frac, 0.0)], dim=-1)


def _box_sums(c: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
              win: int) -> torch.Tensor:
    """Sums over the win x win blocks anchored at (ys, xs), from the 2-D
    prefix sum c (one leading row and column of zeros)."""
    y, x = ys[:, None], xs[None, :]
    return c[y + win, x + win] - c[y + win, x] - c[y, x + win] + c[y, x]


def android_local_rip(out: torch.Tensor, localwin: int = 20,
                      band: "tuple[int, int] | None" = None) -> torch.Tensor:
    """The sliding-window co-occurrence detector
    (jni/ripcurrents.cpp:289-309): a window (stride localwin, size
    2*localwin) where both the mid-duty (z) and the low-duty (y)
    populations exceed localwin^2/1.5 pixels votes for its pixels; the
    low-duty pixels with 4 votes form the rip overlay. -> (H, W) uint8
    mask (255 = rip).

    band=(row0, frame_h): out is rows [row0, row0 + its height) of a
    frame_h-row frame, and the windows anchored on the frame's grid that
    lie inside those rows vote; a row's mask is the whole frame's where
    every window covering it lies inside (``pipelines/modes.py:
    android_rows`` gives the rows a band needs).

    The counts are int32 prefix-sum differences, so they are exact and
    `votes == 4` is an integer test."""
    h, w = out.shape[0], out.shape[1]
    row0, frame_h = band or (0, h)
    dev = out.device
    hi = (out[..., 2] != 0).to(torch.int32)
    lo = (out[..., 1] != 0).to(torch.int32)
    win = 2 * localwin
    thresh = localwin * localwin / 1.5
    # the reference loops y < H - 2*localwin (exclusive); the anchors
    # whose windows lie in out's rows, in out's coordinates
    lo_y = -(-row0 // localwin) * localwin - row0
    hi_y = min(max(frame_h - win, 0), row0 + h - win + 1) - row0
    ys = torch.arange(lo_y, max(hi_y, lo_y), localwin, device=dev)
    xs = torch.arange(0, max(w - win, 0), localwin, device=dev)

    def prefix(a, pad):
        return torch.cumsum(torch.cumsum(
            torch.nn.functional.pad(a, (pad, 0, pad, 0)), dim=0,
            dtype=torch.int32), dim=1, dtype=torch.int32)

    winning = (_box_sums(prefix(hi, 1), ys, xs, win) > thresh) & \
        (_box_sums(prefix(lo, 1), ys, xs, win) > thresh)
    anchors = torch.zeros((h, w), dtype=torch.int32, device=dev)
    anchors[ys[:, None], xs[None, :]] = winning.to(torch.int32)
    # votes(y, x): winning anchors in [y-win+1, y] x [x-win+1, x]
    c = prefix(anchors, win)
    votes = c[win:, win:] - c[:-win, win:] - c[win:, :-win] + \
        c[:-win, :-win]
    return torch.where((votes == 4) & (lo > 0), 255, 0).to(torch.uint8)
