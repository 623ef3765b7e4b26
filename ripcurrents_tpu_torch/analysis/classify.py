"""Speed classification and temporal wave accumulation (port of the
legacy-path functions of ``ripcurrents_tpu/analysis/classify.py``:
create_flow, create_accumulationbuffer and create_output,
ripcurrents_module.cpp:153-244)."""

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
