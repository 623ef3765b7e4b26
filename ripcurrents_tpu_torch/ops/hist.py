"""Flow-magnitude histograms and threshold derivation (port of
``ripcurrents_tpu/ops/hist.py``; create_histogram,
ripcurrents_module.cpp:89-144). Binning is a bincount; the "walk bins
from the top until 5% of the mass is covered" search is a reversed
cumulative sum and an argmax."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ripcurrents_tpu_torch.config import HistogramParams


class FlowHistogram(NamedTuple):
    hist: torch.Tensor        # (bins,) int32 — 1-D magnitude histogram
    histsum: torch.Tensor     # () int32
    hist2d: torch.Tensor      # (directions, bins) int32
    histsum2d: torch.Tensor   # (directions,) int32


class FlowThresholds(NamedTuple):
    upper: torch.Tensor             # () f32 — global top-5% threshold
    upper2d: torch.Tensor           # (directions,) f32 — per direction
    prop_above_upper: torch.Tensor  # (directions,) f32


def empty_histogram(p: HistogramParams,
                    device: torch.device) -> FlowHistogram:
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)  # noqa: E731
    return FlowHistogram(z(p.bins), z(), z(p.directions, p.bins),
                         z(p.directions))


def bin_flow(mag: torch.Tensor, ang: torch.Tensor,
             p: HistogramParams) -> FlowHistogram:
    """Bin polar flow (angle in degrees) into the 1-D and direction x
    magnitude histograms; only magnitude bins in [0, bins) count
    (ripcurrents_module.cpp:101)."""
    bins = (mag * p.resolution).to(torch.int32)     # truncates toward zero
    dirs = (ang * p.directions / 360.0).to(torch.int32)
    dirs = torch.clamp(dirs, 0, p.directions - 1)
    valid = (bins >= 0) & (bins < p.bins)
    flat = torch.where(valid, dirs * p.bins + torch.clamp(bins, 0, p.bins - 1),
                       p.directions * p.bins)       # overflow slot
    counts = torch.bincount(flat.reshape(-1).long(),
                            minlength=p.directions * p.bins + 1)
    hist2d = counts[:-1].reshape(p.directions, p.bins).to(torch.int32)
    hist = hist2d.sum(dim=0, dtype=torch.int32)
    return FlowHistogram(hist, hist.sum(dtype=torch.int32), hist2d,
                         hist2d.sum(dim=1, dtype=torch.int32))


def accumulate(a: FlowHistogram, b: FlowHistogram) -> FlowHistogram:
    """Histograms accumulate across frames in the legacy pipeline
    (ripcurrents.cpp:319-325 never resets them)."""
    return FlowHistogram(*(x + y for x, y in zip(a, b)))


def _top_frac_bin(hist: torch.Tensor, total: torch.Tensor,
                  frac: float) -> torch.Tensor:
    """Index `bin` after the reference loop
        while (threshsum < total*frac) { threshsum += hist[bin]; bin--; }
    over the last axis of hist (batched over leading axes)."""
    bins = hist.shape[-1]
    rc = torch.cumsum(torch.flip(hist, dims=(-1,)), dim=-1)
    target = total.to(torch.float32) * frac
    reached = rc.to(torch.float32) >= target[..., None]
    k = torch.where(reached.any(dim=-1),
                    torch.argmax(reached.to(torch.int32), dim=-1) + 1, bins)
    # An empty histogram runs the strict-< loop zero times.
    k = torch.where(target > 0, k, 0)
    return bins - 1 - k


def thresholds(h: FlowHistogram, p: HistogramParams) -> FlowThresholds:
    """UPPER, UPPER2d and prop_above_upper exactly as create_histogram
    derives them (ripcurrents_module.cpp:109-143)."""
    target_bin = _top_frac_bin(h.hist, h.histsum, p.top_frac)
    upper = target_bin.to(torch.float32) / p.resolution
    bin_ids = torch.arange(p.bins, device=h.hist.device)
    above_t = bin_ids > target_bin
    threshsum = torch.where(above_t, h.hist, 0).sum()
    per_dir_bin = _top_frac_bin(h.hist2d, h.histsum2d, p.top_frac)
    upper2d = torch.clamp(per_dir_bin.to(torch.float32) / p.resolution,
                          min=p.upper2d_floor)
    above = torch.where(above_t[None, :], h.hist2d, 0).sum(dim=1)
    prop = above.to(torch.float32) / torch.clamp(
        threshsum.to(torch.float32), min=1.0)
    return FlowThresholds(upper, upper2d, prop)
