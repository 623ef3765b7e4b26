"""Configuration dataclasses of the PyTorch port.

A copy of the presets the ported modes need, with the same field names
and values as the JAX package's ``config.py``, so that one preset name
means the same engine settings in both packages. The reference
hard-codes these as #defines and per-call-site literals
(RipCurrents_main/ripcurrents.hpp:4-13, ripcurrents.cpp:142-215).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Working resolution all reference modes resize to
# (reference: ripcurrents.hpp:4-5).
XDIM = 640
YDIM = 480


@dataclasses.dataclass(frozen=True)
class FarnebackParams:
    """Parameters of Farneback dense optical flow.

    Field semantics match cv2.calcOpticalFlowFarneback, plus the knobs of
    the warp (flow/farneback.py):

    - warp_impl 'fused': the fused level engine (flow/fused_update.py),
      which resamples the second frame's expansion at a per-(row tile x
      subcolumn) integer base displacement plus a per-pixel residual
      clamped to +-warp_residual;
    - the portable engine, whose warp is 'gather' (exact bilinear, any
      displacement; also whenever warp_budget is None), 'shift' (the
      shift decomposition, exact for |flow| <= warp_budget), 'pallas'
      (the same function as one hand-written kernel, K7) or 'tiled' (the
      fused engine's algebra on channels-last tables: a per-warp_tile
      integer base, the rounded mean of the tile's flow clamped to
      +-96 px, plus a per-pixel residual clamped to +-warp_residual;
      unbounded smooth motion, exact within warp_residual px of the tile
      mean; kernel K8).

    poly_impl 'banded' computes each level's expansion straight from the
    full-res frame through the composed banded matrices (kernels K5 and
    K6, bf16 operands as the TPU rounds them); 'shifted' pre-smooths,
    resizes and correlates as separate float32 passes of shifted slice
    sums (plain PyTorch), the reference's sequence of operations.
    """

    pyr_scale: float = 0.5
    levels: int = 2          # coarsest level index; sizes = round(dim*scale^k), k=levels..0
    winsize: int = 15
    iterations: int = 3
    poly_n: int = 15
    poly_sigma: float = 1.2
    gaussian: bool = True    # OPTFLOW_FARNEBACK_GAUSSIAN; False = box blur
    warp_budget: "int | None" = 16
    warp_impl: str = "fused"
    # Residual budget of the fused warp. An int applies to every pyramid
    # level; a tuple is indexed by level (finest first, last entry reused
    # for coarser levels).
    warp_residual: "int | Tuple[int, ...]" = 2
    # Frames with h*w >= warp_hires_px use these overrides instead
    # (None = never override).
    warp_residual_hires: "int | Tuple[int, ...] | None" = (1, 1, 1)
    warp_hires_px: int = 1_000_000
    # (th, tw) of the 'tiled' warp's base tiles; small levels shrink it
    # (farneback._adaptive_tile).
    warp_tile: Tuple[int, int] = (64, 256)
    # Subcolumn width of the warp base blocks (None = widest 128-multiple
    # <= 384 dividing the padded width).
    warp_subcol: "int | None" = None
    warp_subcol_hires: "int | None" = 640
    # Iteration schedule at >= warp_hires_px (tuple indexed by level,
    # finest first; None = `iterations` at every level).
    iters_hires: "int | Tuple[int, ...] | None" = None
    poly_impl: str = "banded"

    @staticmethod
    def streamlines() -> "FarnebackParams":
        # main.cpp:264 — (0.5, 2, 3, 2, 15, 1.2, GAUSSIAN)
        return FarnebackParams(0.5, 2, 3, 2, 15, 1.2, True,
                               warp_residual=4, warp_residual_hires=2,
                               warp_subcol=128, warp_subcol_hires=128)

    @staticmethod
    def subtract_average() -> "FarnebackParams":
        # main.cpp:609 — (0.5, 2, 20, 3, 15, 1.2, GAUSSIAN)
        return FarnebackParams(0.5, 2, 20, 3, 15, 1.2, True)

    @staticmethod
    def windowed() -> "FarnebackParams":
        # main.cpp:1119, :1481 — (0.5, 2, 10, 3, 15, 1.2, GAUSSIAN);
        # one iteration per level at >= 1 MP.
        return FarnebackParams(0.5, 2, 10, 3, 15, 1.2, True,
                               iters_hires=(1, 1, 1))

    @staticmethod
    def legacy() -> "FarnebackParams":
        # ripcurrents.cpp:215 — (0.5, 2, 3, 2, 15, 1.2, 0)
        return FarnebackParams(0.5, 2, 3, 2, 15, 1.2, False,
                               warp_residual=4, warp_residual_hires=2,
                               warp_subcol=128, warp_subcol_hires=128)

    @staticmethod
    def android() -> "FarnebackParams":
        # RipCurrents_android jni/ripcurrents.cpp:167,171 — (0.5, 3, 5, 3, 15, 1.2, 0)
        return FarnebackParams(0.5, 3, 5, 3, 15, 1.2, False,
                               warp_residual=4, warp_residual_hires=2,
                               warp_subcol=128, warp_subcol_hires=128)


@dataclasses.dataclass(frozen=True)
class LKParams:
    """Pyramidal Lucas-Kanade sparse flow parameters (cv2.calcOpticalFlowPyrLK)."""

    win: Tuple[int, int] = (50, 50)
    levels: int = 3          # maxLevel; pyramid has levels+1 images
    max_iters: int = 30
    eps: float = 0.1         # TermCriteria epsilon (un-squared, as passed to cv2)
    min_eig_threshold: float = 1e-4

    @staticmethod
    def particles() -> "LKParams":
        # Streakline.cpp:32, ripcurrents_module.cpp:775,1162 —
        # Size(50,50), 3 levels, 30 iters, eps 0.1, minEig 1e-4
        return LKParams((50, 50), 3, 30, 0.1, 1e-4)

    @staticmethod
    def dense_grid() -> "LKParams":
        # ripcurrents_module.cpp:716 — Size(21,21), 3, 30 iters, eps 0.01
        return LKParams((21, 21), 3, 30, 0.01, 1e-4)

    @staticmethod
    def red_points() -> "LKParams":
        # ripcurrents_module.cpp:738 — Size(21,21), 3, 30 iters, eps 0.1
        return LKParams((21, 21), 3, 30, 0.1, 1e-4)


@dataclasses.dataclass(frozen=True)
class HistogramParams:
    """Polar flow-magnitude histogram used to derive motion thresholds.

    Reference: ripcurrents.hpp:7-9 and create_histogram
    (ripcurrents_module.cpp:89-144).
    """

    bins: int = 50           # HIST_BINS
    directions: int = 36     # HIST_DIRECTIONS
    resolution: int = 20     # HIST_RESOLUTION (bins per unit magnitude)
    top_frac: float = 0.05   # top-5% defines UPPER
    upper2d_floor: float = 0.01

    @staticmethod
    def android() -> "HistogramParams":
        # jni/ripcurrents.cpp:11,195-213 — 100 bins, resolution 10, top 3%
        return HistogramParams(bins=100, directions=36, resolution=10,
                               top_frac=0.03)


@dataclasses.dataclass(frozen=True)
class Thresholds:
    """Speed classification thresholds (main.cpp:208-212, ripcurrents.cpp:142-149)."""

    lower: float = 0.2
    mid: float = 0.5
    upper_init: float = 45.0   # main.cpp modes; legacy pipeline uses 100.0


# Misc reference constants
BUFFER_FRAME = 300       # ripcurrents.hpp:11 — ring buffer length for averages
GRID_COUNT = 30          # ripcurrents.hpp:13 — arrows per row/col in averageVector
