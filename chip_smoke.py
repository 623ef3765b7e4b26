#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their
plain PyTorch versions.

Run from the repository root on a machine with one Hopper card and the
CUDA toolkit:

    python3 chip_smoke.py

Every phase passes or raises (the script catches nothing):

1. the card's name and power limit; build the eight kernels of ``csrc/``
   with nvcc for sm_90a and print the build time, the ptxas report, how
   many K1 and K8 clusters of each size the card holds at once and K8's
   plan (S, CTAs, threads) at the tiled engine's levels and at 1080p;
2. K1 (farneback_update), K2 (farneback_blur_solve) and the level loop
   against their plain versions on the card, at the main path's shapes:
   640x480 level 0 of the legacy preset (table (5, 544, 896) bf16, bres 4,
   128-wide subcolumns, box 3) and 1080p level 0 of the windowed preset
   (bres 1, 640-wide subcolumns, Gaussian 10); K1 at every level of the
   legacy, dense-mode and android 640x480 pyramids (android's down to
   60x80) and of the 1080p windowed and legacy ones,
   with its cluster size S, CTAs, device time (median of 50 launches) and
   bound per level and its device time per frame; K2 at every level (its
   tile per level; pads zeroed, and at level 0 also not) and K4
   (resize_cf_padded) against its plain version and the dense two-matmul
   form at every level change of the nine ``BLUR_CHECKS`` geometries,
   both bit for bit (``K2_TOL``, ``K4_TOL`` 0.0); K3 (lk_track) against
   its plain version at 640x480 with 201 points, 1280 points and 2
   streams x 201 points, border and
   out-of-image points included, and on one level with points that move
   past its J patch's margin; K5 (prep_y) and K6 (prep_x3) against
   their plain versions and the dense matmul form at every level of the
   640x480 legacy and 1080p windowed tables, of the 640x480
   channels-last tables of the portable engine, of the ragged 75x107 and
   the 40x300 legacy tables and of android's 4-level 640x480 tables
   (``PREP_CHECKS``); K7 (warp5_shift) against
   its plain version at 640x480 with flows inside and beyond +-16 px; K8
   (warp_tiles) against its plain version bit for bit in its halo layout
   at 1080p (bres 2 with 384-wide and bres 1 with 640-wide subcolumns, the
   bench_warp configurations, bases up to the halo clamp; and its no-base
   instance) and in its frame layout at every level of the tiled engine's
   640x480 pyramid, for C = 1 at 1080p (bres 2), C = 3 at 640x480 (bres
   6) and at a ragged 75x107 (``TILES_FRAME_CHECKS``), clamped residuals
   included, at each of dense_lk's four 640x480 levels (C = 1, bres 4)
   and at stabilizeTPU's 480x640 colour frame under a homography's
   displacement (C = 3, bres 6; ``check_tiles_new_paths``); one device
   kernel per K8 call in each layout;
3. the legacy rip detector (``make_legacy``, 250 seeds) on 40 synthetic
   1280x720 moving-texture frames at 640x480: finite outputs of the right
   shapes, a live duty mask, K1 and K2 each launched 6 times, K4 twice and
   K5 and K6 3 times per frame; then the whole step at 192x256 on the card
   against the same step on the CPU (plain versions);
4. the windowed Farneback stream at 1920x1080, and one torch.profiler
   trace of it: device time per frame, the share K5 and K6 take and K2's
   and K4's device time per frame;
5. each kernel's time per launch at the 640x480 shapes beside its plain
   version, its bound and a library call, as one JSON line (K8 in its
   frame layout, the tiled engine's level 0); K8 at every level of the
   tiled engine's 640x480 pyramid and per tiled frame, and in the halo
   layout with its no-base floor (``k8_levels``); K3 as the median and spread
   of 30 launches at 201 vertices and at 1280 points, with its longest
   per-point chain of iterations and a latency row beside its bound; K5
   and K6 at every level of the legacy 640x480 and windowed 1080p
   pyramids (median of 50 launches, bound, issue floor) and per frame;
   K2 at every level and K4 at every level change of the legacy and
   windowed 640x480 and windowed 1080p pyramids (``blur_upsample_frames``:
   median of 50 launches, bound, issue floor) and per frame; K7 and
   ``grid_sample`` alternated, K7 / grid_sample / grid_sample / K7 twice;
6. the particle modes through ``run_frames`` at 640x480 from 1280x720
   frames: ``timelines`` (201 vertices, 40 frames, K3 once per frame),
   ``streaklines`` (1280 vertices), ``populationMap`` and
   ``flowRedPoints``; then ``timelines`` at 192x256 on the card against
   the same steps on the CPU;
7. the dense Farneback modes through ``run_frames`` at 640x480 from
   1280x720 frames: ``subtructAverageVectorWithWindow`` for 40 frames, the
   other six for a few frames each (``averageVector`` with its 300-frame
   ring, and the device memory its state holds and peaks at), then
   ``subtructAverageVector`` on the portable engine
   (``warp_impl="pallas"``: K7 9 times per frame) and on its tiled warp
   (``warp_impl="tiled"``: K8 9 times per frame, 9 device kernels in a
   traced frame); then
   ``subtructAverageVectorWithWindow`` on the fused engine and on the
   tiled warp at 192x256 on the card against the same steps on the CPU,
   and ``subtructAverageVector``'s flow on both (its pixels are read:
   how many differ, by how many uint8 levels at most, and how many by
   more than one);
8. ``bench_warp`` (the fused engine's warp stage alone at 1080p) at both
   configurations of ``tools/bench_warp_variants.py`` (bres 2 with
   384-wide subcolumns, bres 1 with 640-wide ones): K8, its no-base floor,
   K1 and ``grid_sample``, with K8's bound and plain version;
9. ``android`` and the five simple modes (``averageHSV``, ``timex``,
   ``brightColor``, ``phaseCorrelate``, ``globalOrientation``) stepped at
   640x480 from 1280x720 frames, a few frames each (android from a state
   at i = 89 with a live accumulator, so it crosses the 90-frame overlay
   warmup): finite outputs of the right shape that move, a live android
   accumulator and red overlay, the timex mean moving; host-clock ms per
   frame, device kernels in one traced frame and K launches per frame
   (android K1 and K2 12, K4 3, K5 and K6 4; the others none);
   averageHSV's device memory (its 300-frame ring); then each mode at
   192x256 on the card against the same steps on the CPU (phaseCorrelate:
   its shift at every step, recomputed from the carried states, and the
   card's translation of the CPU's frames by the CPU's shifts, equal);
10. the 1080p detector golden: ``detector_mask_scan`` (legacy preset)
   over the 48-frame 1920x1080 rip clip (``synthetic.make_rip_clip``)
   against the cv2 oracle mask (``assets/detector_oracle_1080p_48f_v2
   .npz``): ``detector_1080p_iou`` (at least ``DETECTOR_IOU``), the
   mask share and the scan's K1/K2/K4/K5/K6 launches, which must equal
   what the preset implies (``stream_launches``);
11. ``stabilizeTPU`` through ``run_frames`` at 640x480 for both feature
   engines (Harris, AKAZE) on 8 frames of a jittered textured clip
   (``synthetic.make_jittered_clip``): host-clock ms per frame, device
   time, kernels and busy share of 2 traced frames, K launches per frame
   (K8 once, no other), and the residual jitter of the output against
   the raw clip's, measured with the port's ``phase_correlate`` on the
   interior (below ``STAB_RESIDUAL`` x raw); then each engine at 192x256
   on the card against the CPU with the CPU's RANSAC noise injected,
   step by step from the CPU's states and chained (``STAB_*`` limits);
12. the CLI's ``benchmark`` work on one 640x480 pair: ``farneback``
   (``BENCH_FB``) and ``dense_lk`` (``LKParams.dense_grid()``), each a
   warm and a timed call ended by a device sync, dense_lk's K8 launches
   (30 a level, 120) and one traced call; dense_lk at 192x256 on the card
   against the CPU (``DENSE_LK_*`` limits); ``farneback_stream_lagged``
   against ``farneback_stream`` on the card over 4 flows, equal;
13. the port's host rim through its CLI (``cli.main``) and ``run_video``
   on the card, on in-memory video: the card's machine has no OpenCV, so
   ``memory_video`` puts a reader of numpy frames and a writer that keeps
   them where the port looks up ``VideoReader`` and ``VideoWriter``. (a)
   the frame pump (``io/native.py``) builds from ``native/framepump.cpp``
   with g++ (its seconds, its host ms a frame on 2 threads); on 8
   1280x720 frames its 640x480 frames are within one level of the device
   ``resize_bilinear`` and equal to the device's float resize rounded half
   up, and its gray equals ``bgr_to_gray``; (b) ``--mode legacy`` over 40
   frames: with --no-host-prep its frames equal ``run_frames``' bit for
   bit; with the pump ``native_host_prep`` is true; K1/K2 6, K4 2, K5/K6 3
   launches a frame; ms/frame of ``run_frames`` and of the CLI without
   and with the pump, alternated; fps, stage seconds, device busy share
   and device-to-host bytes a frame (traced runs); (c) ``--mode
   timelines`` likewise, K3 once a frame; (d) ``subtructAverageVector``
   from 640x480 frames: the gray upload's frames equal the BGR upload's;
   (e) with --no-output, ``output_download`` is false and no
   device-to-host copy reaches one gray frame's bytes; (f) kill and
   resume (``--checkpoint-every``, ``--max-frames``, ``--resume``) equal
   to the whole run bit for bit, for legacy and stabilizeTPU (Harris);
   (g) ``--mode benchmark`` prints its two lines (K8 120 times a dense_lk
   call), ``--mode validate`` exits 0 with its radii within ``ORBIT_PX``
   of the CPU's, ``--mode legacy-full`` writes six streams of 8 frames;
14. the multi-device layer on the card, on in-memory video: (a)
   ``cli.main --videos`` with 1, 2 and 4 distinct legacy clips of 40
   1280x720 frames (--no-host-prep): every stream's frames equal
   ``run_frames``' of its clip bit for bit, the launches are N x one
   stream's, and aggregate and per-stream fps beside ``run_video``'s
   one-stream fps, alternated; 2 timelines streams (K3 once a stream and
   frame); clips of 40 and 25 frames stop at the shorter with no
   producer thread left and the metrics written; (b) ``farneback_spatial``
   on a 1920x1080 pair, halo 128, on 2 ranks sharing the card
   (torch.multiprocessing spawn, a file:// store, a gloo 'space' group,
   the kernels built here first): the tiled engine (K5, K6, K8) and the
   fused engine (K5, K6, K1, K2, K4, and K1b: the slabs' bases are the
   whole frame's) held to ``SPATIAL_BOUNDS`` against this process's
   ``farneback``, each rank's launches, ms a pair and the halo exchange's
   ms; (c) a stream farm of 2 processes (``cli.main --coordinator
   127.0.0.1:<port>``, gloo), 2 legacy clips each: the mesh (stream 2,
   space 1), each rank's slice, and ``all_streams_fps`` equal to the sum
   of the two processes' metrics fps;
15. the space form (``--mesh-space 2``): 2 processes share the card,
   each ``cli.main --videos <clip> --mesh-space 2`` with the farm's
   flags (a file:// store; the 'space' group is gloo), on an in-memory
   clip of 41 1280x720 frames at 640x480: legacy (timed, the counters set
   to 0 just before; then again recording each band flow, slab height,
   rip mask band and UPPER) and timelines, against this process's
   ``run_frames``: timelines bit for bit; legacy's overlays and masks
   equal on >= 99% of pixels, every frame's flow within
   ``SPATIAL_BOUNDS``, UPPER equal on both ranks every frame; launches per
   rank (K5/K6 3, K1/K1b/K2 6, K4 2 a legacy frame; K3 1 a timelines
   frame) and the slab height band + 2 x halo (368); ms a frame per rank,
   the exchanges' ms and bytes a frame, beside one process's run of the
   same clip.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels JSON, and the card's name and power limit come before
that. Without a card the script exits non-zero before printing a result.

``python3 chip_smoke.py --compare-parent DIR``, where DIR holds only an
older tree's ``ripcurrents_tpu_torch/`` (``git archive <commit>
ripcurrents_tpu_torch | tar -x -C DIR``), instead times K8
(``k8_levels``) in that tree and in this one, alternating parent / change
/ change / parent twice, each run a fresh process that builds its own
kernels.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import pathlib
import socket
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch
import torch.distributed
import torch.multiprocessing
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from ripcurrents_tpu_torch import bench_warp, cli, convert, kernels
from ripcurrents_tpu_torch.config import (ANDROID_OVERLAY_WARMUP,
                                          FarnebackParams, LKParams)
from ripcurrents_tpu_torch.dynamics.particles import timeline_init
from ripcurrents_tpu_torch.flow import farneback as fb
from ripcurrents_tpu_torch.flow import feature_stab
from ripcurrents_tpu_torch.flow import fused_update as fu
from ripcurrents_tpu_torch.flow import lucas_kanade as lk
from ripcurrents_tpu_torch.flow import prep_kernel, warp_kernel
from ripcurrents_tpu_torch.flow.lk_kernel import (PATCH_MARGIN, lk_track,
                                                  lk_track_plain)
from ripcurrents_tpu_torch.flow.dense_lk import dense_lk
from ripcurrents_tpu_torch.flow.phasecorr import (hanning_window,
                                                  phase_correlate)
from ripcurrents_tpu_torch.io import native as io_native
from ripcurrents_tpu_torch.io import video as io_video
from ripcurrents_tpu_torch.ops import image as img_ops
from ripcurrents_tpu_torch.ops.warp import translate
from ripcurrents_tpu_torch.parallel import distributed as pdist
from ripcurrents_tpu_torch.parallel import mesh as pmesh
from ripcurrents_tpu_torch.parallel import spatial
from ripcurrents_tpu_torch.pipelines import modes, runner
from ripcurrents_tpu_torch.pipelines.common import (MODES, ModeConfig,
                                                    detector_mask_scan,
                                                    prep_frame)
from ripcurrents_tpu_torch.pipelines.legacy import make_legacy
from ripcurrents_tpu_torch.synthetic import (make_jittered_clip,
                                             make_rip_clip, moving_frames)
from ripcurrents_tpu_torch.trace_legacy import (launch_counts,
                                                reset_launches)
from ripcurrents_tpu_torch.analysis import classify
from ripcurrents_tpu_torch.ops import hist as histops
from ripcurrents_tpu_torch.pipelines import legacy as legacy_mod


def reset_all_launches() -> None:
    """Set every launch counter to 0: the eight kernels' and K1b's
    (``fused_update.farneback_block_sums``, the slabs' base sums)."""
    reset_launches()
    fu.farneback_block_sums.launches = 0


def all_launch_counts() -> dict:
    """{"K1": n, ..., "K8": n, "K1b": n} since ``reset_all_launches``."""
    return {**launch_counts(), "K1b": fu.farneback_block_sums.launches}
from ripcurrents_tpu_torch.utils.checkpoint import load_meta

# H100 SXM published peaks: HBM bytes/s and
# float32 (non-tensor-core) flop/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# Kernel vs plain version, on the same inputs on the card. Both are built
# to round each product and sum alike (nvcc -fmad=false; the plain
# version's tensor ops are separate roundings), so they are expected to
# agree bit for bit; the bounds leave room for one bf16 rounding flip.
K1_REL = 2.0 ** -7          # M: one bf16 ULP of the plain value
K1_FRAC = 1e-4              # ... on at most this share of elements
K2_TOL = 0.0                # flow: |d| <= K2_TOL * (1 + |plain|)
LEVEL_TOL = 2e-3            # level flow: rtol = atol (the JAX package's
                            # level-vs-chain bound)

# K4 and its plain version round alike (each two-tap sum one FMA in
# ascending source index) and are required to agree bit for bit. The dense
# two-matmul form sums the same two nonzero terms among zeros, but how
# cuBLAS splits the source axis over accumulators decides whether its sum
# rounds once (an FMA chain) or twice, and that changes with the shape: it
# is held to K4 within a few float32 ULPs, |d| <= K4_DENSE_REL * (1 + |x|).
K4_TOL = 0.0
K4_DENSE_REL = 4 * 2.0 ** -23
# K3 sums its 2500-term windows in another order than its plain version,
# and a sum on the edge of a stopping rule can send a point another way:
# points within LK_PX for >= LK_SHARE of the points both track, median
# under LK_MEDIAN px, err within LK_ERR_RTOL, status equal on >= LK_SHARE.
LK_PX = 1e-3
LK_MEDIAN = 1e-4
LK_SHARE = 0.99
LK_ERR_RTOL = 1e-4         # plus 1e-7 absolute
# K5, K6 and K7 round each product and sum alike with their plain
# versions (nvcc -fmad=false; one float32 accumulator per output in the
# plain version's order) and must agree bit for bit. The dense matmul form
# of the prep sums the same products among zeros in cuBLAS's order: its
# one-ULP bf16 flips are reported, not bounded.
PREP_TOL = 0.0
WARP_TOL = 0.0
# K8 and its no-base instance round each product and sum alike with their
# plain versions and reduce each base in float64: bit for bit.
TILES_TOL = 0.0
# K7 against the exact bilinear gather on the pixels the mask keeps:
# |d| <= WARP_GATHER_REL * the channel's largest |r1| (the shift sum and
# the gather round their products and sums differently; the CPU tests hold
# K7's plain version to the gather within the same bound).
WARP_GATHER_REL = 5e-5
# A particle mode on the card vs on the CPU over 3 frames: the frame
# resize's matmul rounding can move a uint8 pixel by one level, which the
# tracker turns into a small shift of a vertex.
MODE_VERTEX_PX = 0.05
MODE_PIXEL_SHARE = 0.999
# A dense mode on the card vs on the CPU over 3 frames: the flow's ring
# mean differs by float32 rounding of K1/K2 against their plain versions
# and of the frame resize's matmul; a colour mode truncates the flow's
# angle and magnitude to uint8, so such a difference can move a pixel's
# colour by a level. Limits ~30x the readings on an H100 (median 3.0e-8
# px, p99 3.4e-7 px, 99.1% of pixels equal).
DENSE_MEDIAN_PX = 1e-6
DENSE_P99_PX = 1e-5
DENSE_PIXEL_SHARE = 0.98

RAW_H, RAW_W = 720, 1280
FRAMES = 40
ASSETS = pathlib.Path(kernels.__file__).resolve().parent / "assets"
# The pyramids whose every level K1 is checked and timed at: the legacy
# detector's, the dense modes' (windowed() and subtract_average() share
# these K1 geometries at 640x480), the 1080p windowed stream's,
# android's 4 levels (down to 60x80) and the 1080p legacy detector's
# (detector_mask_scan in phase [10]; bres 2).
K1_PYRAMIDS = {
    "legacy 640x480": ((480, 640), FarnebackParams.legacy()),
    "dense 640x480": ((480, 640), FarnebackParams.windowed()),
    "windowed 1080p": ((1080, 1920), FarnebackParams.windowed()),
    "android 640x480": ((480, 640), FarnebackParams.android()),
    "legacy 1080p": ((1080, 1920), FarnebackParams.legacy()),
}
# The pyramids whose every level K5 and K6 are timed at: the legacy
# detector's and the 1080p windowed stream's.
PREP_PYRAMIDS = {
    "legacy 640x480": ((480, 640), FarnebackParams.legacy()),
    "windowed 1080p": ((1080, 1920), FarnebackParams.windowed()),
}
# The geometries K5 and K6 are held to their plain versions at, every
# level: the main paths' tables, the portable engine's channels-last
# float32 table, a ragged width, the 40x300 pyramid (one-tile coarse
# levels), android's 4-level pyramid (a 260-tap L3 window) and the 1080p
# legacy detector's tables (phase [10]).
PREP_CHECKS = {
    "640x480 legacy (5, Ph, Pw) bf16": ((480, 640), FarnebackParams.legacy()),
    "1080p windowed (5, Ph, Pw) bf16": ((1080, 1920),
                                        FarnebackParams.windowed()),
    "640x480 subtract_average (lh, lw, 5) f32": (
        (480, 640), dataclasses.replace(FarnebackParams.subtract_average(),
                                        warp_impl="pallas")),
    "75x107 legacy (ragged)": ((75, 107), FarnebackParams.legacy()),
    "40x300 legacy": ((40, 300), FarnebackParams.legacy()),
    "640x480 android (4 levels)": ((480, 640), FarnebackParams.android()),
    "1080p legacy (5, Ph, Pw) bf16": ((1080, 1920),
                                      FarnebackParams.legacy()),
}
# The geometries K2 and K4 are held to their plain versions at, every level
# (K2) and every level change (K4): the main paths' pyramids (legacy box 3,
# the dense modes' windowed Gaussian 10 and subtract_average's Gaussian
# 20, the 1080p stream and the 1080p legacy detector of phase [10]),
# android's 4 levels (box 5), a ragged width, the
# 40x300 pyramid, and subtract_average at 40x300, whose 10- and 20-row
# levels are shorter than its 21-row window.
BLUR_CHECKS = {
    "legacy 640x480": ((480, 640), FarnebackParams.legacy()),
    "windowed 640x480": ((480, 640), FarnebackParams.windowed()),
    "subtract_average 640x480": ((480, 640),
                                 FarnebackParams.subtract_average()),
    "windowed 1080p": ((1080, 1920), FarnebackParams.windowed()),
    "android 640x480": ((480, 640), FarnebackParams.android()),
    "legacy 1080p": ((1080, 1920), FarnebackParams.legacy()),
    "legacy 75x107": ((75, 107), FarnebackParams.legacy()),
    "legacy 40x300": ((40, 300), FarnebackParams.legacy()),
    "subtract_average 40x300": ((40, 300),
                                FarnebackParams.subtract_average()),
}
# The pyramids whose every level K2 and every level change K4 are timed at.
BLUR_PYRAMIDS = {
    "legacy 640x480": ((480, 640), FarnebackParams.legacy()),
    "windowed 640x480": ((480, 640), FarnebackParams.windowed()),
    "windowed 1080p": ((1080, 1920), FarnebackParams.windowed()),
}
# K3's launches timed one by one for its median and spread.
LK_REPS = 30
# One dependent L2 round trip of an SM on an H100, for K3's latency row
# (~260 SM cycles at the 1.98 GHz boost clock, the figure Hopper
# microbenchmarks report). Assumed, not measured by this script.
L2_ROUND_TRIP_US = 0.13


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# The tiled engine's preset (subtructAverageVector with warp_impl="tiled")
# and K8's frame-layout checks beyond its pyramid: C = 1 at 1080p
# (dense_lk's table, bres 2), C = 3 at 640x480 (feature_stab's colour
# frame, bres 6) and a ragged 75x107 table, whose flow rows do not start
# 16-byte aligned (the sum's partial units): (h, w, C, tile, bres).
TILED_PRESET = dataclasses.replace(FarnebackParams.subtract_average(),
                                   warp_impl="tiled")
TILES_FRAME_CHECKS = {
    "1080p": (1080, 1920, 1, (64, 256), 2),
    "640x480": (480, 640, 3, (64, 256), 6),
    "75x107": (75, 107, 5, (64, 256), 2),
}


def level_inputs(h, w, p: FarnebackParams, device, k=0, seed=0,
                 flow_px=4.0):
    """Kernel inputs of pyramid level k of preset p at (h, w): both
    frames' real expansion tables at that level (the port's prep of two
    moving-texture frames) and a smooth random flow of up to +-flow_px
    with zero pads."""
    f = moving_frames(2, h, w, device, seed=seed, color=False)
    e0 = fb.farneback_precompute(f[0], p)[p.levels - k]
    e1 = fb.farneback_precompute(f[1], p)[p.levels - k]
    _, lh, lw, _, _ = fb._level_geometry(h, w, p, k)
    subcol = p.warp_subcol_hires if h * w >= p.warp_hires_px \
        else p.warp_subcol
    prep = fu.prepare_expansions(e0, e1, fu._row_tile(lh), hw=(lh, lw),
                                 subcol=subcol)
    hp, wp = prep["hpwp"]
    g = torch.Generator().manual_seed(seed + 1)
    coarse = (torch.rand((1, 2, lh // 16 + 2, lw // 16 + 2), generator=g)
              * 2 - 1) * flow_px
    fl = F.interpolate(coarse, size=(lh, lw), mode="bilinear",
                       align_corners=False)[0]
    flow = torch.zeros((2, hp, wp), dtype=torch.float32)
    flow[:, :lh, :lw] = fl
    return prep, flow.to(device)


def _bres(p: FarnebackParams, h, w):
    wr = p.warp_residual_hires if (h * w >= p.warp_hires_px and
                                   p.warp_residual_hires is not None) \
        else p.warp_residual
    return wr[0] if isinstance(wr, tuple) else wr


def check_update(prep, flow, bres, sums=None):
    """K1 against its plain version on one level's inputs (its row offset
    prep["roff"]; given base sums `sums`, if any). Returns |d|, the share
    of elements that differ and the plain M; raises past K1_REL /
    K1_FRAC."""
    m = fu.farneback_update(prep, flow, bres, sums)
    m_plain = fu.farneback_update_plain(
        prep["p0"], prep["p1"], flow, prep["counts"], prep["hw"],
        prep["th"], prep["sw"], bres, prep["roff"], sums)
    a, b = m.float(), m_plain.float()
    d = (a - b).abs()
    frac = (d > 0).float().mean().item()
    if not (bool((d <= K1_REL * b.abs()).all()) and frac <= K1_FRAC):
        raise AssertionError(f"K1 disagrees at {prep['hw']}: max "
                             f"{d.max()}, differing share {frac}")
    return d, frac, m_plain


def check_kernels(h, w, p: FarnebackParams, device, iterations=2):
    """K1, K2 and the level loop against their plain versions at level 0
    of preset p. Returns the deviations; raises past the bounds."""
    bres = _bres(p, h, w)
    prep, flow = level_inputs(h, w, p, device)
    args = (prep["p0"], prep["p1"], flow, prep["counts"], prep["hw"],
            prep["th"], prep["sw"], bres)
    d1, frac1, m_plain = check_update(prep, flow, bres)

    wy, wx = fu._blur_weights_on(prep["hpwp"][0], h, p.winsize, p.gaussian,
                                 device)
    f2 = fu.farneback_blur_solve(m_plain, (h, w), p.winsize, p.gaussian,
                                 True)
    f2_plain = fu.farneback_blur_solve_plain(m_plain, (h, w), wy, wx, True)
    d2 = (f2 - f2_plain).abs()
    if not bool((d2 <= K2_TOL * (1 + f2_plain.abs())).all()):
        raise AssertionError(f"K2 disagrees at {h}x{w}: max {d2.max()}")

    lev = fu.fused_level(prep, flow, p.winsize, p.gaussian, bres,
                         iterations)
    m_p = fu.farneback_update_plain(*args)
    for _ in range(iterations - 1):
        m_p = fu.farneback_update_plain(
            prep["p0"], prep["p1"],
            fu.farneback_blur_solve_plain(m_p, (h, w), wy, wx, True),
            *args[3:])
    lev_plain = fu.farneback_blur_solve_plain(m_p, (h, w), wy, wx, True)
    d3 = (lev - lev_plain).abs()
    if not bool((d3 <= LEVEL_TOL * (1 + lev_plain.abs())).all()):
        raise AssertionError(f"level disagrees at {h}x{w}: max {d3.max()}")
    return {"k1_max": d1.max().item(), "k1_mean": d1.mean().item(),
            "k1_share": frac1, "k2_max": d2.max().item(),
            "k2_mean": d2.mean().item(), "level_max": d3.max().item(),
            "level_mean": d3.mean().item()}


# K1b (farneback_block_sums) sums float32 flow in float64 in another
# order than its plain version: within a few float64 ULPs of the plain
# sums' magnitudes, and the bases rounded from them equal.
K1B_REL = 1e-12


def slab_update_inputs(device, h=480, w=640, origin=112, hs=368):
    """K1's inputs at level 0 of the clamped slab [origin, origin + hs) of
    a 480x640 legacy pair ([15]'s rank 1: row tile 120, row offset 112):
    the slab's expansions made with its place in the frame and a smooth
    random flow of up to +-4 px. -> (prep, flow, bres, own rows)."""
    p = FarnebackParams.legacy()
    f = moving_frames(2, h, w, device, seed=4, color=False)
    slab = fb.Slab(origin, h)
    e0, e1 = (fb.farneback_precompute(x[origin:origin + hs], p,
                                      slab)[p.levels] for x in f)
    th, roff = fb._frame_rows(hs, p, 0, slab)
    prep = fu.prepare_expansions(e0, e1, th, hw=(hs, w),
                                 subcol=p.warp_subcol, roff=roff)
    hp, wp = prep["hpwp"]
    g = torch.Generator().manual_seed(5)
    coarse = (torch.rand((1, 2, hs // 16 + 2, w // 16 + 2), generator=g)
              * 2 - 1) * 4.0
    flow = torch.zeros((2, hp, wp), dtype=torch.float32)
    flow[:, :hs, :w] = F.interpolate(coarse, size=(hs, w), mode="bilinear",
                                     align_corners=False)[0]
    return prep, flow.to(device), _bres(p, h, w), (h // 2 - origin, hs)


def check_slab_update(device):
    """K1 at a non-zero row offset (the slab of ``slab_update_inputs``)
    against its plain version, alone and with given base sums (the
    slab's own rows' K1b sums, as the ranks' sums are handed to it); K1b
    against its plain version. Raises past K1_REL / K1_FRAC and
    K1B_REL."""
    prep, flow, bres, own = slab_update_inputs(device)
    th, sw, roff = prep["th"], prep["sw"], prep["roff"]
    d1, frac1, _ = check_update(prep, flow, bres)
    sums = fu.farneback_block_sums(flow, th, sw, roff, own)
    plain = fu.farneback_block_sums_plain(flow, th, sw, roff, own)
    rel = float(((sums - plain).abs() / (1 + plain.abs())).max())
    cnt = prep["counts"].double()
    if rel > K1B_REL or not torch.equal(torch.round((sums / cnt).float()),
                                        torch.round((plain / cnt).float())):
        raise AssertionError(f"K1b disagrees: relative {rel}")
    d2, frac2, _ = check_update(prep, flow, bres, sums)
    return {"roff": roff, "th": th, "k1_max": d1.max().item(),
            "k1_share": frac1, "k1_given_sums_max": d2.max().item(),
            "k1_given_sums_share": frac2, "k1b_rel": rel}


def k1_bytes_ops(hp, wp):
    """K1's bytes and operations at a (hp, wp) level: p0 and the sampled
    table (one bf16 per pixel and channel each), the flow read, M written;
    ~45 ops for the 5-channel bilinear sample and ~40 for the tail per
    pixel."""
    px = hp * wp
    return px * (5 * 2 + 5 * 2 + 2 * 4 + 5 * 2), px * 85


def update_levels(h, w, p: FarnebackParams, device, reps=50):
    """K1 at every level of preset p's pyramid at (h, w), coarsest first:
    against its plain version (``check_update``), with its base blocks,
    cluster size S and CTA count, and, when reps > 0, its device time per
    launch (median, min and max of `reps` profiled launches) beside its
    bound (S and CTAs are the card's: None off it). Returns (one dict per
    level, K1's device us per frame: each level's median times the
    preset's iterations there, or None when not timed)."""
    wr, it_sched = fb._residual_schedule(h, w, p)
    active = fu.card_clusters() if device.type == "cuda" else None
    rows, frame_us = [], 0.0
    for k in range(p.levels, -1, -1):
        prep, flow = level_inputs(h, w, p, device, k)
        bres = fb._per_level(wr, k)
        d, frac, _ = check_update(prep, flow, bres)
        th, (hp, wp), sw = prep["th"], prep["hpwp"], prep["sw"]
        s, ctas = fu.cluster_size(th, hp, wp, sw, active) if active \
            else (None, None)
        row = {"level": k, "hw": prep["hw"], "th": th, "sw": sw,
               "blocks": (hp // th) * (wp // sw), "S": s, "ctas": ctas,
               "bres": bres, "iterations": fb._level_iters(p, it_sched, k),
               "max_abs_err": d.max().item(), "differing_share": frac}
        if reps:
            t = sorted(device_times(
                lambda: fu.farneback_update(prep, flow, bres), reps,
                "farneback_update_kernel"))
            nbytes, ops = k1_bytes_ops(hp, wp)
            row.update(us=t[len(t) // 2] * 1e3, us_min=t[0] * 1e3,
                       us_max=t[-1] * 1e3,
                       bound_us=max(nbytes / HBM_BYTES_PER_S,
                                    ops / F32_FLOPS) * 1e6)
            frame_us += row["us"] * row["iterations"]
        rows.append(row)
    return rows, (frame_us if reps else None)


def upsample_geometries(h, w, p: FarnebackParams):
    """(src_true, dst_true, src_pad, dst_pad, scale) of every level change
    of the Farneback pyramid of preset p at (h, w), coarsest first."""
    out, prev = [], None
    for k in range(p.levels, -1, -1):
        _, lh, lw, _, _ = fb._level_geometry(h, w, p, k)
        th = fu._row_tile(lh)
        pad = (-(-lh // th) * th, -(-lw // 128) * 128)
        if prev is not None:
            out.append((prev[0], (lh, lw), prev[1], pad, 1.0 / p.pyr_scale))
        prev = ((lh, lw), pad)
    return out


def _padded_flow(src_true, src_pad, device, seed=0):
    """A random flow of a few px on the true region, zero pads."""
    g = torch.Generator().manual_seed(seed)
    flow = torch.zeros((2,) + tuple(src_pad), dtype=torch.float32)
    flow[:, :src_true[0], :src_true[1]] = \
        torch.randn((2,) + tuple(src_true), generator=g) * 3
    return flow.to(device)


def check_resize(h, w, p: FarnebackParams, device):
    """K4 against its plain version and the dense two-matmul form at every
    level change of preset p at (h, w). Returns the largest deviations;
    raises past K4_TOL and K4_DENSE_REL."""
    worst = {"k4_vs_plain": 0.0, "k4_vs_dense": 0.0}
    for i, (st, dt, sp, dp, scale) in enumerate(upsample_geometries(h, w,
                                                                    p)):
        flow = _padded_flow(st, sp, device, seed=i)
        got = img_ops.resize_bilinear_cf_padded(flow, st, dt, dp, scale)
        key = img_ops.resize_key(flow, st, dt, dp, scale)
        plain = img_ops.resize_cf_padded_plain(
            flow, *img_ops._padded_taps_on(key, flow.device))
        dense = img_ops.resize_cf_padded_dense(flow, key)
        d_plain = (got - plain).abs().max().item()
        d_dense = (got - dense).abs().max().item()
        dense_ok = bool(((got - dense).abs() <=
                         K4_DENSE_REL * (1 + dense.abs())).all())
        true = torch.zeros_like(got, dtype=torch.bool)
        true[:, :dt[0], :dt[1]] = True
        pads = got.masked_fill(true, 0.0).abs().max().item()
        if d_plain > K4_TOL or not dense_ok or pads != 0.0:
            raise AssertionError(
                f"K4 disagrees at {st}->{dt}: vs plain {d_plain}, vs dense "
                f"{d_dense}, pads {pads}")
        worst["k4_vs_plain"] = max(worst["k4_vs_plain"], d_plain)
        worst["k4_vs_dense"] = max(worst["k4_vs_dense"], d_dense)
    return worst


def blur_inputs(h, w, p: FarnebackParams, device, k):
    """K2's inputs at level k of preset p at (h, w): M from K1 (its plain
    version on the CPU) on ``level_inputs``, the level's true size, and
    its iterations there."""
    wr, it_sched = fb._residual_schedule(h, w, p)
    prep, flow = level_inputs(h, w, p, device, k)
    m = fu.farneback_update(prep, flow, fb._per_level(wr, k))
    return m, prep["hw"], fb._level_iters(p, it_sched, k)


def check_blur(h, w, p: FarnebackParams, device):
    """K2 against its plain version at every level of preset p at (h, w),
    with the pads zeroed (the engine's call) and, at level 0, without.
    Returns the largest deviation and the levels' (true size, half-width,
    (tile rows, cols, strip)); raises past K2_TOL or on a nonzero pad."""
    half = p.winsize // 2
    worst, levels = 0.0, []
    for k in range(p.levels, -1, -1):
        m, (lh, lw), _ = blur_inputs(h, w, p, device, k)
        hp, wp = m.shape[1:]
        wy, wx = fu._blur_weights_on(hp, lh, p.winsize, p.gaussian, device)
        for zero_pads in (True, False) if k == 0 else (True,):
            got = fu.farneback_blur_solve(m, (lh, lw), p.winsize, p.gaussian,
                                          zero_pads)
            if device.type == "cuda":
                torch.cuda.synchronize(device)   # a fault shows here
            plain = fu.farneback_blur_solve_plain(m, (lh, lw), wy, wx,
                                                  zero_pads)
            d = (got - plain).abs().max().item()
            pads = got[:, lh:, :].abs().sum().item() + \
                got[:, :, lw:].abs().sum().item() if zero_pads else 0.0
            if not d <= K2_TOL or pads != 0.0:
                raise AssertionError(f"K2 disagrees at level {lh}x{lw} of "
                                     f"{h}x{w} (half {half}, zero_pads "
                                     f"{zero_pads}): max |d| {d}, pads "
                                     f"{pads}")
            worst = max(worst, d)
        plan = fu.blur_plan(hp, wp, half, (lh, lw))
        levels.append(((lh, lw), half, (plan["rows"], plan["cols"],
                                        plan["strip"])))
    return {"k2_vs_plain": worst, "levels": levels}


def lk_points(n, h, w, seed, win=50):
    """n track points at (h, w): random ones, a third of them within `win`
    px of one of the four borders, plus corners and points outside the
    image."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 2), generator=g)
    pts = u * torch.tensor([w - 1.0, h - 1.0])
    k = torch.arange(n) % 12
    pts[k == 0, 0] = u[k == 0, 0] * win                  # left
    pts[k == 3, 1] = u[k == 3, 1] * win                  # top
    pts[k == 6, 0] = (w - 1.0) - u[k == 6, 0] * win      # right
    pts[k == 9, 1] = (h - 1.0) - u[k == 9, 1] * win      # bottom
    extra = torch.tensor([[0.0, 0.0], [w - 1.0, h - 1.0], [-10.0, h / 2],
                          [w + 20.0, h + 20.0], [-300.0, -300.0],
                          [5000.0, 20.0]])
    pts[:len(extra)] = extra
    return pts


def lk_inputs(device, streams=1):
    """Two consecutive 640x480 gray frames per stream: the tracker's
    inputs."""
    f = moving_frames(streams + 1, 480, 640, device, color=False)
    return f[:streams].contiguous(), f[1:streams + 1].contiguous()


def check_lk(device, n, streams=1, p: LKParams = LKParams.particles(),
             timeline=False):
    """K3 against its plain version at 640x480 on `streams` x n points.
    Returns the deviations; raises past the LK_* bounds."""
    prev, nxt = lk_inputs(device, streams)
    if timeline:
        pts = timeline_init((10.0, 150.0), (630.0, 400.0), n - 1).vertices
        pts = torch.cat([lk_points(8, 480, 640, 1), pts[8:]])[None]
    else:
        pts = torch.stack([lk_points(n, 480, 640, 10 + s)
                           for s in range(streams)])
    pts = pts.to(device)
    return _compare_lk(prev, nxt, pts, p, n * streams // 2)


def _compare_lk(prev, nxt, pts, p, min_tracked):
    """K3 and its plain version on the same frames and points, held to the
    LK_* bounds; at least min_tracked points tracked by both."""
    pyr_prev, pyr_next, derivs = lk.prepare(prev, nxt, p)
    out, iters = lk_track(pyr_prev, pyr_next, derivs, pts, p)
    if pts.device.type == "cuda":
        torch.cuda.synchronize(pts.device)   # a fault in the kernel shows here
    ref, ref_iters = lk_track_plain(pyr_prev, pyr_next, derivs, pts, p)
    st, st_ref = out[..., 2] > 0.5, ref[..., 2] > 0.5
    both = st & st_ref
    d = (out[..., :2] - ref[..., :2]).norm(dim=-1)
    finite = torch.isfinite(d)
    if not bool(finite.all()) or int(both.sum()) < min_tracked:
        raise AssertionError(f"K3: {int((~finite).sum())} non-finite "
                             f"points, {int(both.sum())} tracked")
    dt = d[both]
    res = {"points": pts.shape[0] * pts.shape[1], "tracked": int(both.sum()),
           "px_max": d.max().item(), "px_median": dt.median().item(),
           "share_within": (dt <= LK_PX).float().mean().item(),
           "status_equal": (st == st_ref).float().mean().item(),
           "err_excess": ((out[..., 3] - ref[..., 3]).abs() -
                          LK_ERR_RTOL * ref[..., 3].abs()).max().item(),
           "iters_mean": iters.float().mean().item(),
           "iters_equal": (iters == ref_iters).float().mean().item(),
           "iters_differ": int((iters != ref_iters).sum()),
           "longest_chain": int(iters.max()),
           "moved_median_px": (out[..., :2] - pts).norm(dim=-1).median()
           .item()}
    if res["share_within"] < LK_SHARE or res["px_median"] >= LK_MEDIAN or \
            res["status_equal"] < LK_SHARE or \
            res["err_excess"] > 1e-7:
        raise AssertionError(f"K3 disagrees: {res}")
    return res


def check_lk_far(device, shift=(2, 10)):
    """K3 against its plain version on one pyramid level where 30 points
    move by `shift` (rows, columns) px, farther than the J patch's margin
    (lk_kernel.PATCH_MARGIN), so the kernel copies its patch again inside
    the level: a smooth random 240x320 texture and the same texture rolled
    by shift. Returns the deviations; raises past the LK_* bounds or when
    the points did not move past the margin."""
    g = torch.Generator().manual_seed(3)
    tex = torch.rand((1, 1, 240, 320), generator=g) * 255
    for _ in range(3):
        tex = F.avg_pool2d(F.pad(tex, (4, 4, 4, 4), mode="replicate"), 9,
                           stride=1)
    tex = tex[0]
    tex = ((tex - tex.min()) / (tex.max() - tex.min()) * 255).to(
        torch.uint8)
    nxt = torch.roll(tex, shifts=shift, dims=(1, 2))
    grid = torch.stack(torch.meshgrid(torch.linspace(60.0, 250.0, 6),
                                      torch.linspace(50.0, 180.0, 5),
                                      indexing="xy"), -1).reshape(1, -1, 2)
    p = LKParams((50, 50), 0, 30, 0.01, 1e-4)
    res = _compare_lk(tex.to(device), nxt.to(device), grid.to(device), p,
                      grid.shape[1])
    if res["moved_median_px"] <= PATCH_MARGIN:
        raise AssertionError(f"K3 far move: the points moved only "
                             f"{res['moved_median_px']} px")
    return res


def prep_call(img, args, channels_first=True):
    """(K5 call, K6 call, plain K5, plain K6, dense form, t) of one level
    geometry (``farneback._prep_level_args``) on img's device; each call
    returns that step's output."""
    win = fb._prep_windows_on(args, img.device)
    ph, pw = args[8], args[9]
    ig = fb._poly_exp_consts(args[4], args[5])[3:]
    odt = torch.bfloat16 if channels_first else torch.float32
    t = prep_kernel.prep_y(img, win)
    return (lambda: prep_kernel.prep_y(img, win),
            lambda: prep_kernel.prep_x3(t, win, ph, ig, odt, channels_first),
            lambda: prep_kernel.prep_y_plain(img, win["y_lo"], win["wy"]),
            lambda: prep_kernel.prep_x3_plain(t, win["x_lo"], win["wx"], ph,
                                              ig, odt, channels_first),
            lambda: fb.poly_exp_level_dense(img, *args[2:8], (ph, pw),
                                            args[10], odt),
            t)


def check_prep(h, w, p: FarnebackParams, device):
    """K5 and K6 against their plain versions, and the whole level against
    the dense matmul form, at every level of preset p at (h, w), in the
    table layout of p's engine: the fused engine's halo'd (5, Ph, Pw) bf16,
    the portable engine's (lh, lw, 5) float32. Returns the largest
    deviations; raises past PREP_TOL or on a nonzero pad."""
    img = moving_frames(1, h, w, device, color=False)[0].to(torch.float32)
    channels_first = p.warp_impl == "fused"
    worst = {"k5_vs_plain": 0.0, "k6_vs_plain": 0.0, "dense_max": 0.0,
             "dense_mean": 0.0, "dense_share": 0.0}
    for k in range(p.levels, -1, -1):
        args = fb._prep_level_args(h, w, p, k)
        k5, k6, k5_plain, k6_plain, dense, t = prep_call(img, args,
                                                         channels_first)
        out = k6()
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # a fault in a kernel shows here
        d5 = (t.float() - k5_plain().float()).abs().max().item()
        d6 = (out.float() - k6_plain().float()).abs().max().item()
        cf = out if channels_first else out.permute(2, 0, 1)
        dd = (cf.float() - dense().float()).abs()
        lh, lw, (oy, ox) = args[2], args[3], args[10]
        inner = torch.zeros(cf.shape[1:], dtype=torch.bool, device=device)
        inner[oy:oy + lh, ox:ox + lw] = True
        pads = cf.float().masked_fill(inner, 0.0).abs().max().item()
        if d5 > PREP_TOL or d6 > PREP_TOL or pads != 0.0:
            raise AssertionError(f"K5/K6 disagree at level {lh}x{lw} of "
                                 f"{h}x{w}: K5 {d5}, K6 {d6}, pads {pads}")
        worst["k5_vs_plain"] = max(worst["k5_vs_plain"], d5)
        worst["k6_vs_plain"] = max(worst["k6_vs_plain"], d6)
        worst["dense_max"] = max(worst["dense_max"], dd.max().item())
        worst["dense_mean"] = max(worst["dense_mean"], dd.mean().item())
        worst["dense_share"] = max(worst["dense_share"],
                                   (dd > 0).float().mean().item())
    return worst


def warp_inputs(h, w, device, flow_px, seed=0):
    """K7's inputs at (h, w): the level-0 channels-last table of a
    moving-texture frame (the portable engine's r1) and a smooth random
    flow of up to +-flow_px, with integer displacements sprinkled in."""
    p = dataclasses.replace(FarnebackParams.subtract_average(),
                            warp_impl="pallas")
    f = moving_frames(1, h, w, device, seed=seed, color=False)[0]
    r1 = fb.farneback_precompute(f, p)[-1]
    g = torch.Generator().manual_seed(seed + 1)
    coarse = (torch.rand((1, 2, h // 32 + 2, w // 32 + 2), generator=g)
              * 2 - 1) * flow_px
    flow = F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=False)[0].permute(1, 2, 0)
    flow[::7, ::5] = torch.round(flow[::7, ::5])
    return r1, flow.contiguous().to(device)


def check_warp(h, w, device, budget=16, flow_px=24.0):
    """K7 against its plain version (everywhere) and the exact gather (on
    the pixels the mask keeps) at (h, w). Returns the deviations; raises
    past WARP_TOL or WARP_GATHER_REL."""
    r1, flow = warp_inputs(h, w, device, flow_px)
    got = warp_kernel.warp5_shift(r1, flow, budget)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    plain = warp_kernel.warp5_shift_plain(r1, flow, budget)
    _, inside = fb._warp5_shift_mask(h, w, flow, budget)
    gather, _ = fb._warp5_gather(r1, flow)
    d = (got - plain).abs()
    scale = r1.abs().amax(dim=(0, 1))
    dg = ((got - gather).abs() / scale)[inside]
    res = {"max_inside": d[inside].max().item(), "max_all": d.max().item(),
           "inside_share": inside.float().mean().item(),
           "vs_gather_rel": dg.max().item(),
           "vs_gather_mean_rel": dg.mean().item()}
    if res["max_all"] > WARP_TOL or res["vs_gather_rel"] > WARP_GATHER_REL \
            or not 0.2 < res["inside_share"] < 0.95:
        raise AssertionError(f"K7 disagrees at {h}x{w}: {res}")
    return res


def halo_tiles_inputs(device, bres, sw, seed=0):
    """K8's halo-layout inputs at 1080p: bench_warp's table and N(0, 3)
    flows plus a smooth field of up to +-60 px, so that the block bases
    spread and the y base clamp (+-(HALO_Y - bres - 1)) is reached."""
    g = bench_warp.inputs(device, sw, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    coarse = (torch.rand((1, 2, 6, 10), generator=gen) * 2 - 1) * 60.0
    field = F.interpolate(coarse, size=(g["hp"], g["wp"]), mode="bilinear",
                          align_corners=False)[0]
    g["flow"] = (g["flow"] + field.to(device)).contiguous()
    return g


def tiled_levels(h, w, p: FarnebackParams = TILED_PRESET):
    """(level, (lh, lw), tile, bres, iterations) at every level of the
    tiled engine's pyramid for preset p at (h, w), coarsest first, as
    ``farneback._portable_from_expansions`` walks it."""
    wr, it_sched = fb._residual_schedule(h, w, p)
    out = []
    for k in range(p.levels, -1, -1):
        _, lh, lw, _, _ = fb._level_geometry(h, w, p, k)
        out.append((k, (lh, lw), fb._adaptive_tile(lh, lw, p.warp_tile),
                    fb._per_level(wr, k), fb._level_iters(p, it_sched, k)))
    return out


def frame_tiles_inputs(h, w, c, bres, device, seed=0, flow_px=8.0):
    """K8's frame-layout inputs: for c == 5 the tiled engine's level-0
    expansion of a moving-texture frame at (h, w), for c == 3 or 1 that
    frame in colour or gray as float32 (feature_stab's and dense_lk's
    tables); a smooth flow of up to +-flow_px (a random value every ~128
    px, interpolated) plus N(0, (bres / 2)^2) noise and a mean shift of
    (flow_px / 4, -flow_px / 6), so that the tile bases spread and some
    residuals pass +-bres."""
    f = moving_frames(1, h, w, device, seed=seed, color=c == 3)[0]
    if c == 5:
        table = fb.farneback_precompute(f, TILED_PRESET)[-1]
    else:
        table = f.to(torch.float32).reshape(h, w, c).contiguous()
    g = torch.Generator().manual_seed(seed + 1)
    coarse = (torch.rand((1, 2, h // 128 + 2, w // 128 + 2), generator=g)
              * 2 - 1) * flow_px
    flow = F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=False)[0].permute(1, 2, 0)
    flow = (flow + torch.randn((h, w, 2), generator=g) * (0.5 * bres) +
            torch.tensor([flow_px / 4, -flow_px / 6]))
    return table, flow.contiguous().to(device)


def check_tiles(device):
    """K8 against its plain version: the halo layout at 1080p at both
    bench_warp configurations (with the no-base instance), the frame layout
    at every level of the tiled engine's 640x480 pyramid (C = 5) and at
    ``TILES_FRAME_CHECKS`` (C = 1 at 1080p, C = 3 at 640x480, a ragged
    75x107). Returns the deviations and what the inputs exercised; raises
    past TILES_TOL or when no base or clamp was exercised."""
    out = {}
    for bres, sw in ((2, None), (1, 640)):
        g = halo_tiles_inputs(device, bres, sw)
        args = (g["table"], g["flow"], g["counts"], g["th"], g["sw"], bres)
        got = warp_kernel.warp_tiles(*args)
        got_z = warp_kernel.warp_tiles_nobase(g["table"], g["flow"],
                                              g["th"], g["sw"], bres)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        d = (got - warp_kernel.warp_tiles_plain(*args)).abs().max().item()
        dz = (got_z - warp_kernel.warp_tiles_nobase_plain(
            g["table"], g["flow"], g["th"], g["sw"], bres)).abs().max().item()
        lim_y = fu.HALO_Y - bres - 1
        bases = warp_kernel.tile_bases_plain(g["flow"], g["counts"], g["th"],
                                             g["sw"], fu.HALO_X - bres - 1,
                                             lim_y)
        res = {"max": d, "nobase_max": dz,
               "base_min": bases.min().item(), "base_max": bases.max().item(),
               "y_clamped_blocks": int((bases[1].abs() == lim_y).sum())}
        if d > TILES_TOL or dz > TILES_TOL or res["y_clamped_blocks"] == 0:
            raise AssertionError(f"K8 halo layout, bres {bres}: {res}")
        out[f"halo_1080p_bres{bres}_sw{g['sw']}"] = res
    frames = {f"640x480 L{k} {lh}x{lw}": (lh, lw, 5, tile, bres)
              for k, (lh, lw), tile, bres, _ in tiled_levels(480, 640)}
    for i, (name, (h, w, c, (th, tw), bres)) in enumerate(
            {**frames, **TILES_FRAME_CHECKS}.items()):
        table, flow = frame_tiles_inputs(h, w, c, bres, device, seed=i)
        out[f"frame {name} C{c} bres {bres}"] = check_frame_tiles(
            name, table, flow, th, tw, bres)
    return out


def check_frame_tiles(name, table, flow, th, tw, bres, clamped=True):
    """K8 in its frame layout against its plain version on (table, flow):
    the deviation, the largest tile base and the share of pixels whose
    residual is clamped. Raises past TILES_TOL, when no base reaches 2 px,
    or (with `clamped`) when no residual or every residual is clamped."""
    h, w, c = table.shape
    got = warp_kernel.warp_tiles(table, flow, None, th, tw, bres)
    if got.is_cuda:
        torch.cuda.synchronize(got.device)
    plain = warp_kernel.warp_tiles_plain(table, flow, None, th, tw, bres)
    counts = warp_kernel.frame_counts(h, w, th, tw, flow.device)
    bases = warp_kernel.tile_bases_plain(flow.permute(2, 0, 1), counts,
                                         th, tw, warp_kernel.MAX_BASE,
                                         warp_kernel.MAX_BASE)
    full = bases.repeat_interleave(th, 1).repeat_interleave(tw, 2)
    resid = flow.permute(2, 0, 1) - full[:, :h, :w]
    res = {"channels": c, "tile": (th, tw), "bres": bres,
           "max": (got - plain).abs().max().item(),
           "base_abs_max": bases.abs().max().item(),
           "residual_clamped_share":
               (resid.abs() > bres).any(0).float().mean().item()}
    if res["max"] > TILES_TOL or res["base_abs_max"] < 2 or \
            (clamped and not 0.0 < res["residual_clamped_share"] < 1.0) or \
            got.shape != (h, w, c):
        raise AssertionError(f"K8 frame layout, {name}: {res}")
    return res


def dense_lk_shapes(h=480, w=640, p: LKParams = LKParams.dense_grid()):
    """(lh, lw) of every level of dense_lk's pyramid at (h, w), finest
    first (pyrDown halves rounding up)."""
    shapes = [(h, w)]
    for _ in range(lk.pyramid_levels((h, w), p)):
        shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
    return shapes


def stab_homography(device, deg=1.0, shift=(3.0, 2.0), h=480, w=640):
    """A rotation by `deg` about the frame's centre plus `shift` px, as a
    (3, 3) float32 homography on `device`."""
    a = np.deg2rad(deg)
    cx, cy = w / 2, h / 2
    m = np.float32([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]])
    m[0, 2] = cx - m[0, 0] * cx - m[0, 1] * cy + shift[0]
    m[1, 2] = cy - m[1, 0] * cx - m[1, 1] * cy + shift[1]
    return torch.from_numpy(m).to(device)


def check_tiles_new_paths(device):
    """K8's frame layout at the new paths' geometries: dense_lk's four
    levels at 640x480 (C = 1, bres 4, tile 64x256; ``frame_tiles_inputs``'
    flows moved by (4, -3) px, so that the one tile of the 60x80 level has
    a base too) and stabilizeTPU's 480x640 colour frame (C =
    3, bres 6) warped by the displacement of a 1-degree rotation plus a
    (3, 2) px shift (``feature_stab.homography_displacement``; no
    residual reaches 6 px there). Bit for bit or raises."""
    out = {}
    for k, (lh, lw) in enumerate(dense_lk_shapes()):
        table, flow = frame_tiles_inputs(lh, lw, 1, 4, device, seed=20 + k)
        flow = (flow + torch.tensor([4.0, -3.0], device=device)).contiguous()
        out[f"dense_lk L{k} {lh}x{lw} C1 bres 4"] = check_frame_tiles(
            f"dense_lk L{k}", table, flow, 64, 256, 4)
    frame = moving_frames(1, 480, 640, device, seed=30)[0]
    disp = feature_stab.homography_displacement(stab_homography(device),
                                                480, 640)
    out["stabilizeTPU 480x640 C3 bres 6, homography"] = check_frame_tiles(
        "stabilizeTPU", frame.to(torch.float32).contiguous(), disp, 64, 256,
        6, clamped=False)
    return out


def device_events(fn, cpu=False, tries=3, chrome_trace=None,
                  complete=None) -> list:
    """The CUDA events of one torch.profiler session around fn(), which
    ends in a device sync (with `cpu`, the session records host
    activity too). A session that records no device event at all, or
    whose events `complete` (a predicate on them) rejects, lost records
    (torch.profiler on the card does, now and then): it is repeated, fn
    run again, at most tries - 1 times, and the script says so; the last
    session's events are returned. With `chrome_trace` (a path), that
    session's Chrome trace is written there too."""
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    if not torch.cuda.is_available():
        tries = 1                           # no device events to wait for
    for i in range(tries):
        with profile(activities=acts) as prof:
            fn()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events and (complete is None or complete(events)):
            break
        if i + 1 < tries:
            what = "no device event" if not events else \
                "device events that disagree with the launch counters"
            print(f"    torch.profiler recorded {what} in a session; "
                  f"profiling it again ({i + 2} of {tries})", flush=True)
    if chrome_trace is not None:
        prof.export_chrome_trace(str(chrome_trace))
    return events


def k8_kernels_per_call(device, reps=20):
    """Device kernels one K8 call launches in each layout: the
    torch.profiler records of `reps` calls in one session after a warm
    call (sessions around a single call came back empty on some hosts),
    each name listed as many times as it ran per call. A session in
    which a name's records are not a multiple of `reps` is profiled
    again (``device_events``); raises when the last one's are not
    either (records were lost, or calls differ). -> {layout: [kernel
    names]}."""
    g = halo_tiles_inputs(device, 2, None)
    table, flow = frame_tiles_inputs(480, 640, 5, 2, device)
    calls = {"halo": lambda: warp_kernel.warp_tiles(
                 g["table"], g["flow"], g["counts"], g["th"], g["sw"], 2),
             "frame": lambda: warp_kernel.warp_tiles(table, flow, None, 64,
                                                     256, 2)}

    def whole(events):
        return not any(n % reps for n in collections.Counter(
            e.name for e in events).values())
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        events = device_events(
            lambda: ([fn() for _ in range(reps)], torch.cuda.synchronize()),
            complete=whole)
        seen = collections.Counter(e.name for e in events)
        if not whole(events):
            raise AssertionError(f"K8 {name}: {dict(seen)} records of "
                                 f"{reps} calls")
        out[name] = [k for k, n in sorted(seen.items())
                     for _ in range(n // reps)]
    return out


def k8_kernels_per_frame(device, h=480, w=640):
    """K8's device kernels in one frame of the tiled engine at (h, w): the
    torch.profiler records (after a warm frame) whose name holds
    "warp_tiles" or "tile_sums", and the wrapper's launches. The session
    opens with a few small kernels and a sync, so that the frame's
    kernels are not the first it sees; a session whose K8 records differ
    from its launches lost records and is profiled again
    (``device_events``). -> the last session's counts."""
    f = moving_frames(2, h, w, device, color=False)
    e0, e1 = (fb.farneback_precompute(f[i], TILED_PRESET) for i in (0, 1))
    step = lambda: fb.farneback_from_expansions(  # noqa: E731
        e0, e1, (h, w), TILED_PRESET)
    step()
    torch.cuda.synchronize()
    lead = torch.zeros(1024, device=device)
    calls = [0]

    def traced():
        for _ in range(4):
            lead.add_(1)
        torch.cuda.synchronize()
        before = warp_kernel.warp_tiles.launches
        step()
        torch.cuda.synchronize()
        calls[0] = warp_kernel.warp_tiles.launches - before

    def k8(events):
        return [e.name for e in events
                if "warp_tiles" in e.name or "tile_sums" in e.name]
    names = k8(device_events(
        traced, complete=lambda ev: len(k8(ev)) == calls[0]))
    return {"device_kernels": len(names), "calls": calls[0]}


# ---------------------------------------------------------------------------
# Phase 3: the legacy step
# ---------------------------------------------------------------------------

def _live_state(state, seed=1):
    """Carry the state past the 30-frame accumulation warmup with a random
    accumulator, so the duty mask of the next steps is live."""
    g = torch.Generator().manual_seed(seed)
    acc = torch.randint(0, 9, state.accumulator.shape, generator=g)
    return state._replace(
        accumulator=acc.to(torch.float32).to(state.accumulator.device),
        framecount=torch.full_like(state.framecount, 35))


def check_legacy_outputs(outs, cfg):
    want = {f: (cfg.ydim, cfg.xdim, 3) for f in outs._fields}
    want["hist_wheel_bgr"] = (min(cfg.ydim, cfg.xdim),) * 2 + (3,)
    want["mask"] = (cfg.ydim, cfg.xdim)
    for f in outs._fields:
        t = getattr(outs, f)
        if tuple(t.shape) != want[f] or t.dtype != torch.uint8:
            raise AssertionError(f"{f}: {t.dtype} {tuple(t.shape)}")


def _dense_upsample(img, src_true, dst_true, dst_pad, scale=1.0):
    return img_ops.resize_cf_padded_dense(
        img, img_ops.resize_key(img, src_true, dst_true, dst_pad, scale))


def run_legacy(device, frames=FRAMES, xdim=640, ydim=480,
               raw_hw=(RAW_H, RAW_W), dense_upsample=False):
    """The legacy path: make_legacy at xdim x ydim (default 640x480, 250
    seeds) over `frames` synthetic raw frames. Returns (ms per warm frame
    by host clock, ms by CUDA events or None, launches of K1, K2, K4, K5
    and K6, mask share). dense_upsample=True swaps K4 for the dense two-matmul
    form for this run, to time the step with and without the kernel in
    one process."""
    fb.resize_bilinear_cf_padded = _dense_upsample if dense_upsample \
        else img_ops.resize_bilinear_cf_padded
    cfg = ModeConfig(xdim=xdim, ydim=ydim, total_frames=frames)
    raw = moving_frames(frames + 1, *raw_hw, device)
    init, step = make_legacy(cfg, device=device)
    state = init(raw[0])
    reset_launches()
    warm = 5
    cuda = device.type == "cuda"
    for t in range(1, frames + 1):
        if t == warm + 1:
            if cuda:
                torch.cuda.synchronize(device)
                ev0 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            t0 = time.perf_counter()
        state, outs = step(state, raw[t])
    if cuda:
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        torch.cuda.synchronize(device)
    host_ms = (time.perf_counter() - t0) * 1e3 / (frames - warm)
    ev_ms = ev0.elapsed_time(ev1) / (frames - warm) if cuda else None
    counts = launch_counts()
    launches = tuple(counts[k] for k in ("K1", "K2", "K4", "K5", "K6"))
    check_legacy_outputs(outs, cfg)
    for f in ("disp", "dist"):
        if not bool(torch.isfinite(getattr(state.field, f)).all()):
            raise AssertionError(f"non-finite streamline field {f}")
    if not bool(torch.isfinite(state.upper)):
        raise AssertionError("non-finite UPPER")
    mask_share = (outs.mask > 0).float().mean().item()
    if not 0.0 < mask_share < 1.0 or int(state.framecount) != frames:
        raise AssertionError(f"duty mask not live: share {mask_share}")
    return host_ms, ev_ms, launches, mask_share


def compare_legacy_small(device, n=3):
    """The whole legacy step at 192x256 on `device` against the same step
    on the CPU (plain versions), from the same state and frames. The two
    differ only by matmul rounding in the expansion prep (cuBLAS vs the
    CPU), which the chaotic winsize-3 preset amplifies slightly."""
    cfg = ModeConfig(xdim=256, ydim=192, total_frames=40, legacy_seeds=16)
    raw = moving_frames(n + 1, 288, 384, torch.device("cpu"))
    res = {}
    for dev in (device, torch.device("cpu")):
        init, step = make_legacy(cfg, device=dev)
        state = _live_state(init(raw[0]))
        for t in range(1, n + 1):
            state, outs = step(state, raw[t])
        res[dev.type] = (state, outs)
    (sg, og), (sc, oc) = res[device.type], res["cpu"]
    a, b = og.mask.cpu() > 0, oc.mask > 0
    iou = ((a & b).sum() / (a | b).sum().clamp(min=1)).item()
    d = (sg.field.disp.cpu() - sc.field.disp).norm(dim=-1)
    overlay = (og.overlay_bgr.cpu() != oc.overlay_bgr).any(-1).float()
    out = {"mask_iou": iou, "disp_mean": d.mean().item(),
           "disp_p99": torch.quantile(d.flatten(), 0.99).item(),
           "overlay_share": overlay.mean().item()}
    if iou < 0.99 or out["disp_mean"] > 0.05 or out["overlay_share"] > 0.02:
        raise AssertionError(f"legacy step on {device} vs CPU: {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 4: the 1080p stream
# ---------------------------------------------------------------------------

def run_stream_1080p(device, frames=8, warm=3):
    p = FarnebackParams.windowed()
    gray = moving_frames(frames + 1, 1080, 1920, device, color=False)
    exp = fb.farneback_precompute(gray[0], p)
    for t in range(1, frames + 1):
        if t == warm + 1:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        flow, exp = fb.farneback_stream(exp, gray[t], p)
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3 / (frames - warm)
    if tuple(flow.shape) != (1080, 1920, 2) or \
            not bool(torch.isfinite(flow).all()):
        raise AssertionError("bad 1080p flow")
    return ms, flow.norm(dim=-1).mean().item()


def stream_1080p_breakdown(device, frames=5, warm=2):
    """Where the windowed 1080p stream's device time goes: one
    torch.profiler trace of `frames` warm frames. Returns the device
    kernel time per frame, K5's and K6's (and their records, 3 of each
    per frame unless the profiler dropped some), their share of the
    frame, launches per frame and the top kernels."""
    p = FarnebackParams.windowed()
    gray = moving_frames(warm + frames + 1, 1080, 1920, device, color=False)
    exp = fb.farneback_precompute(gray[0], p)
    for t in range(1, warm + 1):
        _, exp = fb.farneback_stream(exp, gray[t], p)
    torch.cuda.synchronize(device)

    def traced():
        e = exp
        for t in range(warm + 1, warm + frames + 1):
            _, e = fb.farneback_stream(e, gray[t], p)
        torch.cuda.synchronize(device)
    by_name = {}
    for e in device_events(traced):
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    total = sum(us for us, _ in by_name.values())

    def of(kernel):
        hits = [v for k, v in by_name.items() if kernel in k]
        return sum(us for us, _ in hits), sum(n for _, n in hits)

    (k5_us, k5_n), (k6_us, k6_n) = of("prep_y_kernel"), of("prep_x3_kernel")
    (k2_us, k2_n), (k4_us, k4_n) = of("farneback_blur_solve_kernel"), \
        of("resize_cf_padded_kernel")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"device_ms_per_frame": total / frames / 1e3,
            "k2_us_per_frame": k2_us / frames, "k2_records": k2_n,
            "k4_us_per_frame": k4_us / frames, "k4_records": k4_n,
            "k5_us_per_frame": k5_us / frames, "k5_records": k5_n,
            "k6_us_per_frame": k6_us / frames, "k6_records": k6_n,
            "prep_share": (k5_us + k6_us) / total,
            "launches_per_frame": sum(n for _, n in by_name.values()) /
            frames,
            "top_us_per_frame": {k[:60]: round(us / frames, 2)
                                 for k, (us, _) in top}}


# ---------------------------------------------------------------------------
# Phase 6: the particle modes through run_frames
# ---------------------------------------------------------------------------

_VERTICES = {"timelines": lambda s: s.timeline.vertices,
             "streaklines": lambda s: s.verts,
             "populationMap": lambda s: s.pop.vertices,
             "flowRedPoints": lambda s: s.pts}
# the colour of the last primitive each mode draws
_COLOUR = {"timelines": modes.BLUE, "streaklines": modes.BLUE,
           "populationMap": None, "flowRedPoints": modes.RED}


def run_mode(device, mode, frames, cfg: ModeConfig = ModeConfig(),
             raw_hw=(RAW_H, RAW_W), warm=2):
    """One particle mode through run_frames over `frames` synthetic raw
    frames. Returns (ms per warm frame by host clock, ms by CUDA events or
    None, K3 launches, vertices, last output frame); raises on a bad
    output."""
    raw = moving_frames(frames + 1, *raw_hw, device)
    init_state = MODES[mode](cfg, device=device)[0](raw[0])
    start = _VERTICES[mode](init_state).clone()
    reset_launches()
    stats = runner.RunStats()
    cuda = device.type == "cuda"
    out = None
    for t, out in enumerate(runner.run_frames(mode, raw, cfg, device=device,
                                              stats=stats), 1):
        if t == warm:
            if cuda:
                torch.cuda.synchronize(device)
                ev0 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            t0 = time.perf_counter()
    if cuda:
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        torch.cuda.synchronize(device)
    host_ms = (time.perf_counter() - t0) * 1e3 / (frames - warm)
    ev_ms = ev0.elapsed_time(ev1) / (frames - warm) if cuda else None
    launches = lk_track.launches
    if stats.frames != frames or int(stats.state.framecount) != frames:
        raise AssertionError(f"{mode}: {stats.frames} frames stepped")
    if tuple(out.shape) != (cfg.ydim, cfg.xdim, 3) or \
            out.dtype != torch.uint8:
        raise AssertionError(f"{mode}: output {out.dtype} "
                             f"{tuple(out.shape)}")
    verts = _VERTICES[mode](stats.state)
    if verts.shape != start.shape or not bool(torch.isfinite(verts).all()):
        raise AssertionError(f"{mode}: bad vertices {tuple(verts.shape)}")
    moved = (verts - start).norm(dim=-1)
    if mode == "streaklines":      # slots beyond the live count stay put
        moved = moved[:, :frames]
    if float(moved.max()) < 0.5:
        raise AssertionError(f"{mode}: no vertex moved")
    if _COLOUR[mode] is not None:
        colour = torch.tensor(_COLOUR[mode], dtype=torch.uint8,
                              device=device)
        if int((out == colour).all(dim=-1).sum()) == 0:
            raise AssertionError(f"{mode}: nothing drawn")
    elif bool((out == img_ops.resize_bilinear(
            raw[-1], (cfg.ydim, cfg.xdim))).all()):
        raise AssertionError(f"{mode}: nothing drawn")    # blended dots
    return host_ms, ev_ms, launches, verts, out


def compare_timelines_small(device, n=3):
    """timelines at 192x256 on `device` against the same steps on the CPU
    (plain versions), from the same state and frames."""
    cfg = ModeConfig(xdim=256, ydim=192, timeline_start=(10.0, 60.0),
                     timeline_end=(246.0, 150.0))
    raw = moving_frames(n + 1, 288, 384, torch.device("cpu"))
    res = {}
    for dev in (device, torch.device("cpu")):
        stats = runner.RunStats()
        outs = list(runner.run_frames("timelines", raw, cfg, device=dev,
                                      stats=stats))
        res[dev.type] = (stats.state.timeline.vertices.cpu(),
                         outs[-1].cpu())
    (vg, og), (vc, oc) = res[device.type], res["cpu"]
    d = (vg - vc).norm(dim=-1)
    out = {"vertex_max_px": d.max().item(), "vertex_mean_px": d.mean().item(),
           "pixels_equal": (og == oc).all(dim=-1).float().mean().item()}
    if out["vertex_max_px"] > MODE_VERTEX_PX or \
            out["pixels_equal"] < MODE_PIXEL_SHARE:
        raise AssertionError(f"timelines on {device} vs CPU: {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 7: the dense Farneback modes through run_frames
# ---------------------------------------------------------------------------

def _float_leaves(state) -> dict:
    """{field: tensor} of a mode state's float leaves (tables left out)."""
    out = {}
    for name, v in zip(state._fields, state):
        if name == "fstream":
            continue
        if hasattr(v, "_fields"):
            out.update(_float_leaves(v))
        elif v.is_floating_point():
            out[name] = v
    return out


def run_dense_mode(device, mode, frames, cfg: ModeConfig = ModeConfig(),
                   raw_hw=(RAW_H, RAW_W), warm=2):
    """One dense Farneback mode through run_frames over `frames` synthetic
    raw frames, every launch counter set to 0 just before. Returns (ms per
    warm frame by host clock, ms by CUDA events or None, launches {kernel:
    n}, last output frame); raises on a bad output or a state that did not
    move."""
    raw = moving_frames(frames + 1, *raw_hw, device)
    stats = runner.RunStats()
    cuda = device.type == "cuda"
    reset_launches()
    outs = []
    for t, out in enumerate(runner.run_frames(mode, raw, cfg, device=device,
                                              stats=stats), 1):
        outs.append(out)
        if t == warm:
            if cuda:
                torch.cuda.synchronize(device)
                ev0 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            t0 = time.perf_counter()
    if cuda:
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        torch.cuda.synchronize(device)
    launches = launch_counts()
    host_ms = (time.perf_counter() - t0) * 1e3 / (frames - warm)
    ev_ms = ev0.elapsed_time(ev1) / (frames - warm) if cuda else None
    if stats.frames != frames or int(stats.state.framecount) != frames:
        raise AssertionError(f"{mode}: {stats.frames} frames stepped")
    out = outs[-1]
    if tuple(out.shape) != (cfg.ydim, cfg.xdim, 3) or \
            out.dtype != torch.uint8:
        raise AssertionError(f"{mode}: output {out.dtype} "
                             f"{tuple(out.shape)}")
    leaves = _float_leaves(stats.state)
    bad = [k for k, v in leaves.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"{mode}: non-finite state {bad}")
    if bool((outs[-1] == outs[-2]).all()) or \
            int(out.reshape(-1, 3).unique(dim=0).shape[0]) < 8:
        raise AssertionError(f"{mode}: the output does not move")
    return host_ms, ev_ms, launches, out


def ring_step_memory(device, steps=5, cfg: ModeConfig = ModeConfig(),
                     mode="averageVector"):
    """A mode with a 300-frame ring (``averageVector``'s of flow,
    ``averageHSV``'s of BGR frames) stepped by hand at 640x480: (MiB of
    device memory its state holds after init, MiB of the peak during
    `steps` steps above what was allocated before init)."""
    raw = moving_frames(steps + 1, RAW_H, RAW_W, device)
    init, step = MODES[mode](cfg, device=device)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    state = init(raw[0])
    torch.cuda.synchronize(device)
    held = torch.cuda.memory_allocated(device) - base
    torch.cuda.reset_peak_memory_stats(device)
    for t in range(1, steps + 1):
        state, _ = step(state, raw[t])
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    return held / 2 ** 20, peak / 2 ** 20


@contextlib.contextmanager
def _recorded_flows(flows: list):
    """Append every flow the modes' stream step computes to `flows`."""
    real = modes.flow_stream_step

    def step(fs, gray, fb):
        flow, nxt = real(fs, gray, fb)
        flows.append(flow.cpu())
        return flow, nxt

    modes.flow_stream_step = step
    try:
        yield
    finally:
        modes.flow_stream_step = real


def dense_small_readings(device, mode, n, cfg: ModeConfig):
    """A dense mode at 192x256 on `device` against the same steps on the
    CPU (plain versions), from the same frames: how far apart the flow's
    mean over the steps (the ring's mean where the mode keeps one) and
    the last output frames are."""
    raw = moving_frames(n + 1, 288, 384, torch.device("cpu"))
    res = {}
    for dev in (device, torch.device("cpu")):
        stats = runner.RunStats()
        flows = []
        with _recorded_flows(flows):
            outs = list(runner.run_frames(mode, raw, cfg, device=dev,
                                          stats=stats))
        ring = getattr(stats.state, "ring", None)
        mean = ring.mean.cpu() if ring is not None \
            else torch.stack(flows).mean(0)
        res[dev.type] = (mean, outs[-1].cpu())
    (mg, og), (mc, oc) = res[device.type], res["cpu"]
    d = (mg - mc).norm(dim=-1).flatten()
    # per pixel, the largest channel difference in uint8 levels
    levels = (og.int() - oc.int()).abs().amax(dim=-1)
    return {"ring_mean_median_px": d.median().item(),
            "ring_mean_p99_px": torch.quantile(d, 0.99).item(),
            "ring_mean_max_px": d.max().item(),
            "pixels_equal": (levels == 0).float().mean().item(),
            "pixels_differing": int((levels > 0).sum()),
            "max_level_diff": int(levels.max()),
            "pixels_over_one_level": int((levels > 1).sum())}


def compare_dense_small(device, mode="subtructAverageVectorWithWindow",
                        n=3, cfg=ModeConfig(xdim=256, ydim=192,
                                            window_size=3)):
    """``dense_small_readings`` held to the DENSE_* limits."""
    out = dense_small_readings(device, mode, n, cfg)
    if out["ring_mean_median_px"] > DENSE_MEDIAN_PX or \
            out["ring_mean_p99_px"] > DENSE_P99_PX or \
            out["pixels_equal"] < DENSE_PIXEL_SHARE:
        raise AssertionError(f"{mode} on {device} vs CPU: {out}")
    return out


# The card-vs-CPU check of the tiled warp: compare_dense_small's mode on
# it. subtructAverageVector's colours are the angle and length of the flow
# minus its frame mean, truncated to uint8: with the tiled engine's flow
# bit-identical on the card and the CPU, 97.98% of its pixels were equal
# (H100), under DENSE_PIXEL_SHARE, so that mode is read, not bounded, on
# both engines (phase [7]).
TILED_SMALL = ModeConfig(xdim=256, ydim=192, window_size=3,
                         warp_impl="tiled")


# ---------------------------------------------------------------------------
# Phase 9: android and the five simple modes
# ---------------------------------------------------------------------------

SIMPLE_MODES = ("android", "averageHSV", "timex", "brightColor",
                "phaseCorrelate", "globalOrientation")
# android's kernel launches per frame: its 4 pyramid levels run 3
# iterations of K1 and K2 each, K4 at the 3 level changes, and K5 and K6
# expand the new frame once per level.
ANDROID_LAUNCHES = {"K1": 12, "K2": 12, "K3": 0, "K4": 3, "K5": 4, "K6": 4,
                    "K7": 0, "K8": 0}
# android on the card vs on the CPU over 3 frames from a live state
# crossing the overlay warmup (the limits of tests/test_torch_android.py's
# whole step against JAX): the flows differ by the frame resize's and the
# prep's matmul rounding, which the cumulative threshold walk can turn into
# a reclassified pixel.
ANDROID_IOU = 0.9
ANDROID_SHARE = 0.99
# phaseCorrelate on the card vs on the CPU: cuFFT and the CPU's FFT round
# the float32 spectrum differently, so each step's shift may differ in its
# last bits (PHASE_SHIFT_PX), while the card's translate of the CPU's
# frames by the CPU's shifts must equal the CPU's frames. Once a step's
# output differs, the next step correlates different frames, so the
# card's own shift drifts further by the third step. A shift one
# float32 ULP apart moves every sample coordinate by up to one ULP, and
# the bilinear blend, rounded to uint8, then flips by one level on the
# pixels whose blend lies near a rounding edge: at most one level, on at
# most 1 - DENSE_PIXEL_SHARE of the pixels. Set from an H100 reading
# (700 W): the card's own shifts 3.6e-6, 5.5e-6 and 6.6e-4 px from the
# CPU's over 3 steps, 98.95% of the pixels equal, one level at most.
PHASE_SHIFT_PX = 1e-3
# the 1080p detector golden: IoU of the port's detector_mask_scan against
# the cv2 oracle mask. The JAX engine scored 0.9863 on a TPU v5e
# (BENCH_r05.json), a reference for accuracy only.
DETECTOR_IOU = 0.95


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def live_android_state(state, seed=9):
    """An android state at i = ANDROID_OVERLAY_WARMUP - 1 whose
    accumulator mixes low- and mid-duty pixels in a band of columns, so
    the local windows there win and the red overlay shows past the
    warmup."""
    i = ANDROID_OVERLAY_WARMUP - 1
    h, w = state.accumulator.shape
    g = torch.Generator().manual_seed(seed)
    lo = torch.randint(0, int(0.04 * i), (h, w), generator=g)
    mid = torch.randint(int(0.08 * i), int(0.17 * i), (h, w), generator=g)
    mix = torch.where(torch.rand((h, w), generator=g) < 0.5, lo, mid)
    acc = torch.full((h, w), 0.5 * i)
    acc[:, w // 4:3 * w // 4] = mix[:, w // 4:3 * w // 4].float()
    return state._replace(
        accumulator=acc.to(state.accumulator.device),
        i=torch.full_like(state.i, i))


def run_simple_mode(device, mode, frames, cfg: ModeConfig = ModeConfig(),
                    raw_hw=(RAW_H, RAW_W), warm=2):
    """One of the six modes stepped by hand over `frames` synthetic raw
    frames (android from a live state at i = 89, so it crosses the
    overlay warmup), every launch counter set to 0 just before. Returns
    (ms per warm frame by host clock, launches {kernel: n}, device kernels
    per frame from one traced frame, last output); raises on a bad output,
    a state that is not finite or an output that does not move."""
    raw = moving_frames(frames + 2, *raw_hw, device)
    init, step = MODES[mode](cfg, device=device)
    state = init(raw[0])
    if mode == "android":
        state = live_android_state(state)
    _sync(device)
    reset_launches()
    outs, prev = [], None
    for t in range(1, frames + 1):
        if t == warm + 1:
            _sync(device)
            t0 = time.perf_counter()
        prev, (state, out) = state, step(state, raw[t])
        outs.append(out)
    _sync(device)
    host_ms = (time.perf_counter() - t0) * 1e3 / (frames - warm)
    launches = launch_counts()
    n_kernels = len(device_events(
        lambda: (step(state, raw[frames + 1]), _sync(device)), cpu=True))
    out = outs[-1]
    if tuple(out.shape) != (cfg.ydim, cfg.xdim, 3) or \
            out.dtype != torch.uint8:
        raise AssertionError(f"{mode}: output {out.dtype} "
                             f"{tuple(out.shape)}")
    bad = [k for k, v in convert.state_to_numpy(state).items()
           if v.dtype.kind == "f" and not np.isfinite(v).all()]
    if bad:
        raise AssertionError(f"{mode}: non-finite state {bad}")
    if bool((outs[-1] == outs[0]).all()):
        raise AssertionError(f"{mode}: the output does not move")
    if mode == "android":
        # red overlay pixels: R set to 255 where the frame's R is not
        resized = img_ops.resize_area(raw[frames], (cfg.ydim, cfg.xdim))
        red = int(((out[..., 2] == 255) & (resized[..., 2] != 255)).sum())
        if float(state.accumulator.sum()) <= 0 or red == 0:
            raise AssertionError(f"android: accumulator or overlay not "
                                 f"live ({red} red pixels)")
    if mode == "timex" and torch.equal(
            state.sum_rgb / state.framecount.float(),
            prev.sum_rgb / prev.framecount.float()):
        raise AssertionError("timex: the mean does not move")
    return host_ms, launches, n_kernels, out


def compare_simple_small(device, mode, n=3):
    """One of the six modes at 192x256 on `device` against the same steps
    on the CPU (plain versions), from the same state and frames; android
    from a live state crossing the warmup. The simple modes: outputs equal
    on >= MODE_PIXEL_SHARE of pixels (the frame resize's matmul rounds
    differently on the card); phaseCorrelate: ``phase_steps`` within
    PHASE_SHIFT_PX and translating alike, the outputs at most one level
    apart on >= DENSE_PIXEL_SHARE of pixels; android: the red overlay's
    IoU >= ANDROID_IOU, the overlays and accumulators equal on >=
    ANDROID_SHARE. Raises past the limits."""
    cfg = ModeConfig(xdim=256, ydim=192, average_buffer=4, bright_window=3,
                     phase_roi=(150, 60, 64, 64))
    raw = moving_frames(n + 1, 288, 384, torch.device("cpu"))
    res = {}
    for dev in (device, torch.device("cpu")):
        init, step = MODES[mode](cfg, device=dev)
        states = [init(raw[0])]
        if mode == "android":
            states[0] = live_android_state(states[0])
        for t in range(1, n + 1):
            state, out = step(states[-1], raw[t])
            states.append(state)
        res[dev.type] = (states, out.cpu())
    (stg, og), (stc, oc) = res[device.type], res["cpu"]
    sg, sc = stg[-1], stc[-1]
    equal = (og == oc).all(dim=-1).float().mean().item()
    out = {"pixels_equal": equal,
           "max_level_diff": int((og.int() - oc.int()).abs().max())}
    if mode == "phaseCorrelate":
        out.update(phase_steps(device, cfg, raw, stg, stc))
        ok = max(out["shift_diff_px"] +
                 out["shift_diff_same_input_px"]) <= PHASE_SHIFT_PX and \
            out["translate_equal"] and out["max_level_diff"] <= 1 and \
            equal >= DENSE_PIXEL_SHARE
    elif mode == "android":
        a, b = og[..., 2] == 255, oc[..., 2] == 255
        out["red_iou"] = ((a & b).sum() / (a | b).sum().clamp(min=1)).item()
        out["red_pixels"] = int(b.sum())
        out["accumulator_equal"] = (sg.accumulator.cpu() ==
                                    sc.accumulator).float().mean().item()
        ok = out["red_iou"] >= ANDROID_IOU and equal >= ANDROID_SHARE and \
            out["accumulator_equal"] >= ANDROID_SHARE and out["red_pixels"]
    else:
        ok = equal >= MODE_PIXEL_SHARE
    if not ok:
        raise AssertionError(f"{mode} on {device} vs CPU: {out}")
    return out


def phase_steps(device, cfg: ModeConfig, raw, states_dev, states_cpu):
    """phaseCorrelate's steps recomputed from the states each device
    carried: step t's shift is ``modes.phase_shift`` of the state it
    started from and its resized frame, and translating that frame by it
    must give the state the step produced (raises otherwise). Returns, per
    step, the CPU's shifts, their distance (px) from the card's own and
    from the card's ``phase_shift`` of the CPU's frames (the same inputs),
    and whether the card's ``translate`` of the CPU's resized frames by
    the CPU's shifts equals the CPU's corrected frames at every step."""
    cpu = torch.device("cpu")
    rows = {}
    for dev, states in ((device, states_dev), (cpu, states_cpu)):
        win = hanning_window(cfg.phase_roi[3], cfg.phase_roi[2], dev)
        rows[dev.type] = []
        for t in range(1, len(states)):
            resized, _ = prep_frame(raw[t].to(dev), cfg, first=True)
            shift = modes.phase_shift(states[t - 1].prev_resized, resized,
                                      cfg.phase_roi, win)
            if not torch.equal(translate(resized, -shift[0], -shift[1]),
                               states[t].prev_resized):
                raise AssertionError(f"phaseCorrelate step {t} on {dev}: "
                                     f"the recomputed shift does not give "
                                     f"the carried state")
            rows[dev.type].append((resized, shift))
    win = hanning_window(cfg.phase_roi[3], cfg.phase_roi[2], device)
    same_input = [
        (modes.phase_shift(states_cpu[t].prev_resized.to(device),
                           r.to(device), cfg.phase_roi, win).cpu() -
         s).abs().max().item()
        for t, (r, s) in enumerate(rows["cpu"])]
    translate_equal = all(
        torch.equal(translate(r.to(device), -s[0].to(device),
                              -s[1].to(device)).cpu(),
                    states_cpu[t + 1].prev_resized)
        for t, (r, s) in enumerate(rows["cpu"]))
    return {"shift_px": [s.tolist() for _, s in rows["cpu"]],
            "shift_diff_px": [(a.cpu() - b).abs().max().item()
                              for (_, a), (_, b) in
                              zip(rows[device.type], rows["cpu"])],
            "shift_diff_same_input_px": same_input,
            "translate_equal": translate_equal}


# ---------------------------------------------------------------------------
# Phase 10: the 1080p detector golden
# ---------------------------------------------------------------------------

def stream_launches(p: FarnebackParams, h, w, frames):
    """The K launches a fused-engine flow stream of preset p makes over
    `frames` frames of h x w (its first frame included): K5 and K6 expand
    every frame at every level; each of the frames - 1 flow steps runs K1
    and K2 once per iteration of each level and K4 at each level
    change."""
    _, it_sched = fb._residual_schedule(h, w, p)
    iters = sum(fb._level_iters(p, it_sched, k)
                for k in range(p.levels + 1))
    steps = frames - 1
    return {"K1": iters * steps, "K2": iters * steps, "K3": 0,
            "K4": p.levels * steps, "K5": (p.levels + 1) * frames,
            "K6": (p.levels + 1) * frames, "K7": 0, "K8": 0}


def detector_golden_1080p(device, frames=48):
    """The port's detector_mask_scan (legacy preset) on the 48-frame
    1920x1080 rip clip against the cv2 oracle mask
    (assets/detector_oracle_1080p_48f_v2.npz), every launch counter set
    to 0 just before the scan. Returns {IoU, mask share, oracle share,
    host ms per frame, launches}; raises below DETECTOR_IOU or when the
    scan's launches differ from ``stream_launches`` (on the card)."""
    clip = make_rip_clip(frames)
    grays = torch.from_numpy(np.ascontiguousarray(clip[..., 0]))
    oracle = torch.from_numpy(np.load(
        ASSETS / "detector_oracle_1080p_48f_v2.npz")["want"]) > 0
    p = FarnebackParams.legacy()
    _sync(device)
    reset_launches()
    t0 = time.perf_counter()
    mask = detector_mask_scan(grays, p, device=device)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3 / (frames - 1)
    launches = launch_counts()
    got = mask.cpu() > 0
    iou = ((got & oracle).sum() / (got | oracle).sum()).item()
    out = {"detector_1080p_iou": iou,
           "detector_1080p_mask_frac": got.float().mean().item(),
           "oracle_mask_frac": oracle.float().mean().item(),
           "host_ms_per_frame": ms, "launches": launches}
    want = stream_launches(p, *grays.shape[1:], frames) \
        if device.type == "cuda" else dict.fromkeys(launches, 0)
    if not iou >= DETECTOR_IOU or launches != want:
        raise AssertionError(f"1080p detector golden (launches expected "
                             f"{want}): {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 11: stabilizeTPU
# ---------------------------------------------------------------------------

# The JAX test's bound on the stabilized clip's residual jitter
# (tests/test_stabilize_vs_akaze.py): below 0.35 x the raw jitter.
STAB_RESIDUAL = 0.35
STAB_MARGIN = 48            # interior the jitter is measured on, px
STAB_FRAMES = 8
# stabilizeTPU at 192x256 on the card vs on the CPU, the CPU's RANSAC
# noise injected. Each step from the CPU's state before it: the four
# frame corners under the two homographies within STAB_H_PX (set from
# the port against JAX on the CPU, which is 5.2e-5 px for an AKAZE step,
# x ~200), inlier counts within STAB_INLIERS of each other, >=
# STAB_PIXEL_SHARE of the corrected pixels equal and at most
# STAB_JUMP_SHARE more than one level apart (a sample crossing the
# frame's edge between the two H; a row and a column are 0.9% of
# 192x256). The chained 3 steps compound the SVDs' last digits (the
# port against JAX: 0.018 px of shift by step 3 with AKAZE): H within
# STAB_CHAIN_H_PX. Readings on an H100 (700 W): forced steps H <= 1.7e-4
# px, inliers equal, >= 99.97% of pixels equal, none two levels apart;
# chained H <= 1.3e-3 px (AKAZE step 3), >= 99.76% equal.
STAB_H_PX = 0.01
STAB_INLIERS = 0.02
STAB_PIXEL_SHARE = 0.99
STAB_JUMP_SHARE = 0.01
STAB_CHAIN_H_PX = 0.05


def stab_clip(frames, h=480, w=640, seed=0):
    """``synthetic.make_jittered_clip`` with frames + 1 frames at (h, w),
    its blob count scaled from the JAX test's 150 at 240x320."""
    return make_jittered_clip(np.random.default_rng(seed), h, w, frames + 1,
                              blobs=round(150 * h * w / (240 * 320)))


def residual_jitter(frames, device, margin=STAB_MARGIN) -> float:
    """Mean |phase-correlation shift| (px) between consecutive frames of
    (T, H, W, 3) uint8 BGR frames, on their gray interiors (`margin` px
    in from each edge, Hann window), with the port's
    ``flow/phasecorr.phase_correlate``."""
    t = (frames if torch.is_tensor(frames) else
         torch.from_numpy(np.asarray(frames))).to(device)
    h, w = t.shape[1:3]
    g = img_ops.bgr_to_gray(t)[:, margin:h - margin,
                               margin:w - margin].to(torch.float32)
    win = hanning_window(h - 2 * margin, w - 2 * margin, device)
    shifts = [torch.linalg.vector_norm(phase_correlate(g[i - 1], g[i],
                                                       win).shift)
              for i in range(1, g.shape[0])]
    return torch.stack(shifts).mean().item()


def top_kernels(kern, per, n=5):
    """The n device kernels of a trace's CUDA events `kern` that take the
    most time: [(name, us per `per`, launches per `per`)]."""
    by = {}
    for e in kern:
        t, c = by.get(e.name, (0.0, 0))
        by[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:n]
    return [(k[:60], round(t / per, 2), c / per) for k, (t, c) in top]


def host_syncs(fn) -> list:
    """The operations that made the host wait for the card during fn():
    torch's sync debug mode's warnings, one message each (empty off the
    card)."""
    if not torch.cuda.is_available():
        fn()
        return []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [str(w.message).split("\n")[0][:80] for w in caught
            if "synchroniz" in str(w.message)]


def run_stabilize(device, features, frames=STAB_FRAMES, traced=2,
                  hw=(480, 640)):
    """stabilizeTPU at `hw` (640x480) through ``run_frames`` on a
    jittered clip (``stab_clip``), every launch counter set to 0 just
    before; then
    `traced` more steps under torch.profiler. Returns host ms per frame,
    launches per frame, device ms and kernels per traced frame, the
    device's busy share (traced device time / untraced host time) and the
    raw and output residual jitter; raises unless K8 runs once a frame
    and no other K kernel runs, or on a residual of STAB_RESIDUAL x the
    raw jitter or more."""
    clip, _ = stab_clip(frames + traced + 1, *hw)
    cfg = ModeConfig(xdim=hw[1], ydim=hw[0], stab_features=features)
    list(runner.run_frames("stabilizeTPU", clip[:3], cfg, device))
    _sync(device)
    reset_launches()
    stats = runner.RunStats()
    outs = list(runner.run_frames("stabilizeTPU", clip[:frames + 1], cfg,
                                  device, stats))
    launches = {k: v / frames for k, v in launch_counts().items()}
    host_ms = stats.seconds * 1e3 / stats.frames
    init, step = MODES["stabilizeTPU"](cfg, device=device)
    state = init(clip[frames])
    _sync(device)

    def steps():
        st = state
        for t in range(frames + 1, frames + traced + 1):
            st, _ = step(st, clip[t])
        _sync(device)
    kern = device_events(steps, cpu=True)
    dev_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / traced
    syncs = host_syncs(lambda: step(state, clip[frames + traced]))
    out = torch.stack(outs)
    res = {"host_ms_per_frame": host_ms, "launches_per_frame": launches,
           "device_ms_per_frame": dev_ms,
           "device_kernels_per_frame": len(kern) / traced,
           "busy_share": dev_ms / host_ms,
           "host_syncs_per_frame": len(syncs), "syncs": sorted(set(syncs)),
           "top_kernels_us_per_frame": top_kernels(kern, traced),
           "raw_jitter_px": residual_jitter(clip[:frames + 1], device),
           "output_jitter_px": residual_jitter(
               torch.cat([torch.as_tensor(clip[:1]).to(device), out]),
               device)}
    want = dict.fromkeys(launches, 0.0)
    if device.type == "cuda":
        want["K8"] = 1.0
    if launches != want or out.dtype != torch.uint8 or \
            tuple(out.shape[1:]) != (cfg.ydim, cfg.xdim, 3) or \
            not res["output_jitter_px"] < STAB_RESIDUAL * \
            res["raw_jitter_px"]:
        raise AssertionError(f"stabilizeTPU ({features}): launches per "
                             f"frame expected {want}; {res}")
    return res


@contextlib.contextmanager
def _patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


def _corner_px(h_a, h_b, h, w) -> float:
    """Largest distance (px) between the images of the frame's four
    corners under two homographies."""
    c = np.float64([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]])
    pa = c @ np.float64(h_a).T
    pb = c @ np.float64(h_b).T
    return float(np.abs(pa[:, :2] / pa[:, 2:] - pb[:, :2] / pb[:, 2:]).max())


def compare_stabilize_small(device, features, n=3):
    """stabilizeTPU at 192x256 on `device` against the CPU over n frames
    of a jittered clip, the CPU's RANSAC noise injected into the card's
    steps (``feature_stab.gumbel_noise``): each step from the CPU's state
    before it, and the n steps chained on each side. Per step: the
    frame-corner distance between the two H, both inlier counts, the
    share of equal pixels and of pixels more than one level apart.
    Raises past the STAB_* limits."""
    cfg = ModeConfig(xdim=256, ydim=192, stab_features=features)
    clip, _ = stab_clip(n, 192, 256, seed=7)
    cpu = torch.device("cpu")
    noises, pairs, feed = [], [], []
    real_noise, real_pair = feature_stab.gumbel_noise, modes.stabilize_pair

    def rec_noise(g, t, k, d):
        z = real_noise(g, t, k, d)
        noises.append(z.cpu())
        return z

    def rec_pair(*a, **kw):
        out = real_pair(*a, **kw)
        pairs.append((out[1].cpu().numpy(), int(out[2])))
        return out

    with _patched(feature_stab, "gumbel_noise", rec_noise), \
            _patched(modes, "stabilize_pair", rec_pair):
        init, step = MODES["stabilizeTPU"](cfg, device=cpu)
        states, outs = [init(clip[0])], []
        for t in range(1, n + 1):
            st, o = step(states[-1], clip[t])
            states.append(st)
            outs.append(o)
    want = list(pairs)
    runs = {}
    with _patched(feature_stab, "gumbel_noise",
                  lambda g, t, k, d: feed.pop(0)), \
            _patched(modes, "stabilize_pair", rec_pair):
        init, step = MODES["stabilizeTPU"](cfg, device=device)
        pairs.clear()
        got = []
        for t in range(1, n + 1):
            feed[:] = [noises[t - 1].to(device)]
            st = modes.StabilizeState(states[t - 1].prev_gray.to(device),
                                      states[t - 1].framecount.to(device))
            got.append(step(st, clip[t])[1].cpu())
        runs["forced"] = (got, list(pairs))
        pairs.clear()
        feed[:] = [z.to(device) for z in noises]
        st, got = init(clip[0]), []
        for t in range(1, n + 1):
            st, o = step(st, clip[t])
            got.append(o.cpu())
        runs["chained"] = (got, list(pairs))
    res = {}
    for name, (got, got_pairs) in runs.items():
        rows = []
        for o, oc, (hg, ng), (hc, nc) in zip(got, outs, got_pairs, want):
            d = (o.int() - oc.int()).abs().amax(-1)
            rows.append({"h_px": _corner_px(hg, hc, 192, 256),
                         "inliers": (ng, nc),
                         "equal": (d == 0).float().mean().item(),
                         "jump": (d > 1).float().mean().item()})
        res[name] = rows
    bad = [r for r in res["forced"]
           if r["h_px"] > STAB_H_PX or r["equal"] < STAB_PIXEL_SHARE or
           r["jump"] > STAB_JUMP_SHARE or r["inliers"][1] < 8 or
           abs(r["inliers"][0] - r["inliers"][1]) >
           STAB_INLIERS * r["inliers"][1]]
    bad += [r for r in res["chained"] if r["h_px"] > STAB_CHAIN_H_PX]
    if bad:
        raise AssertionError(f"stabilizeTPU ({features}) on {device} vs "
                             f"CPU: {res}")
    return res


# ---------------------------------------------------------------------------
# Phase 12: the benchmark mode's work (dense LK against Farneback)
# ---------------------------------------------------------------------------

# The CLI's benchmark preset (JAX cli.py:283: main.cpp's streamlines
# call, the fused engine).
BENCH_FB = FarnebackParams(0.5, 2, 3, 2, 15, 1.2, True)
# dense_lk on the card vs on the CPU at 192x256: the banded window sums
# are matrix products summed in cuBLAS's order and the CPU's, and a pixel
# on the edge of a stopping rule (|delta|^2 <= eps^2, the oscillation
# test) can stop one iteration apart, a step of up to ~eps (0.01 px).
# Limits chosen before the first reading: max DENSE_LK_MAX_PX, median
# DENSE_LK_MEDIAN_PX, status equal on >= DENSE_LK_STATUS of pixels. The
# reading on an H100 (700 W): max 1.3e-6 px, median 2.4e-7 px, status
# equal everywhere.
DENSE_LK_MAX_PX = 0.05
DENSE_LK_MEDIAN_PX = 1e-4
DENSE_LK_STATUS = 0.999


def benchmark_work(device):
    """The CLI's benchmark mode's work (JAX cli.py:263-300) on one 640x480
    frame pair made from 1280x720 moving-texture frames: ``farneback``
    with BENCH_FB and ``dense_lk`` with ``LKParams.dense_grid()``, each a
    warm call and then a timed call ended by a device sync, every launch
    counter set to 0 just before the timed call; then one traced
    dense_lk call (device ms, kernels, busy share). Raises unless the
    timed dense_lk launched K8 30 times a level (120) and no other K
    kernel, and Farneback none of K3, K7, K8."""
    raw = moving_frames(2, RAW_H, RAW_W, device)
    cfg = ModeConfig()
    _, g1 = prep_frame(raw[0], cfg, first=True)
    _, g2 = prep_frame(raw[1], cfg)
    p = LKParams.dense_grid()
    calls = {"farneback": lambda: fb.farneback(g2, g1, BENCH_FB),
             "dense_lk": lambda: dense_lk(g1, g2, p)}
    res = {}
    for name, fn in calls.items():
        fn()
        _sync(device)
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        res[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                     "launches": launch_counts()}
    flow, status = out
    kern = device_events(lambda: (calls["dense_lk"](), _sync(device)),
                         cpu=True)
    dev_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    lk_res = res["dense_lk"]
    lk_res.update(device_ms=dev_ms, device_kernels=len(kern),
                  busy_share=dev_ms / lk_res["ms"],
                  host_syncs=len(host_syncs(calls["dense_lk"])),
                  top_kernels_us=top_kernels(kern, 1),
                  status_share=status.float().mean().item(),
                  mean_flow=flow[status].mean(0).tolist())
    levels = len(dense_lk_shapes(480, 640, p))
    want = dict.fromkeys(lk_res["launches"], 0)
    if device.type == "cuda":
        want["K8"] = p.max_iters * levels
    fb_n = res["farneback"]["launches"]
    if lk_res["launches"] != want or fb_n["K3"] or fb_n["K7"] or \
            fb_n["K8"] or not torch.isfinite(flow).all() or \
            lk_res["status_share"] < 0.5:
        raise AssertionError(f"benchmark work (dense_lk launches expected "
                             f"{want}): {res}")
    return res


def compare_dense_lk_small(device):
    """dense_lk at 192x256 (4 levels) on `device` against the CPU on the
    same frames: max and median |d| px of the flow, status agreement;
    raises past the DENSE_LK_* limits."""
    g = moving_frames(2, 192, 256, torch.device("cpu"), color=False)
    p = LKParams.dense_grid()
    fc, sc = dense_lk(g[0], g[1], p)
    fg, sg = dense_lk(g[0].to(device), g[1].to(device), p)
    d = (fg.cpu() - fc).abs().amax(-1)
    res = {"max_px": d.max().item(), "median_px": d.median().item(),
           "status_equal": (sg.cpu() == sc).float().mean().item(),
           "status_share": sc.float().mean().item()}
    if res["max_px"] > DENSE_LK_MAX_PX or \
            res["median_px"] > DENSE_LK_MEDIAN_PX or \
            res["status_equal"] < DENSE_LK_STATUS:
        raise AssertionError(f"dense_lk on {device} vs CPU: {res}")
    return res


def check_lagged(device, flows=4):
    """``farneback_stream_lagged`` against ``farneback_stream`` on
    `device` (BENCH_FB, 640x480 moving texture) over `flows` flows: the
    same flows, value for value, or raises."""
    f = moving_frames(flows + 2, 480, 640, device, color=False)
    carry = (fb.farneback_precompute(f[0], BENCH_FB),
             fb.farneback_precompute(f[1], BENCH_FB))
    exp = carry[0]
    out = []
    for i in range(2, flows + 2):
        lag, carry = fb.farneback_stream_lagged(carry, f[i], BENCH_FB)
        ref, exp = fb.farneback_stream(exp, f[i - 1], BENCH_FB)
        out.append((lag - ref).abs().max().item())
    if any(out):
        raise AssertionError(f"farneback_stream_lagged on {device}: max "
                             f"|d| per flow {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the CLI and run_video
# ---------------------------------------------------------------------------

# Scratch files of phase 13 (metrics JSON, checkpoints, traces), inside
# the checkout (build/ is not committed).
CLI_TMP = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
# validate's orbit on the card against the CPU's, each of its 3501 radii.
ORBIT_PX = 1e-3
# The legacy step's launches a frame ([3]); each run also expands its
# first frame once (K5, K6).
LEGACY_PER_FRAME = {"K1": 6, "K2": 6, "K3": 0, "K4": 2, "K5": 3, "K6": 3,
                    "K7": 0, "K8": 0}


@contextlib.contextmanager
def memory_video(clips: dict):
    """Put in-memory stand-ins where the port looks up its video reader
    and writer (``io/video.py``): the card's machine has no OpenCV, so it
    can neither decode nor encode. `clips` maps an input path to a list
    of (H, W, 3) uint8 BGR numpy frames. Yields {output path: [frames
    written]}. The writer keeps the arrays it is handed, not copies, as
    the real writer's queue does until it encodes them: a runner that
    reused a buffer its writer still held would change what was
    written."""
    written = {}

    class Reader:
        fps = 30.0

        def __init__(self, path):
            if path not in clips:
                raise FileNotFoundError(f"no in-memory clip {path!r}")
            self.frames = clips[path]

        @property
        def frame_count(self):
            return len(self.frames)

        @property
        def size(self):
            return self.frames[0].shape[:2]

        def __iter__(self):
            return iter(self.frames)

        def close(self):
            pass

    class Writer:
        def __init__(self, path, fps, size_hw, fourcc=None):
            self.size_hw = tuple(size_hw)
            self.frames = written[path] = []

        def write(self, frame):
            if frame.shape != (*self.size_hw, 3) or frame.dtype != np.uint8:
                raise AssertionError(f"writer of {self.size_hw} got "
                                     f"{frame.dtype} {frame.shape}")
            self.frames.append(frame)

        def write_batch(self, frames):
            for f in frames:
                self.write(f)

        def close(self):
            pass

    with _patched(io_video, "VideoReader", Reader), \
            _patched(io_video, "VideoWriter", Writer):
        yield written


def trace_totals(path) -> dict:
    """The device kernels' total ms and the bytes of each device-to-host
    copy in the Chrome trace at `path` (``device_events``)."""
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    d2h = []
    for e in events:
        if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", ""):
            if "bytes" not in e.get("args", {}):
                raise AssertionError(f"a device-to-host copy without its "
                                     f"size in the trace: {e}")
            d2h.append(int(e["args"]["bytes"]))
    return {"device_ms": sum(e["dur"] for e in events
                             if e.get("cat") == "kernel") / 1e3,
            "d2h_bytes": d2h}


def cli_run(argv, clips, trace=False):
    """``cli.main(argv + --metrics-json)`` on in-memory video, its printout
    captured, every launch counter set to 0 just before; with `trace`
    on the card, inside a profiler session (``device_events``) whose
    Chrome trace ``trace_totals`` reads. Raises unless it exits 0.
    -> {"written": {path: (n, H, W, 3) array}, "metrics": the metrics
    JSON or None, "launches", "stdout", "trace": dict or None}."""
    CLI_TMP.mkdir(parents=True, exist_ok=True)
    metrics = CLI_TMP / "metrics.json"
    metrics.unlink(missing_ok=True)
    out = io.StringIO()

    def call():
        reset_launches()
        with contextlib.redirect_stdout(out):
            rc = cli.main([*argv, "--metrics-json", str(metrics)])
        return rc, launch_counts()

    with memory_video(clips) as written:
        if trace and torch.cuda.is_available():
            path, got = CLI_TMP / "trace.json", []
            device_events(lambda: (got.append(call()),
                                   _sync(torch.device("cuda"))),
                          chrome_trace=path)
            (rc, launches), trace = got[-1], trace_totals(path)
        else:
            (rc, launches), trace = call(), None
    if rc != 0:
        raise AssertionError(f"cli.main({argv}) exited {rc}:\n"
                             f"{out.getvalue()[-2000:]}")
    return {"written": {k: np.stack(v) for k, v in written.items()},
            "metrics": json.loads(metrics.read_text())
            if metrics.exists() else None,
            "launches": launches, "stdout": out.getvalue(), "trace": trace}


def _only(written: dict) -> np.ndarray:
    if len(written) != 1:
        raise AssertionError(f"expected one output stream: {list(written)}")
    return next(iter(written.values()))


def check_pump(device, n=8, hw=(480, 640), raw_hw=(RAW_H, RAW_W)):
    """[13a] The frame pump (``io/native.py``) built from
    ``native/framepump.cpp`` on this host, on n 1280x720 moving-texture
    frames resized to 640x480 (`raw_hw`, `hw`), against the port's device
    ``resize_bilinear`` of the same frames: within one level everywhere,
    and equal to the device's float resize rounded half up at every
    pixel (the pump rounds ties up as cv2 does; ``resize_bilinear`` rounds
    them to even, as the JAX package's does). Its gray equals
    ``bgr_to_gray`` of its resized frames bit for bit. Raises otherwise."""
    t0 = time.perf_counter()
    if not io_native.available():
        raise AssertionError("the frame pump did not build (no g++?)")
    build_s = time.perf_counter() - t0
    raw = moving_frames(n, *raw_hw, torch.device("cpu")).numpy()
    pump = io_native.FramePump(raw_hw, hw, threads=2, capacity=n)
    t0 = time.perf_counter()
    for f in raw:
        pump.push(f)
    pump.close()
    resized, gray = pump.pop_batch(n)
    pump_ms = (time.perf_counter() - t0) * 1e3 / n
    if len(resized) != n:
        raise AssertionError(f"the pump delivered {len(resized)} of {n}")
    frames = torch.from_numpy(raw).to(device)
    dev_u8 = torch.stack([img_ops.resize_bilinear(f, hw) for f in frames])
    dev_f = torch.stack([img_ops.resize_bilinear(f.float(), hw)
                         for f in frames])
    mine = torch.from_numpy(resized).to(device)
    d = (mine.int() - dev_u8.int()).abs()
    res = {"build_s": round(build_s, 2),
           "ms_per_frame_2_threads": round(pump_ms, 3),
           "max_level": int(d.max()),
           "equal_pixel_share": float((d == 0).all(-1).float().mean()),
           "equal_to_float_half_up": bool(
               (mine.float() == torch.floor(dev_f + 0.5)).all()),
           "gray_equal": bool((img_ops.bgr_to_gray(mine) ==
                               torch.from_numpy(gray).to(device)).all())}
    if res["max_level"] > 1 or not res["equal_to_float_half_up"] or \
            not res["gray_equal"]:
        raise AssertionError(f"frame pump vs the device resize: {res}")
    return res


def alternated(device, mode, raw, dims):
    """`mode` over the in-memory clip `raw` by ``run_frames`` (A) and by
    ``cli.main`` without (B) and with (C) the frame pump, in the order A B
    C C B A (host clocks of one process vary by tens of percent), all
    with the CLI's own ModeConfig. B's first frames must equal A's first
    outputs bit for bit, or it raises. -> {"run_frames": [ms/frame, ...],
    "no host prep": [CLI run, ...], "pump": [CLI run, ...]}."""
    argv = ["clip.mem", str(CLI_TMP / mode), "--mode", mode, *dims]
    cfg = cli._mode_config(cli.build_parser().parse_args(argv))
    runs = {"run_frames": [], "no host prep": [], "pump": []}
    ref = []

    def frames_run():
        stats = runner.RunStats()
        outs = list(runner.run_frames(mode, raw, cfg, device=device,
                                      stats=stats))
        if not ref:
            ref.append(torch.stack(outs).cpu().numpy())
        return stats.seconds * 1e3 / stats.frames

    calls = {"run_frames": frames_run,
             "no host prep": lambda: cli_run(argv + ["--no-host-prep"],
                                             {"clip.mem": raw}),
             "pump": lambda: cli_run(argv, {"clip.mem": raw})}
    for name in ("run_frames", "no host prep", "pump", "pump",
                 "no host prep", "run_frames"):
        runs[name].append(calls[name]())
    got = _only(runs["no host prep"][0]["written"])
    if got.shape != ref[0].shape or not np.array_equal(got, ref[0]):
        raise AssertionError(f"{mode}: cli.main's frames {got.shape} differ "
                             f"from run_frames' {ref[0].shape}")
    return runs


def _ms_per_frame(timed) -> dict:
    return {name: [round(r if isinstance(r, float) else
                         r["metrics"]["seconds"] * 1e3 / r["metrics"]["frames"],
                         3) for r in runs] for name, runs in timed.items()}


def _summary(run, traced_run=None) -> dict:
    """What [13] prints of a CLI run: fps, seconds and stage seconds from
    its metrics, the seconds outside every stage (mostly the loop waiting
    for decode or the pump); device ms, busy share and device-to-host
    bytes a frame of `traced_run`, each from that run's own trace and
    metrics (the busy share is its device ms over its own seconds, the
    profiler's cost included)."""
    m = run["metrics"]
    res = {"fps": m["fps"], "seconds": m["seconds"],
           "stages_s": m["stages_s"],
           "outside_stages_s": round(m["seconds"] -
                                     sum(m["stages_s"].values()), 4)}
    t = (traced_run or {}).get("trace")
    if t is not None:
        tm = traced_run["metrics"]
        res.update(device_ms=round(t["device_ms"], 3),
                   traced_seconds=tm["seconds"],
                   busy_share=round(t["device_ms"] / 1e3 / tm["seconds"], 4),
                   d2h_bytes_per_frame=sum(t["d2h_bytes"]) / tm["frames"])
    return res


def _launches(device, want: dict) -> dict:
    """`want`, or every count 0 off the card (the plain versions count
    no launch)."""
    return want if device.type == "cuda" else dict.fromkeys(want, 0)


def resume_check(device, mode, raw, every, cut, extra=()):
    """[13f] Kill and resume: ``cli.main`` for `mode` over the whole clip,
    then cut with --max-frames `cut` and --checkpoint-every `every`, then
    --resume from its checkpoint. The cut run's frames equal the whole
    run's first `cut`, and the resumed run's equal the whole run's from
    the checkpoint on, bit for bit. -> the frame the checkpoint holds."""
    ckpt = CLI_TMP / f"{mode}.ckpt"
    base = ["clip.mem", str(CLI_TMP / mode), "--mode", mode, *extra]
    clips = {"clip.mem": raw}
    full = _only(cli_run(base, clips)["written"])
    part1 = _only(cli_run(base + ["--checkpoint-every", str(every),
                                  "--max-frames", str(cut), "--checkpoint",
                                  str(ckpt)], clips)["written"])
    done = load_meta(str(ckpt))["processed"]
    part2 = _only(cli_run(base + ["--resume", f"{ckpt}.npz"],
                          clips)["written"])
    if not (np.array_equal(part1, full[:cut]) and
            np.array_equal(part2, full[done:])):
        raise AssertionError(f"{mode}: kill at {cut} and resume from "
                             f"{done} differ from the whole run")
    return {"frames": len(full), "cut": len(part1), "checkpoint": done,
            "resumed": len(part2)}


def cli_phase(device, hw=(480, 640), raw_hw=(RAW_H, RAW_W)):
    """[13] The port's CLI and ``run_video`` on the card, on in-memory
    video (``memory_video``) at `hw` (640x480) from `raw_hw` (1280x720)
    frames: the frame pump, legacy and timelines through ``cli.main``
    against ``run_frames``, the gray upload against the BGR one, no
    download without output, kill and resume, and the special modes.
    Returns what main prints; raises on any failure."""
    h, w = hw
    dims = ["--xdim", str(w), "--ydim", str(h), "--device", device.type]
    res = {"pump": check_pump(device, hw=hw, raw_hw=raw_hw)}
    raw = list(moving_frames(FRAMES + 1, *raw_hw,
                             torch.device("cpu")).numpy())
    clips = {"clip.mem": raw}
    want = _launches(device, {k: v * FRAMES + 3 * (k in ("K5", "K6"))
                              for k, v in LEGACY_PER_FRAME.items()})
    argv = ["clip.mem", str(CLI_TMP / "legacy"), "--mode", "legacy", *dims]
    timed = alternated(device, "legacy", raw, dims)
    no_prep_t = cli_run(argv + ["--no-host-prep"], clips, trace=True)
    pumped_t = cli_run(argv, clips, trace=True)
    for r, pump in ((timed["no host prep"][-1], False), (no_prep_t, False),
                    (timed["pump"][-1], True), (pumped_t, True)):
        if r["launches"] != want or r["metrics"]["frames"] != FRAMES or \
                r["metrics"]["native_host_prep"] != pump:
            raise AssertionError(f"legacy through cli.main: launches "
                                 f"{r['launches']} (expected {want}), "
                                 f"metrics {r['metrics']}")
    res["legacy"] = {
        "ms_per_frame": _ms_per_frame(timed),
        "no host prep": _summary(timed["no host prep"][-1], no_prep_t),
        "pump": _summary(timed["pump"][-1], pumped_t),
        "launches_per_frame": {k: v / FRAMES for k, v in want.items()}}
    timed = alternated(device, "timelines", raw, dims)
    tl = timed["no host prep"][-1]
    if tl["launches"]["K3"] != _launches(device, {"K3": FRAMES})["K3"]:
        raise AssertionError(f"timelines: launches {tl['launches']}")
    res["timelines"] = {"ms_per_frame": _ms_per_frame(timed),
                        "no host prep": _summary(tl),
                        "pump": _summary(timed["pump"][-1]),
                        "k3_per_frame": tl["launches"]["K3"] / FRAMES}

    at_size = list(moving_frames(9, h, w, torch.device("cpu")).numpy())
    argv = ["clip.mem", str(CLI_TMP / "gray"), "--mode",
            "subtructAverageVector", *dims]
    gray = cli_run(argv, {"clip.mem": at_size})
    with _patched(runner, "GRAY_INPUT", frozenset()):
        bgr = cli_run(argv, {"clip.mem": at_size})
    if not gray["metrics"]["gray_upload"] or bgr["metrics"]["gray_upload"] \
            or not np.array_equal(_only(gray["written"]),
                                  _only(bgr["written"])):
        raise AssertionError("subtructAverageVector: the gray upload's "
                             "frames differ from the BGR upload's")
    res["gray_upload"] = {"frames": len(_only(gray["written"])),
                          "equal": True}

    quiet = cli_run(["clip.mem", "--mode", "legacy", "--no-output",
                     "--no-host-prep", *dims], clips, trace=True)
    copies = (quiet["trace"] or {}).get("d2h_bytes", [])
    biggest = max(copies, default=0)
    if quiet["metrics"]["output_download"] or quiet["written"] or \
            biggest >= h * w:
        raise AssertionError(f"--no-output downloaded: largest "
                             f"device-to-host copy {biggest} B, metrics "
                             f"{quiet['metrics']}")
    res["no_output"] = dict(_summary(quiet, quiet), largest_d2h_bytes=biggest,
                            d2h_copies=len(copies))

    stab = list(stab_clip(STAB_FRAMES - 1, h, w)[0])
    res["resume"] = {
        "legacy": resume_check(device, "legacy", raw, 16, 24, dims),
        "stabilizeTPU (harris)": resume_check(
            device, "stabilizeTPU", stab, 4, 4,
            ("--stab-features", "harris", *dims))}

    pair = {"pair.mem": raw[:2]}
    bench = cli_run(["pair.mem", "--mode", "benchmark", *dims], pair)
    lines = bench["stdout"].strip().splitlines()
    if len(lines) != 2 or not lines[0].startswith("farneback ") or \
            not lines[1].startswith(f"lk (dense grid, {h * w} points)") \
            or bench["launches"]["K8"] != _launches(device,
                                                    {"K8": 240})["K8"]:
        raise AssertionError(f"benchmark: {lines}, launches "
                             f"{bench['launches']} (a warm and a timed "
                             f"dense_lk call, 120 K8 each)")
    res["benchmark"] = {"lines": lines,
                        "k8_per_dense_lk_call": bench["launches"]["K8"] / 2}
    val = cli_run(["pair.mem", "--mode", "validate", *dims], pair)
    r_card = cli.validate_orbit(h, w, device)
    r_cpu = cli.validate_orbit(h, w, torch.device("cpu"))
    drift = abs(r_card[-1] - r_card[0]) / r_card[0]
    gap = float(np.abs(r_card - r_cpu).max())
    if drift >= 0.05 or gap > ORBIT_PX:
        raise AssertionError(f"validate: drift {drift}, radii {gap} px from "
                             f"the CPU's")
    res["validate"] = {"line": val["stdout"].strip(),
                       "radii_max_px_from_cpu": gap}
    full = cli_run(["clip.mem", "--mode", "legacy-full", "--max-frames",
                    "8", *dims], {"clip.mem": raw[:9]})["written"]
    got = {k: v.shape for k, v in full.items()}
    want = {f"{stem}.mp4": (8,) + ((min(hw),) * 2 if field ==
                                   "hist_wheel_bgr" else hw) + (3,)
            for field, stem in cli.LEGACY_STREAMS.items()}
    if got != want:
        raise AssertionError(f"legacy-full wrote {got}, expected {want}")
    res["legacy_full"] = got
    return res


# ---------------------------------------------------------------------------
# Phase 14: the multi-device layer
# ---------------------------------------------------------------------------

PHASE14_TMP = CLI_TMP / "phase14"
RANK_TIMEOUT_S = 300
# tests/test_spatial.py's bounds on the spatial flow against one process's
# farneback: interior rows (all but the 64 outermost of each edge) median,
# mean and share above 0.1 px; the 64 outermost rows of each edge, mean.
SPATIAL_BOUNDS = {"interior_median_px": 1e-4, "interior_mean_px": 0.01,
                  "interior_share_above_0.1px": 0.01, "border_mean_px": 0.1}
SPATIAL_EDGE = 64
# [14b]'s engines: the tiled engine (K5, K6, K8) at tests/test_spatial.py's
# preset (windowed() at levels=1), the fused engine (K5, K6, K1, K2, K4)
# at the full windowed() preset.
SPATIAL_ENGINES = {
    "tiled": dataclasses.replace(FarnebackParams.windowed(), levels=1,
                                 warp_impl="tiled"),
    "fused": FarnebackParams.windowed()}
SPATIAL_KERNELS = {"tiled": ("K5", "K6", "K8"),
                   "fused": ("K1", "K2", "K4", "K5", "K6", "K1b")}
K_ROWS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")


def _stream_clips(n, frames, raw_hw, seed0):
    """n distinct in-memory clips of `frames` 1280x720 (`raw_hw`)
    moving-texture frames, one seed each: {name: [frames]}."""
    return {f"s{seed0 + i}.mem": list(moving_frames(
        frames, *raw_hw, torch.device("cpu"), seed=seed0 + i).numpy())
        for i in range(n)}


def _spawn_ranks(target, args, n=2, timeout=RANK_TIMEOUT_S):
    """target(rank, *args) in n spawned processes (each re-imports this
    file as __mp_main__ and runs no main()). Raises unless every rank
    exits 0 within `timeout` seconds; kills and reaps any rank left."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args)) for r in range(n)]
    for p in procs:
        p.start()
    try:
        deadline = time.perf_counter() + timeout
        for p in procs:
            p.join(max(deadline - time.perf_counter(), 1.0))
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise AssertionError(f"{target.__name__}: rank exit codes "
                                 f"{codes} (None: still running at "
                                 f"{timeout} s)")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()


def spatial_frames(hw, device, seed=0):
    """[14b]'s pair: two gray moving-texture frames (2 px drift under
    moving wave bands) of `hw`, made from `seed` on `device`."""
    return tuple(moving_frames(2, *hw, device, seed=seed, color=False))


def spatial_rank(rank, out, device_type, hw, halo, reps, seed):
    """[14b] one of 2 ranks: join a gloo group through a file:// store,
    make the frame pair from `seed`, take this rank's row band and run
    farneback_spatial on each engine of SPATIAL_ENGINES (a warm call,
    then `reps` timed calls, each ended by a device sync, the ranks
    started together by a barrier); time the halo exchange alone. Writes
    spatial_<rank>.json and its band's flows <engine>_<rank>.npy."""
    torch.set_num_threads(1)
    out = pathlib.Path(out)
    dev = torch.device(device_type)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{out / 'spatial.store'}",
        world_size=2, rank=rank)
    try:
        m = pmesh.make_mesh(2, space=2, backend="gloo")
        a, b = (pmesh.shard_streams(m, f[None])[0]
                for f in spatial_frames(hw, dev, seed))
        res = {"band": list(a.shape), "coords": m.coords}
        for name, p in SPATIAL_ENGINES.items():
            flow = spatial.farneback_spatial(a, b, p, m, halo)
            _sync(dev)
            reset_all_launches()
            torch.distributed.barrier()
            t0 = time.perf_counter()
            for _ in range(reps):
                flow = spatial.farneback_spatial(a, b, p, m, halo)
                _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3 / reps
            res[name] = {"ms_per_pair": ms,
                         "launches_per_pair": {k: v / reps for k, v in
                                               all_launch_counts().items()}}
            np.save(out / f"{name}_{rank}.npy", flow.cpu().numpy())
        x = torch.stack([a, b])
        times = []
        for _ in range(reps + 1):
            torch.distributed.barrier()
            t0 = time.perf_counter()
            spatial.exchange_rows(m, x, min(2 * halo, a.shape[0]))
            times.append((time.perf_counter() - t0) * 1e3)
        res["exchange_ms"] = sorted(times[1:])
        (out / f"spatial_{rank}.json").write_text(json.dumps(res))
    finally:
        torch.distributed.destroy_process_group()


def _spatial_readings(got, want, edge=SPATIAL_EDGE) -> dict:
    d = torch.sqrt(((got - want) ** 2).sum(-1))
    di = d[edge:-edge]
    return {"interior_median_px": float(di.median()),
            "interior_mean_px": float(di.mean()),
            "interior_share_above_0.1px": float((di > 0.1).float().mean()),
            "border_mean_px": float(torch.cat([d[:edge], d[-edge:]]).mean())}


def spatial_phase(device, hw=(1080, 1920), halo=128, reps=5, seed=0):
    """[14b] farneback_spatial on 2 ranks sharing the card (gloo 'space'
    group; the kernels are built in this process beforehand), against
    this process's farneback on the same pair: both engines held to
    SPATIAL_BOUNDS. Each rank's launches must show its engine's kernels
    (off the card: none)."""
    out = PHASE14_TMP
    out.mkdir(parents=True, exist_ok=True)
    (out / "spatial.store").unlink(missing_ok=True)
    _spawn_ranks(spatial_rank, (str(out), device.type, hw, halo, reps,
                                seed))
    ranks = [json.loads((out / f"spatial_{r}.json").read_text())
             for r in range(2)]
    prev, nxt = spatial_frames(hw, device, seed)
    res = {"ranks": ranks}
    for name, p in SPATIAL_ENGINES.items():
        got = torch.cat([torch.from_numpy(np.load(out / f"{name}_{r}.npy"))
                         for r in range(2)]).to(device)
        want = fb.farneback(prev.float(), nxt.float(), p)
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"spatial {name}: {tuple(got.shape)}")
        res[name] = _spatial_readings(got, want)
        for r in ranks:
            n = r[name]["launches_per_pair"]
            if any((n[k] > 0) != (device.type == "cuda" and
                                  k in SPATIAL_KERNELS[name]) for k in n):
                raise AssertionError(f"spatial {name}: launches {n}")
    for name in SPATIAL_ENGINES:
        bad = {k: v for k, v in res[name].items()
               if v >= SPATIAL_BOUNDS[k]}
        if bad:
            raise AssertionError(f"spatial {name} engine against one "
                                 f"process: {bad} (bounds "
                                 f"{SPATIAL_BOUNDS})")
    return res


def farm_rank(rank, port, out, device_type, hw, raw_hw, frames):
    """[14c] one of 2 processes of a stream farm: ``cli.main`` with its own
    two legacy clips and --coordinator 127.0.0.1:<port>; then the farm
    helpers. Raises unless the mesh is (stream 2, space 1), this rank owns
    row `rank` of it, all_streams_fps equals the sum of both processes'
    metrics fps and the launches are 2 streams' worth. Writes
    farm_<rank>.json."""
    torch.set_num_threads(1)
    out = pathlib.Path(out)
    h, w = hw
    clips = _stream_clips(2, frames + 1, raw_hw, 20 + 2 * rank)
    metrics = out / f"farm_metrics_{rank}.json"
    argv = [str(out / f"farm{rank}"), "--videos", *clips, "--mode",
            "legacy", "--no-host-prep", "--xdim", str(w), "--ydim", str(h),
            "--device", device_type, "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "2", "--process-id", str(rank),
            "--metrics-json", str(metrics)]
    reset_launches()
    with memory_video(clips) as written, \
            contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv)
    launches = launch_counts()
    try:
        if rc != 0:
            raise AssertionError(f"farm rank {rank}: cli.main exited {rc}")
        m = pdist.global_stream_mesh(1)
        sl = pdist.local_stream_slice(m)
        mine = json.loads(metrics.read_text())
        total = pdist.all_streams_fps(mine["aggregate_fps"])
        both = [json.loads((out / f"farm_metrics_{r}.json").read_text())
                for r in range(2)]
        want = _launches(torch.device(device_type), {
            k: 2 * (v * frames + 3 * (k in ("K5", "K6")))
            for k, v in LEGACY_PER_FRAME.items()})
        if m.shape != {"stream": 2, "space": 1} or \
                (sl.start, sl.stop) != (rank, rank + 1) or \
                total != both[0]["aggregate_fps"] + both[1]["aggregate_fps"] \
                or launches != want or \
                [len(v) for v in written.values()] != [frames] * 2:
            raise AssertionError(
                f"farm rank {rank}: mesh {m.shape}, slice {sl}, "
                f"all_streams_fps {total} against {both}, launches "
                f"{launches} (expected {want}), written "
                f"{[len(v) for v in written.values()]}")
        (out / f"farm_{rank}.json").write_text(json.dumps({
            "mesh": m.shape, "slice": [sl.start, sl.stop],
            "all_streams_fps": total, "metrics": mine,
            "launches": launches}))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def farm_phase(device, hw=(480, 640), raw_hw=(RAW_H, RAW_W), frames=FRAMES):
    """[14c] the stream farm: 2 processes on the card, each ``cli.main``
    over its own two legacy clips, joined by --coordinator (gloo).
    -> each rank's result (farm_rank)."""
    out = PHASE14_TMP
    out.mkdir(parents=True, exist_ok=True)
    _spawn_ranks(farm_rank, (_free_port(), str(out), device.type, hw, raw_hw,
                             frames))
    return [json.loads((out / f"farm_{r}.json").read_text())
            for r in range(2)]


def videos_phase(device, hw=(480, 640), raw_hw=(RAW_H, RAW_W),
                 frames=FRAMES, counts=(1, 2, 4)):
    """[14a] N streams in one process through ``cli.main --videos`` on
    in-memory video (--no-host-prep): for each N of `counts` (legacy) and
    N = 2 (timelines), every stream's frames equal ``run_frames``' of its
    clip bit for bit and the launches are N x one stream's; the runs
    alternate with ``cli.main`` of one clip (``run_video``): single,
    N = 1, 2, 4, 4, 2, 1, single. Clips of 40 and 25 frames stop at the
    shorter with no producer thread left and the metrics written.
    Returns what main prints."""
    h, w = hw
    dims = ["--xdim", str(w), "--ydim", str(h), "--device", device.type,
            "--no-host-prep"]
    clips = _stream_clips(max(counts), frames + 1, raw_hw, 0)
    names = list(clips)
    argv = ["clip.mem", str(PHASE14_TMP / "videos"), "--mode", "legacy",
            *dims]
    cfg = cli._mode_config(cli.build_parser().parse_args(argv))
    ref = {k: torch.stack(list(runner.run_frames(
        "legacy", v, cfg, device=device))).cpu().numpy()
        for k, v in clips.items()}
    per_stream = {k: v * frames + 3 * (k in ("K5", "K6"))
                  for k, v in LEGACY_PER_FRAME.items()}

    def videos(n, mode="legacy"):
        return cli_run([str(PHASE14_TMP / "videos"), "--videos",
                        *names[:n], "--mode", mode, *dims], clips)

    def check(run, n, want_launches, refs):
        got = run["written"]
        for i in range(n):
            key = f"{PHASE14_TMP / 'videos'}_s{i}.mp4"
            if key not in got or not np.array_equal(got[key], refs[i]):
                raise AssertionError(f"--videos x{n}: stream {i} differs "
                                     f"from run_frames' frames")
        if run["launches"] != want_launches or \
                run["metrics"]["frames_total"] != n * frames:
            raise AssertionError(f"--videos x{n}: launches "
                                 f"{run['launches']} (expected "
                                 f"{want_launches}), metrics "
                                 f"{run['metrics']}")

    single = lambda: cli_run(["s0.mem", str(PHASE14_TMP / "single"),  # noqa
                              "--mode", "legacy", *dims], clips)
    order = ["single", *counts, *counts[::-1], "single"]
    runs = {k: [] for k in order}
    for k in order:
        runs[k].append(single() if k == "single" else videos(k))
    for n in counts:
        for run in runs[n]:
            check(run, n, _launches(device, {k: n * v for k, v in
                                             per_stream.items()}),
                  [ref[names[i]] for i in range(n)])
    res = {"single_fps": [r["metrics"]["fps"] for r in runs["single"]],
           "single_stages_s": runs["single"][-1]["metrics"]["stages_s"]}
    for n in counts:
        res[f"x{n}"] = {
            "aggregate_fps": [r["metrics"]["aggregate_fps"]
                              for r in runs[n]],
            "per_stream_fps": [r["metrics"]["per_stream_fps"]
                               for r in runs[n]],
            "stages_s": runs[n][-1]["metrics"]["stages_s"]}

    n = max(counts)
    traced = cli_run([str(PHASE14_TMP / "videos"), "--videos", *names[:n],
                      "--mode", "legacy", *dims], clips, trace=True)
    check(traced, n, _launches(device, {k: n * v for k, v in
                                        per_stream.items()}),
          [ref[names[i]] for i in range(n)])
    if traced["trace"] is not None:
        t, secs = traced["trace"], traced["metrics"]["seconds"]
        res[f"x{n}"]["traced"] = {
            "device_ms_per_frame": t["device_ms"] / (n * frames),
            "seconds": secs, "busy_share": t["device_ms"] / 1e3 / secs,
            "d2h_bytes_per_frame": sum(t["d2h_bytes"]) / (n * frames)}

    tl_cfg = cli._mode_config(cli.build_parser().parse_args(
        ["clip.mem", "--mode", "timelines", *dims]))
    tl_ref = [torch.stack(list(runner.run_frames(
        "timelines", clips[k], tl_cfg, device=device))).cpu().numpy()
        for k in names[:2]]
    tl = videos(2, "timelines")
    check(tl, 2, _launches(device, {k: 2 * frames * (k == "K3")
                                    for k in K_ROWS}), tl_ref)
    res["timelines_x2"] = {
        "aggregate_fps": tl["metrics"]["aggregate_fps"],
        "launches_per_lockstep_frame": {k: v / frames for k, v in
                                        tl["launches"].items()}}

    n_short = frames * 5 // 8                   # 40 and 25 raw frames
    short = {"long.mem": clips[names[0]][:frames],
             "short.mem": clips[names[1]][:n_short]}
    before = set(threading.enumerate())
    run = cli_run([str(PHASE14_TMP / "unequal"), "--videos", *short,
                   "--mode", "legacy", "--no-output", *dims], short)
    left = set(threading.enumerate()) - before
    scanned = n_short - 1
    if left or run["metrics"] is None or \
            run["metrics"]["frames_total"] != 2 * scanned:
        raise AssertionError(f"unequal clips: threads left {left}, "
                             f"metrics {run['metrics']}")
    res["unequal"] = {"frames_total": run["metrics"]["frames_total"],
                      "threads_left": 0}
    res["launches_x4_per_lockstep_frame"] = {
        k: v / frames for k, v in runs[max(counts)][-1]["launches"].items()}
    return res


# ---------------------------------------------------------------------------
# Phase 15: the space form (--mesh-space 2)
# ---------------------------------------------------------------------------

PHASE15_TMP = CLI_TMP / "phase15"
# Launches per rank and frame of the space form's steps: legacy's slab
# stream (K5/K6 once a level of the new frame; K1, K1b and K2 once an
# update and iteration; K4 between levels; K5/K6 3 more for the first
# frame's slab), timelines' K3 on the rank's vertices.
SPACE_LEGACY_PER_FRAME = {"K1": 6, "K1b": 6, "K2": 6, "K3": 0, "K4": 2,
                          "K5": 3, "K6": 3, "K7": 0, "K8": 0}
SPACE_TIMELINES_PER_FRAME = {"K1": 0, "K1b": 0, "K2": 0, "K3": 1, "K4": 0,
                             "K5": 0, "K6": 0, "K7": 0, "K8": 0}
SPACE_SHARE = 0.99           # equal pixels: JAX's bound for a sharded step


@contextlib.contextmanager
def space_recording(rec: dict, slab_fn="spatial_stream_step"):
    """Record, on the device, what the legacy step computes: each frame's
    flow (the band's through ``spatial.<slab_fn>`` in the space form, or
    ``legacy.flow_stream_step``'s), its rip mask (``duty_cycle_viz``) and
    UPPER (``thresholds``), and the slab heights (``spatial.slab_of``)."""
    def wrap(obj, name, keep):
        real = getattr(obj, name)

        def fn(*a, **kw):
            out = real(*a, **kw)
            keep(out)
            return out
        return _patched(obj, name, fn)

    with contextlib.ExitStack() as stack:
        target = (spatial, slab_fn) if slab_fn else \
            (legacy_mod, "flow_stream_step")
        stack.enter_context(wrap(*target, lambda o: rec["flow"].append(
            o[0].clone())))
        stack.enter_context(wrap(classify, "duty_cycle_viz", lambda o: rec[
            "mask"].append(o.outmask.clone())))
        stack.enter_context(wrap(histops, "thresholds", lambda o: rec[
            "upper"].append(o.upper.clone())))
        stack.enter_context(wrap(spatial, "slab_of", lambda o: rec[
            "slab_rows"].append(o[0].shape[-2])))
        yield rec


def space_rank(rank, out, device_type, hw, raw_hw, frames):
    """[15] one of 2 processes sharing the card: ``cli.main --videos <clip>
    --mesh-space 2`` with the farm's flags (a file:// store per run, so
    the 'space' group is gloo) on an in-memory clip made from a seed:
    legacy timed with every counter set to 0 just before, legacy again
    recording (``space_recording``), then timelines. Writes
    space_<rank>.json (launches, metrics, slab heights) and this rank's
    recordings (space_rec_<rank>.pt); rank 0 also the written frames."""
    torch.set_num_threads(1)
    out = pathlib.Path(out)
    h, w = hw
    clips = _stream_clips(1, frames + 1, raw_hw, 40)
    res = {}

    def run(mode, tag, rec=None):
        store = out / f"space_{tag}.store"
        metrics = out / f"space_{tag}_metrics.json"
        argv = [str(out / f"space_{tag}"), "--videos", *clips, "--mode",
                mode, "--mesh-space", "2", "--coordinator",
                f"file://{store}", "--num-processes", "2", "--process-id",
                str(rank), "--no-host-prep", "--xdim", str(w), "--ydim",
                str(h), "--device", device_type, "--metrics-json",
                str(metrics)]
        with memory_video(clips) as written, \
                contextlib.redirect_stdout(io.StringIO()), \
                (space_recording(rec) if rec is not None
                 else contextlib.nullcontext()):
            reset_all_launches()
            rc = cli.main(argv)
            launches = all_launch_counts()
        torch.distributed.destroy_process_group()
        if rc != 0:
            raise AssertionError(f"space rank {rank}: cli.main {mode} "
                                 f"exited {rc}")
        if rank == 0:
            for path, got in written.items():
                np.save(out / f"{pathlib.Path(path).stem}.npy",
                        np.stack(got))
        return {"launches": launches,
                "metrics": json.loads(metrics.read_text())
                if rank == 0 else None}

    res["legacy"] = run("legacy", "legacy")
    rec = collections.defaultdict(list)
    run("legacy", "legacy_rec", rec)
    res["slab_rows"] = sorted(set(rec.pop("slab_rows")))
    torch.save({k: torch.stack(v).cpu() for k, v in rec.items()},
               out / f"space_rec_{rank}.pt")
    res["timelines"] = run("timelines", "timelines")
    (out / f"space_{rank}.json").write_text(json.dumps(res))


def space_phase(device, hw=(480, 640), raw_hw=(RAW_H, RAW_W),
                frames=FRAMES):
    """[15] the space form on 2 processes sharing the card (``space_rank``;
    the kernels are built in this process beforehand) against this
    process's ``run_frames`` of the same clip: timelines bit for bit;
    legacy's overlays and rip masks equal on >= SPACE_SHARE of pixels,
    every frame's flow within SPATIAL_BOUNDS, UPPER equal on both ranks
    every frame; each rank's launches (SPACE_*_PER_FRAME; off the card
    none) and slab height; beside the timings, one process's
    ``cli.main --videos`` of the same clip. Returns what main prints."""
    out = PHASE15_TMP
    out.mkdir(parents=True, exist_ok=True)
    for f in out.glob("*.store"):
        f.unlink()
    h, w = hw
    _spawn_ranks(space_rank, (str(out), device.type, hw, raw_hw, frames))
    ranks = [json.loads((out / f"space_{r}.json").read_text())
             for r in range(2)]
    recs = [torch.load(out / f"space_rec_{r}.pt") for r in range(2)]
    clips = _stream_clips(1, frames + 1, raw_hw, 40)
    (name, raw), = clips.items()
    dims = ["--xdim", str(w), "--ydim", str(h), "--device", device.type,
            "--no-host-prep"]
    cfg = cli._mode_config(cli.build_parser().parse_args(
        [name, "--mode", "legacy", *dims]))
    cfg = dataclasses.replace(cfg, total_frames=frames + 1)
    want = collections.defaultdict(list)
    with space_recording(want, slab_fn=None):
        ref = torch.stack(list(runner.run_frames(
            "legacy", raw, cfg, device=device))).cpu().numpy()
    got = np.load(out / "space_legacy_s0.npy")
    res = {"overlay_share": float(np.mean(got == ref)) if
           got.shape == ref.shape else 0.0}
    band = h // 2
    masks = torch.cat([r["mask"] for r in recs], dim=1)
    res["mask_share"] = float((masks == torch.stack(want["mask"]).cpu())
                              .float().mean())
    flows = torch.cat([r["flow"] for r in recs], dim=1)
    ref_flows = torch.stack(want["flow"]).cpu()
    readings = [_spatial_readings(g, r) for g, r in zip(flows, ref_flows)]
    res["flow_worst"] = {k: max(x[k] for x in readings)
                         for k in SPATIAL_BOUNDS}
    res["upper_equal"] = bool(torch.equal(recs[0]["upper"],
                                          recs[1]["upper"]))
    tl_cfg = cli._mode_config(cli.build_parser().parse_args(
        [name, "--mode", "timelines", *dims]))
    tl_ref = torch.stack(list(runner.run_frames(
        "timelines", raw, tl_cfg, device=device))).cpu().numpy()
    tl_got = np.load(out / "space_timelines_s0.npy")
    res["timelines_equal"] = bool(np.array_equal(tl_got, tl_ref))
    halo = legacy_mod.space_halo(cfg)
    want_legacy = _launches(device, {
        k: v * frames + 3 * (k in ("K5", "K6"))
        for k, v in SPACE_LEGACY_PER_FRAME.items()})
    want_tl = _launches(device, {k: v * frames for k, v in
                                 SPACE_TIMELINES_PER_FRAME.items()})
    bad = []
    if res["overlay_share"] < SPACE_SHARE or res["mask_share"] < SPACE_SHARE:
        bad.append("overlay/mask")
    if any(res["flow_worst"][k] >= SPATIAL_BOUNDS[k]
           for k in SPATIAL_BOUNDS):
        bad.append("flow")
    if not res["upper_equal"] or not res["timelines_equal"]:
        bad.append("UPPER/timelines")
    for r in ranks:
        if r["legacy"]["launches"] != want_legacy or \
                r["timelines"]["launches"] != want_tl:
            bad.append(f"launches {r['legacy']['launches']} / "
                       f"{r['timelines']['launches']}")
        if r["slab_rows"] != [band + 2 * halo if 2 * halo <= band
                              else band + halo]:
            bad.append(f"slab rows {r['slab_rows']}")
    if got.shape != ref.shape or not np.isfinite(flows.numpy()).all():
        bad.append(f"shapes {got.shape} {ref.shape}")
    res["ranks"] = ranks
    if bad:
        raise AssertionError(f"[15] space form: {bad}: "
                             f"{ {k: v for k, v in res.items() if k != 'ranks'} }")
    single = cli_run([str(out / "single"), "--videos", name, "--mode",
                      "legacy", *dims], clips)
    m = ranks[0]["legacy"]["metrics"]
    res["timing"] = {
        "one_process_ms_per_frame":
            single["metrics"]["seconds"] * 1e3 / frames,
        "ranks": [{"ms_per_frame": x["ms_per_frame"],
                   "exchange_ms_per_frame": x["exchange_s"] * 1e3 / frames,
                   "exchange_bytes_per_frame":
                       x["exchange_bytes_per_frame"],
                   "exchanges_per_frame": x["exchanges_per_frame"],
                   "output_gather_ms_per_frame":
                       x["output_gather_s"] * 1e3 / frames,
                   "by_label_ms_bytes_calls_per_frame": {
                       k: [v["s"] * 1e3 / frames, v["bytes"] / frames,
                           v["calls"] / frames]
                       for k, v in x["exchange_by"].items()}}
                  for x in m["space"]["ranks"]],
        "timelines_ms_per_frame": [
            x["ms_per_frame"]
            for x in ranks[0]["timelines"]["metrics"]["space"]["ranks"]],
        "backend": m["space"]["backend"], "halo": m["space"]["halo"],
        "mesh": m["mesh"]}
    return res


# ---------------------------------------------------------------------------
# Phase 5: kernel timing
# ---------------------------------------------------------------------------

def wall_ms(fn, reps):
    """ms per call by CUDA events over `reps` back-to-back calls: includes
    the host's time to issue each call whenever it exceeds the device's."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def device_ms(fn, reps):
    """Device time per call: the summed duration of every kernel the call
    launches, from a torch.profiler trace of `reps` warm calls (warm L2:
    on the main path each kernel reads what the previous one wrote). A
    session that records no device time is repeated, at most twice; when
    all three record none, the call is timed by CUDA events around the
    `reps` calls (the host's issue time included where it is longer) and
    the script says so."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    print("    torch.profiler recorded no device time in 3 sessions; timed "
          "by CUDA events around the calls instead", flush=True)
    return wall_ms(fn, reps)


def event_times(fn, reps, hold_cycles=20_000_000):
    """Device time in ms of each of `reps` warm calls of fn, from CUDA
    events recorded on the stream just before and just after each call:
    the time of everything the call launches plus the events' own cost,
    which on an H100 added ~4 us to K2's 2.9 and 7.1 us. A spin kernel of
    `hold_cycles` (~10 ms) runs first, so the host has queued every call
    before the device reaches them and no host time falls between two
    events. A fallback that keeps the run going, not a time to compare."""
    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(hold_cycles)
    for s, e in marks:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in marks]


def device_times(fn, reps, name):
    """Device time in ms of each of `reps` warm calls of fn, which launches
    one kernel, whose name holds `name` (torch.profiler events). A session
    that records fewer than half of the launches (the profiler dropped some
    in long runs) is repeated, at most twice; when all three lose them, the
    calls are timed by ``event_times`` instead and the script says so."""
    fn()
    torch.cuda.synchronize()
    seen = set()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        cuda = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        ts = [e.time_range.elapsed_us() / 1e3 for e in cuda if name in e.name]
        if len(ts) >= reps // 2:
            return ts
        seen |= {e.name[:40] for e in cuda}
    print(f"    torch.profiler recorded {len(ts)} of {reps} launches of "
          f"{name} in each of 3 sessions (it recorded {sorted(seen)}); "
          f"timed by CUDA events around each call instead", flush=True)
    return event_times(fn, reps)


def lk_timing(device, pts, p: LKParams = LKParams.particles(),
              reps=LK_REPS):
    """K3 alone at 640x480 (``lk_inputs``) on pts (B, N, 2): the device
    times in ms of `reps` launches, sorted, and one launch's iteration
    counts (B, N) (their max is the longest per-point chain)."""
    pyr_prev, pyr_next, derivs = lk.prepare(*lk_inputs(device), p)
    k3 = lambda: lk_track(pyr_prev, pyr_next, derivs, pts, p)  # noqa: E731
    iters = k3()[1]
    return sorted(device_times(k3, reps, "lk_track_kernel")), iters


def median_ms(fn, reps, name):
    """A kernel's device time per call: the median of the profiled
    launches of kernel `name`, which fn launches once per call. Medians of
    the recorded launches do not depend on how many records the profiler
    dropped (a sum over the session would)."""
    t = sorted(device_times(fn, reps, name))
    return t[len(t) // 2]


def prep_bytes_ops(args, win, channels_first=True):
    """((bytes, ops) of K5, (bytes, ops) of K6) at one level geometry
    (``farneback._prep_level_args``) with its windows, counting only what
    the function needs: K5 reads the frame's rows that some window covers
    (f32) and each row's window weights (bf16 values, 2 bytes), writes t
    (bf16) once, and does a product and an add per tap of each output's
    window; K6 reads t's nonzero rows over the source columns some window
    covers and each nonzero column's window weights of the three x
    matrices (bf16 values), writes the table (bf16 channels first, or
    f32) once with its pads, and does six products and six adds per tap
    of each nonzero output's window and 7 operations of the combine."""
    h, w, ph, pw = args[0], args[1], args[8], args[9]

    def covered(lo, ln):
        live = ln > 0
        return int((lo[live] + ln[live]).max() - lo[live].min())

    y_lo, y_len, x_lo, x_len = (win[k].cpu().numpy() for k in
                                ("y_lo", "y_len", "x_lo", "x_len"))
    rows = int((y_len[:ph] > 0).sum())
    cols = int((x_len > 0).sum())
    k5 = (covered(y_lo, y_len) * w * 4 + 3 * ph * w * 2 +
          int(y_len.sum()) * 2,
          2 * int(y_len.sum()) * w)
    k6 = (int((y_len > 0).sum()) * covered(x_lo, x_len) * 2 +
          5 * ph * pw * (2 if channels_first else 4) +
          3 * int(x_len.sum()) * 2,
          12 * int(x_len.sum()) * rows + 7 * rows * cols)
    return k5, k6


def prep_levels(h, w, p: FarnebackParams, device, reps=50):
    """K5 and K6 at every level of preset p at (h, w), coarsest first:
    each kernel's device us per launch (median, min and max of `reps`
    profiled launches) beside its bound, max(bytes / HBM, ops / F32), and
    its issue floor, ops / (F32 / 2): with -fmad=false every product and
    every add is an instruction of its own. Returns (one dict per level,
    the sums per frame: one launch of each per level)."""
    img = moving_frames(1, h, w, device, color=False)[0].to(torch.float32)
    channels_first = p.warp_impl == "fused"
    rows = []
    for k in range(p.levels, -1, -1):
        args = fb._prep_level_args(h, w, p, k)
        k5, k6 = prep_call(img, args, channels_first)[:2]
        win = fb._prep_windows_on(args, device)
        row = {"level": k, "hw": (args[2], args[3]),
               "canvas": (args[8], args[9]),
               "window": int(win["y_len"].max())}
        for name, fn, kernel, (nbytes, ops) in zip(
                ("k5", "k6"), (k5, k6), ("prep_y_kernel", "prep_x3_kernel"),
                prep_bytes_ops(args, win, channels_first)):
            t = sorted(device_times(fn, reps, kernel))
            row.update({f"{name}_us": t[len(t) // 2] * 1e3,
                        f"{name}_us_min": t[0] * 1e3,
                        f"{name}_us_max": t[-1] * 1e3,
                        f"{name}_bound_us": max(nbytes / HBM_BYTES_PER_S,
                                                ops / F32_FLOPS) * 1e6,
                        f"{name}_bound_by": "bytes" if nbytes /
                        HBM_BYTES_PER_S >= ops / F32_FLOPS else "operations",
                        f"{name}_floor_us": ops / (F32_FLOPS / 2) * 1e6})
        rows.append(row)
    frame = {key: sum(r[key] for r in rows)
             for key in ("k5_us", "k6_us", "k5_bound_us", "k6_bound_us")}
    return rows, frame


def blur_bytes_ops(hw, hpwp, half):
    """K2's (bytes, operations, instructions) at one level: M's true region
    read once (5 bf16 channels) and the flow written once with its pads (2
    f32 channels); a product and an add per tap and channel in the y pass
    for every mid value the x pass reads (hp rows by the true width) and
    in the x pass for every output, and ~12 operations of the solve; each
    tap's product and add one FMA instruction (its product is exact)."""
    (h, w), (hp, wp) = hw, hpwp
    taps = 5 * (2 * half + 1) * (hp * w + hp * wp)
    return (5 * 2 * h * w + 2 * 4 * hp * wp, 2 * taps + 12 * hp * wp,
            taps + 12 * hp * wp)


def upsample_bytes_ops(src_true, dst_pad, channels=2):
    """K4's (bytes, operations, instructions) at one level change: the
    source's true region read once and the padded output written once
    (f32, 2 channels); per output and channel 3 products and 3 FMAs (9
    flops, 6 instructions)."""
    out = channels * dst_pad[0] * dst_pad[1]
    return (4 * (channels * src_true[0] * src_true[1] + out), 9 * out,
            6 * out)


def _timed(fn, reps, name):
    """{us, us_min, us_max} of `reps` profiled launches of kernel `name`."""
    t = sorted(device_times(fn, reps, name))
    return {"us": t[len(t) // 2] * 1e3, "us_min": t[0] * 1e3,
            "us_max": t[-1] * 1e3}


def blur_levels(h, w, p: FarnebackParams, device, reps=50):
    """K2 at every level of preset p at (h, w), coarsest first: its device
    us per launch (median, min and max of `reps` profiled launches) beside
    its bound, max(bytes / HBM, ops / F32), and its issue floor,
    instructions / (F32 / 2) (``blur_bytes_ops``: an FMA a tap).
    Returns (one dict per level, the sums per frame: each level times its
    iterations, the preset's K2 launches there)."""
    half = p.winsize // 2
    rows = []
    for k in range(p.levels, -1, -1):
        m, hw, iters = blur_inputs(h, w, p, device, k)
        hpwp = tuple(m.shape[1:])
        nbytes, ops, instr = blur_bytes_ops(hw, hpwp, half)
        row = {"level": k, "hw": hw, "hpwp": hpwp, "half": half,
               "iterations": iters,
               "bound_us": max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) *
               1e6,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >=
               ops / F32_FLOPS else "operations",
               "floor_us": instr / (F32_FLOPS / 2) * 1e6}
        row.update(_timed(lambda: fu.farneback_blur_solve(
            m, hw, p.winsize, p.gaussian, True), reps,
            "farneback_blur_solve_kernel"))
        rows.append(row)
    frame = {key: sum(r[key] * r["iterations"] for r in rows)
             for key in ("us", "bound_us", "floor_us")}
    return rows, frame


def upsample_levels(h, w, p: FarnebackParams, device, reps=50):
    """K4 at every level change of preset p at (h, w), coarsest first:
    device us per launch (median, min and max of `reps` profiled launches)
    beside its bound and its issue floor (instructions at F32 / 2).
    Returns (one dict per level change, the sums per frame)."""
    rows = []
    for i, (st, dt, sp, dp, scale) in enumerate(upsample_geometries(h, w,
                                                                    p)):
        flow = _padded_flow(st, sp, device, seed=i)
        nbytes, ops, instr = upsample_bytes_ops(st, dp)
        row = {"src": st, "dst": dt, "dst_pad": dp,
               "bound_us": max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) *
               1e6,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >=
               ops / F32_FLOPS else "operations",
               "floor_us": instr / (F32_FLOPS / 2) * 1e6}
        row.update(_timed(lambda: img_ops.resize_bilinear_cf_padded(
            flow, st, dt, dp, scale), reps, "resize_cf_padded_kernel"))
        rows.append(row)
    frame = {key: sum(r[key] for r in rows)
             for key in ("us", "bound_us", "floor_us")}
    return rows, frame


def blur_upsample_frames(device, reps=50):
    """K2's and K4's per-level rows and per-frame sums at every pyramid of
    BLUR_PYRAMIDS: {name: {"k2": (levels, frame), "k4": (levels, frame)}}.
    Uses only what the parent tree's package also has, so that
    ``compare_parent`` can time both trees with it."""
    return {name: {"k2": blur_levels(*hw, preset, device, reps),
                   "k4": upsample_levels(*hw, preset, device, reps)}
            for name, (hw, preset) in BLUR_PYRAMIDS.items()}


def call_ms(fn, reps):
    """Device ms per call of fn, which launches each of its kernels once
    per call: each kernel name's median of its profiled launches, summed
    over the names; and the names. A session that records fewer than half
    of some kernel's launches is repeated, at most twice; when all three
    lose them, the median of ``event_times`` (CUDA events around each
    call, a few us high) and the script says so."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by.setdefault(e.name, []).append(
                    e.time_range.elapsed_us() / 1e3)
        if by and min(len(t) for t in by.values()) >= reps // 2:
            return (sum(sorted(t)[len(t) // 2] for t in by.values()),
                    sorted(by))
    print(f"    torch.profiler recorded "
          f"{({k[:40]: len(t) for k, t in by.items()})} of {reps} launches "
          f"in each of 3 sessions; timed by CUDA events around each call "
          f"instead", flush=True)
    t = sorted(event_times(fn, reps))
    return t[len(t) // 2], sorted(by)


def k8_bytes(hw, channels, table_bytes=4):
    """K8's bytes at one call: the table, the flow (f32, 2 channels) and
    the f32 output once each."""
    return hw[0] * hw[1] * (channels * table_bytes + 2 * 4 + channels * 4)


def k8_levels(device, reps=50):
    """K8 at every level of the tiled engine's 640x480 pyramid (frame
    layout, C = 5, the engine's tiles and residuals; device us per call:
    ``call_ms`` over `reps` launches) beside its bound, and per tiled
    frame (each level x its iterations); and in the halo layout at both
    bench_warp configurations with the no-base floor "Z". Uses only what
    the parent tree's package also has, so that ``compare_parent`` can time
    both trees with it."""
    rows = []
    for k, hw, (th, tw), bres, iters in tiled_levels(480, 640):
        table, flow = frame_tiles_inputs(*hw, 5, bres, device, seed=k)
        counts = warp_kernel.frame_counts(*hw, th, tw, device)
        ms, names = call_ms(lambda: warp_kernel.warp_tiles(
            table, flow, counts, th, tw, bres), reps)
        rows.append({"level": k, "hw": hw, "tile": (th, tw), "bres": bres,
                     "iterations": iters, "us": ms * 1e3,
                     "kernels": len(names),
                     "bound_us": k8_bytes(hw, 5) / HBM_BYTES_PER_S * 1e6})
    frame = {key: sum(r[key] * r["iterations"] for r in rows)
             for key in ("us", "bound_us", "kernels")}
    halo = {}
    for bres, sw in ((2, None), (1, 640)):
        g = bench_warp.inputs(device, sw)
        halo[f"bres{bres}_sw{g['sw']}"] = {
            v: call_ms(bench_warp.variant_fn(v, g, bres), reps)[0] * 1e3
            for v in ("A", "Z")}
        halo[f"bres{bres}_sw{g['sw']}"]["bound_us"] = k8_bytes(
            (g["hp"], g["wp"]), 5, 2) / HBM_BYTES_PER_S * 1e6
    return {"levels": rows, "frame": frame, "halo_1080p": halo}


def k8_new_paths(device, reps=50):
    """K8's device time per call (``call_ms``) at the new paths'
    geometries of ``check_tiles_new_paths``: each of dense_lk's four
    640x480 levels (C = 1, bres 4) and stabilizeTPU's 480x640 colour
    frame (C = 3, bres 6), with the bound; per dense_lk call (each level
    x 30 iterations) and per stabilizeTPU frame (one call)."""
    rows = []
    for k, hw in enumerate(dense_lk_shapes()):
        table, flow = frame_tiles_inputs(*hw, 1, 4, device, seed=20 + k)
        ms, _ = call_ms(lambda: warp_kernel.warp_tiles(
            table, flow, None, 64, 256, 4), reps)
        rows.append({"path": f"dense_lk L{k}", "hw": hw, "channels": 1,
                     "us": ms * 1e3,
                     "bound_us": k8_bytes(hw, 1) / HBM_BYTES_PER_S * 1e6})
    frame = moving_frames(1, 480, 640, device, seed=30)[0]
    table = frame.to(torch.float32).contiguous()
    disp = feature_stab.homography_displacement(stab_homography(device),
                                                480, 640)
    ms, _ = call_ms(lambda: warp_kernel.warp_tiles(table, disp, None, 64,
                                                   256, 6), reps)
    rows.append({"path": "stabilizeTPU", "hw": (480, 640), "channels": 3,
                 "us": ms * 1e3,
                 "bound_us": k8_bytes((480, 640), 3) / HBM_BYTES_PER_S * 1e6})
    it = LKParams.dense_grid().max_iters
    lk_rows = rows[:-1]
    return {"levels": rows,
            "dense_lk_call": {key: it * sum(r[key] for r in lk_rows)
                              for key in ("us", "bound_us")},
            "stabilize_frame": {key: rows[-1][key]
                                for key in ("us", "bound_us")}}


def compare_parent(parent: str, rounds=2):
    """Time K8 (``k8_levels``) in the parent tree at `parent` (a directory
    holding only its ``ripcurrents_tpu_torch/``) and in this one,
    alternating parent / change / change / parent (`rounds` such pairs of
    pairs), each run a fresh process that builds its own kernels. Prints
    and returns what each run measured."""
    import os
    import pathlib
    here = pathlib.Path(__file__).resolve().parent
    trees = {"parent": pathlib.Path(parent).resolve(), "change": here}
    # the tree's package comes first on the path, this chip_smoke.py after
    code = ("import json, sys, torch; sys.path.append(%r); "
            "import chip_smoke as cs; "
            "print('RESULT ' + json.dumps(cs.k8_levels("
            "torch.device('cuda'))))")
    runs = []
    for _ in range(rounds):
        for name in ("parent", "change", "change", "parent"):
            env = dict(os.environ, PYTHONPATH=str(trees[name]))
            out = subprocess.run([sys.executable, "-c", code % str(here)],
                                 cwd=trees[name], env=env, check=True,
                                 capture_output=True, text=True).stdout
            res = json.loads(out.split("RESULT ", 1)[1])
            levels = [(r["level"], round(r["us"], 2), r["kernels"])
                      for r in res["levels"]]
            halo = {k: {v: round(t, 2) for v, t in d.items()}
                    for k, d in res["halo_1080p"].items()}
            print(f"[compare] {name}: K8 us per tiled frame "
                  f"{res['frame']['us']:.2f} ({res['frame']['kernels']} "
                  f"kernels); per level (level, us, kernels) {levels}; "
                  f"1080p halo {halo}", flush=True)
            runs.append({"tree": name, **res})
    return runs


def k7_against_grid_sample(device, reps=50, rounds=2):
    """K7 (640x480, budget 16, flows within +-12 px) and grid_sample on
    the same table and flow, alternating K7 / grid_sample / grid_sample /
    K7 `rounds` times: the median of each kernel's own `reps` profiled
    launches per turn."""
    h, w = 480, 640
    r1, wflow = warp_inputs(h, w, device, 12.0)
    r1cf = r1.permute(2, 0, 1)[None].contiguous()
    ys, xs = fb._grid(h, w, device)
    grid = torch.stack([(xs + wflow[..., 0]) * (2.0 / (w - 1)) - 1,
                        (ys + wflow[..., 1]) * (2.0 / (h - 1)) - 1],
                       dim=-1)[None]
    turns = {"k7": (lambda: warp_kernel.warp5_shift(r1, wflow, 16),
                    "warp5_shift_kernel"),
             # cuDNN's bilinear_sampler_fw or ATen's grid_sampler_2d
             "grid_sample": (lambda: F.grid_sample(
                 r1cf, grid, mode="bilinear", padding_mode="zeros",
                 align_corners=True), "sampler")}
    got = {"k7": [], "grid_sample": []}
    for _ in range(rounds):
        for name in ("k7", "grid_sample", "grid_sample", "k7"):
            fn, kernel = turns[name]
            got[name].append(_timed(fn, reps, kernel)["us"])
    return got


def kernel_rows(device, launches, devs):
    """Timing rows at the 640x480 shapes: K1, K2, K4, K5 and K6 at level 0
    of the legacy preset, K3 on the 201 timeline vertices, K7 at level 0 of
    the subtract_average preset. launches: {kernel: count} of the main
    paths; devs: the deviations of phase 2."""
    p = FarnebackParams.legacy()
    h, w = 480, 640
    bres = _bres(p, h, w)
    prep, flow = level_inputs(h, w, p, device)
    hp, wp = prep["hpwp"]
    m = fu.farneback_update(prep, flow, bres)
    args = (prep["p0"], prep["p1"], flow, prep["counts"], prep["hw"],
            prep["th"], prep["sw"], bres)
    wy, wx = fu._blur_weights_on(hp, h, p.winsize, p.gaussian, device)
    nt = wx.numel()

    k1 = lambda: fu.farneback_update(prep, flow, bres)  # noqa: E731
    k1_ms = median_ms(k1, 100, "farneback_update_kernel")
    k1_wall = wall_ms(k1, 100)
    k1_plain = device_ms(lambda: fu.farneback_update_plain(*args), 10)
    k1_bytes, k1_ops = k1_bytes_ops(hp, wp)
    k2 = lambda: fu.farneback_blur_solve(  # noqa: E731
        m, (h, w), p.winsize, p.gaussian, True)
    k2_ms = median_ms(k2, 100, "farneback_blur_solve_kernel")
    k2_wall = wall_ms(k2, 100)
    k2_plain = device_ms(lambda: fu.farneback_blur_solve_plain(
        m, (h, w), wy, wx, True), 10)
    k2_bytes, k2_ops, _ = blur_bytes_ops((h, w), (hp, wp), nt // 2)
    # library yardstick for K2's blur: one grouped conv2d of the 5 bf16
    # channels with the 2-D window (replicate padding done beforehand).
    k2d = (wy[h // 2][:, None] * wx[None, :]).to(torch.bfloat16)
    weight = k2d.expand(5, 1, nt, nt).contiguous()
    half = nt // 2
    mpad = F.pad(m[None, :, :h, :w].float(), (half,) * 4,
                 mode="replicate").to(torch.bfloat16)
    lib_ms = device_ms(lambda: F.conv2d(mpad, weight, groups=5), 100)

    # K4 at the last level change (240x320 -> 480x640): the source read
    # once and the output written once; 2 FMAs + 2 products per pass.
    st, dt, sp, dp, scale = upsample_geometries(h, w, p)[-1]
    k4_in = _padded_flow(st, sp, device)
    key = img_ops.resize_key(k4_in, st, dt, dp, scale)
    taps = img_ops._padded_taps_on(key, k4_in.device)
    k4 = lambda: img_ops.resize_bilinear_cf_padded(  # noqa: E731
        k4_in, st, dt, dp, scale)
    k4_ms = median_ms(k4, 100, "resize_cf_padded_kernel")
    k4_wall = wall_ms(k4, 100)
    k4_plain = device_ms(
        lambda: img_ops.resize_cf_padded_plain(k4_in, *taps), 10)
    k4_lib = device_ms(lambda: img_ops.resize_cf_padded_dense(k4_in, key),
                       100)
    k4_bytes = 2 * 4 * (sp[0] * sp[1] + dp[0] * dp[1])
    k4_ops = 2 * dp[0] * dp[1] * 9

    # K3 on the timeline's 201 vertices, LKParams.particles(). Bytes: the
    # four level images of every level, the points and the result. Ops
    # from this run's iteration counts: per point and level 3 windows of
    # 4 taps + 3 products per element, per iteration 4 taps + 2 products
    # per element (2 flops each).
    lkp = LKParams.particles()
    pyr_prev, pyr_next, derivs = lk.prepare(*lk_inputs(device), lkp)
    pts = timeline_init((10.0, 150.0), (630.0, 400.0), 200,
                        device).vertices[None]
    k3_t, iters = lk_timing(device, pts)
    k3_ms, k3_wall = k3_t[len(k3_t) // 2], wall_ms(
        lambda: lk_track(pyr_prev, pyr_next, derivs, pts, lkp), 20)
    k3_plain = device_ms(
        lambda: lk_track_plain(pyr_prev, pyr_next, derivs, pts, lkp), 2)
    area = lkp.win[0] * lkp.win[1]
    k3_bytes = 4 * 4 * sum(lv.numel() for lv in pyr_prev) + pts.numel() * 12
    k3_iters = int(iters.sum())
    k3_ops = 2 * area * (pts.shape[1] * len(pyr_prev) * 15 + k3_iters * 6)
    chain = int(iters.max())
    print(f"[5] lk_track iterations at 640x480, 201 vertices: "
          f"{k3_iters} in all, {k3_iters / pts.shape[1]:.2f} per point over "
          f"{len(pyr_prev)} levels (at most "
          f"{lkp.max_iters * len(pyr_prev)}); longest chain {chain}")
    print(f"[5] lk_track 201 vertices: median {k3_ms * 1e3:.2f} us of "
          f"{LK_REPS} launches (min {k3_t[0] * 1e3:.2f}, max "
          f"{k3_t[-1] * 1e3:.2f}); {k3_ms * 1e3 / chain:.3f} us per "
          f"iteration along the longest chain; latency bound {chain} x "
          f"{L2_ROUND_TRIP_US} us = {chain * L2_ROUND_TRIP_US:.2f} us")
    t_s, iters_s = lk_timing(device, lk_points(1280, 480, 640, 11).to(
        device)[None])
    print(f"[5] lk_track 1280 points: median {t_s[len(t_s) // 2] * 1e3:.2f} "
          f"us of {LK_REPS} launches (min {t_s[0] * 1e3:.2f}, max "
          f"{t_s[-1] * 1e3:.2f}); longest chain {int(iters_s.max())}")

    # K5 and K6 at level 0 of the legacy 640x480 table (5, 544, 896) bf16
    # (bytes and ops: ``prep_bytes_ops``).
    img = moving_frames(1, h, w, device, color=False)[0].to(torch.float32)
    args = fb._prep_level_args(h, w, p, 0)
    k5, k6, k5_plain, k6_plain, _, t = prep_call(img, args)
    win = fb._prep_windows_on(args, device)
    k5_ms = median_ms(k5, 100, "prep_y_kernel")
    k5_wall = wall_ms(k5, 100)
    k5_plain_ms = device_ms(k5_plain, 5)
    k6_ms = median_ms(k6, 100, "prep_x3_kernel")
    k6_wall = wall_ms(k6, 100)
    k6_plain_ms = device_ms(k6_plain, 5)
    (k5_bytes, k5_ops), (k6_bytes, k6_ops) = prep_bytes_ops(args, win)
    # yardsticks: each pass as one dense float32 torch.matmul of the
    # bf16-rounded operands (the K6 one without the combine)
    by3t, bx_g, bx_xg, bx_xxg = fb._prep_matrices_on(args, device,
                                                     torch.bfloat16)
    img16 = img.to(torch.bfloat16).to(torch.float32)
    k5_lib = device_ms(lambda: torch.matmul(by3t, img16), 100)
    bx3 = torch.cat([bx_g, bx_xg, bx_xxg], dim=1)
    tf = t.to(torch.float32)
    k6_lib = device_ms(lambda: torch.matmul(tf, bx3), 100)

    # K7 at level 0 of subtract_average on the portable engine, budget 16,
    # flows within +-12 px. Bytes: r1, the flow and the output once each;
    # ops: 4 taps x 5 channels x 2, the row and column sums and the hat
    # weights, ~76 per pixel.
    r1, wflow = warp_inputs(h, w, device, 12.0)
    k7 = lambda: warp_kernel.warp5_shift(r1, wflow, 16)  # noqa: E731
    k7_ms = median_ms(k7, 100, "warp5_shift_kernel")
    k7_wall = wall_ms(k7, 100)
    k7_plain = device_ms(
        lambda: warp_kernel.warp5_shift_plain(r1, wflow, 16), 5)
    k7_bytes = h * w * (5 * 4 + 2 * 4 + 5 * 4)
    k7_ops = h * w * 76
    # yardstick: grid_sample of the channels-first table at x + flow
    # (align_corners=True maps pixel centres to -1..1 exactly)
    r1cf = r1.permute(2, 0, 1)[None].contiguous()
    ys, xs = fb._grid(h, w, device)
    grid = torch.stack([(xs + wflow[..., 0]) * (2.0 / (w - 1)) - 1,
                        (ys + wflow[..., 1]) * (2.0 / (h - 1)) - 1],
                       dim=-1)[None]
    k7_lib = device_ms(lambda: F.grid_sample(
        r1cf, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), 100)

    # K8 in its frame layout at level 0 of the tiled engine (640x480,
    # subtract_average: tile (64, 256), bres 2), flows within +-12 px.
    # Bytes: r1, the flow and the output once each; ops: the 4-tap sample
    # of 5 channels (6 products and 3 sums each), the weights and the
    # residual, ~50 per pixel. One launch a call.
    k8 = lambda: warp_kernel.warp_tiles(  # noqa: E731
        r1, wflow, None, 64, 256, 2)
    k8_ms = call_ms(k8, 100)[0]
    k8_wall = wall_ms(k8, 100)
    k8_plain = device_ms(lambda: warp_kernel.warp_tiles_plain(
        r1, wflow, None, 64, 256, 2), 5)
    k8_nbytes = k8_bytes((h, w), 5)
    k8_ops = h * w * 50

    def row(name, src, replaces, n, dev, ms, plain_ms, nbytes, ops, lib,
            wall):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS * 1e3
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": n, "max_abs_err": dev,
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib, "wall_ms": wall}

    return [
        row("farneback_update", "ripcurrents_tpu_torch/csrc/"
            "farneback_update.cu", "ripcurrents_tpu/flow/fused_update.py:682",
            launches["K1"], devs["k1_max"], k1_ms, k1_plain, k1_bytes,
            k1_ops, None, k1_wall),
        row("farneback_blur_solve", "ripcurrents_tpu_torch/csrc/"
            "farneback_blur_solve.cu",
            "ripcurrents_tpu/flow/fused_update.py:823", launches["K2"],
            devs["k2_max"], k2_ms, k2_plain, k2_bytes, k2_ops, lib_ms,
            k2_wall),
        dict(row("lk_track", "ripcurrents_tpu_torch/csrc/lk_track.cu",
                 "ripcurrents_tpu/flow/lk_pallas.py:322", launches["K3"],
                 devs["k3_px_max"], k3_ms, k3_plain, k3_bytes, k3_ops, None,
                 k3_wall),
             ms_min=k3_t[0], ms_max=k3_t[-1], longest_chain=chain,
             latency_bound_ms=chain * L2_ROUND_TRIP_US * 1e-3,
             ms_1280_points=t_s[len(t_s) // 2]),
        row("resize_cf_padded", "ripcurrents_tpu_torch/csrc/"
            "resize_cf_padded.cu", "ripcurrents_tpu/ops/resize_pallas.py:143",
            launches["K4"], devs["k4_vs_plain"], k4_ms, k4_plain, k4_bytes,
            k4_ops, k4_lib, k4_wall),
        row("prep_y", "ripcurrents_tpu_torch/csrc/prep_y.cu",
            "ripcurrents_tpu/flow/prep_pallas.py:128", launches["K5"],
            devs["k5_vs_plain"], k5_ms, k5_plain_ms, k5_bytes, k5_ops,
            k5_lib, k5_wall),
        row("prep_x3", "ripcurrents_tpu_torch/csrc/prep_x3.cu",
            "ripcurrents_tpu/flow/prep_pallas.py:182", launches["K6"],
            devs["k6_vs_plain"], k6_ms, k6_plain_ms, k6_bytes, k6_ops,
            k6_lib, k6_wall),
        row("warp5_shift", "ripcurrents_tpu_torch/csrc/warp5_shift.cu",
            "ripcurrents_tpu/flow/warp_pallas.py:89", launches["K7"],
            devs["k7_max"], k7_ms, k7_plain, k7_bytes, k7_ops, k7_lib,
            k7_wall),
        # library: the same grid_sample as K7's, on the same inputs
        row("warp_tiles", "ripcurrents_tpu_torch/csrc/warp_tiles.cu",
            "tools/bench_warp_variants.py:500", launches["K8"],
            devs["k8_max"], k8_ms, k8_plain, k8_nbytes, k8_ops, k7_lib,
            k8_wall),
    ]


def k1b_row(device, launches, rel, per_frame):
    """The JSON row of K1b (farneback_block_sums) at [15]'s rank-1 slab
    (``slab_update_inputs``: level 0, 240 own rows of a 368-row slab,
    128-wide subcolumns): median of 100 profiled launches, its plain
    version's device time and its bound: the own rows' flow read once
    (2 x 240 x 640 float32) and the sums written, one add a value; no
    PyTorch call sums a row window per block, so no library time."""
    prep, flow, _, own = slab_update_inputs(device)
    th, sw, roff = prep["th"], prep["sw"], prep["roff"]
    fn = lambda: fu.farneback_block_sums(flow, th, sw, roff, own)  # noqa
    ms = median_ms(fn, 100, "farneback_block_sums_kernel")
    plain = device_ms(lambda: fu.farneback_block_sums_plain(
        flow, th, sw, roff, own), 10)
    n = 2 * (own[1] - own[0]) * prep["hpwp"][1]
    nbytes = n * 4 + fn().numel() * 8
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, n / F32_FLOPS * 1e3
    return {"name": "farneback_block_sums", "route": "cuda",
            "source": "ripcurrents_tpu_torch/csrc/farneback_update.cu",
            "replaces": "ripcurrents_tpu/flow/fused_update.py:682",
            "launches": launches, "max_abs_err": rel, "ms": ms,
            "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "wall_ms": wall_ms(fn, 100),
            "launches_by_space_path": {
                "legacy --mesh-space 2, per rank and frame": per_frame}}


def bench_rows(device):
    """Phase 8: bench_warp at both tool configurations (CUDA events over
    back-to-back launches), with K8's device time (``call_ms``), its bound
    (``k8_bytes``: the table's 5 bf16 channels, the flow and the f32
    output once each) and its plain version's device time at the same
    inputs."""
    rows = []
    for bres, sw in ((2, None), (1, 640)):
        g = bench_warp.inputs(device, sw)
        res = {v: bench_warp.run(v, bres, sw, g=g)
               for v in bench_warp.VARIANTS}
        k8_dev = call_ms(bench_warp.variant_fn("A", g, bres), 20)[0]
        plain = device_ms(lambda: warp_kernel.warp_tiles_plain(
            g["table"], g["flow"], g["counts"], g["th"], g["sw"], bres), 3)
        rows.append({"bres": bres, "th": g["th"], "sw": g["sw"],
                     "grid": g["grid"],
                     "ms": {v: r["ms"] for v, r in res.items()},
                     "checksum": {v: r["checksum"] for v, r in res.items()},
                     "k8_device_ms": k8_dev,
                     "k8_bound_ms": k8_bytes((g["hp"], g["wp"]), 5, 2) /
                     HBM_BYTES_PER_S * 1e3,
                     "k8_plain_ms": plain})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = kernels.build()
    kernels.entry("farneback_update")
    print(f"[1] kernels built in {time.perf_counter() - t0:.2f} s")
    print(f"[1] K1 clusters the card holds at once, by cluster size: "
          f"{fu.card_clusters()}")
    print(f"[1] K8 clusters the card holds at once, by CTA size and "
          f"cluster size: {warp_kernel.tile_clusters()}; its plans (S, "
          f"CTAs, threads): " + "; ".join(
              f"{name} {hw[0]}x{hw[1]} tile {t}: " + str(tuple(
                  warp_kernel._launch_plan(*hw, *t)[k]
                  for k in ("S", "ctas", "threads")))
              for name, hw, t in [(f"L{k}", hw, t) for k, hw, t, _, _ in
                                  tiled_levels(480, 640)] +
              [("halo", (1080, 1920), (120, 384)),
               ("halo", (1080, 1920), (120, 640))]))
    for stem, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"    {stem}: {line.strip()}")

    devs = check_kernels(480, 640, FarnebackParams.legacy(), dev)
    print(f"[2] 640x480 L0 legacy (bres 4, sw 128, box 3): {devs}")
    devs_hd = check_kernels(1080, 1920, FarnebackParams.windowed(), dev,
                            iterations=1)
    print(f"[2] 1080p L0 windowed (bres 1, sw 640, gauss 10): {devs_hd}")
    k1_levels = {}
    for name, (hw, preset) in K1_PYRAMIDS.items():
        rows, frame_us = update_levels(*hw, preset, dev)
        for r in rows:
            print(f"[2] K1 {name} L{r['level']} {r['hw'][0]}x{r['hw'][1]} "
                  f"(th {r['th']}, sw {r['sw']}, {r['blocks']} blocks, S "
                  f"{r['S']}, {r['ctas']} CTAs, bres {r['bres']}, x"
                  f"{r['iterations']}): max |d| {r['max_abs_err']}; "
                  f"{r['us']:.2f} us/launch on the device (min "
                  f"{r['us_min']:.2f}, max {r['us_max']:.2f}), bound "
                  f"{r['bound_us']:.2f} us")
        print(f"[2] K1 per {name} frame: {frame_us:.2f} us on the device "
              f"(each level's median x its iterations)")
        k1_levels[name] = {"frame_us": frame_us, "levels": rows}
    l0 = k1_levels["legacy 640x480"]["levels"][-1]
    if l0["ctas"] < 120:
        raise AssertionError(f"K1 at 640x480 L0 launches {l0['ctas']} CTAs")
    for name, (hw, preset) in BLUR_CHECKS.items():
        k2_devs = check_blur(*hw, preset, dev)
        k4_devs = check_resize(*hw, preset, dev)
        if name == "legacy 640x480":
            devs["k2_max"] = max(devs["k2_max"], k2_devs["k2_vs_plain"])
            devs.update(k4_devs)
        print(f"[2] K2 at every level of {name} (half {preset.winsize // 2}"
              f"; level, tile): {k2_devs}; K4 at its level changes: "
              f"{k4_devs}")
    for name, (hw, preset) in PREP_CHECKS.items():
        prep_devs = check_prep(*hw, preset, dev)
        if name.startswith("640x480 legacy"):
            devs.update(prep_devs)
        print(f"[2] K5/K6 at every level of the {name} tables: {prep_devs}")
    k7_devs = check_warp(480, 640, dev)
    devs["k7_max"] = k7_devs["max_all"]
    print(f"[2] K7 at 640x480, budget 16, flows up to +-24 px: {k7_devs}")
    print(f"[2] K7 at 75x107, budget 4, flows up to +-7 px: "
          f"{check_warp(75, 107, dev, budget=4, flow_px=7.0)}")
    slab_devs = check_slab_update(dev)
    print(f"[2] K1 at row offset {slab_devs['roff']} (a 368-row slab at "
          f"frame row 112, row tile {slab_devs['th']}), alone and with "
          f"given base sums, and K1b: {slab_devs}")
    k8_devs = check_tiles(dev)
    devs["k8_max"] = max(r["max"] for r in k8_devs.values())
    for name, r in k8_devs.items():
        print(f"[2] K8 {name}: {r}")
    for name, r in check_tiles_new_paths(dev).items():
        devs["k8_max"] = max(devs["k8_max"], r["max"])
        print(f"[2] K8 {name}: {r}")
    per_call = k8_kernels_per_call(dev)
    print(f"[2] K8 device kernels per call: {per_call}")
    if any(len(v) != 1 for v in per_call.values()):
        raise AssertionError(f"K8: expected one kernel per call, got "
                             f"{per_call}")
    lk_devs = check_lk(dev, 201, timeline=True)
    devs["k3_px_max"] = lk_devs["px_max"]
    print(f"[2] K3 at 640x480, 201 timeline vertices: {lk_devs}")
    print(f"[2] K3 at 640x480, 1280 points: {check_lk(dev, 1280)}")
    print(f"[2] K3 at 640x480, 2 streams x 201 points: "
          f"{check_lk(dev, 201, streams=2)}")
    print(f"[2] K3 at 640x480, 192 points, window 21x21: "
          f"{check_lk(dev, 192, p=LKParams.red_points())}")
    print(f"[2] K3 at 240x320, one level, 30 points moving (2, 10) px "
          f"(past the J patch margin): {check_lk_far(dev)}")

    host_ms, ev_ms, launches, share = run_legacy(dev)
    per_frame = tuple(n / FRAMES for n in launches)
    print(f"[3] legacy 640x480, {FRAMES} frames of {RAW_W}x{RAW_H}: "
          f"{host_ms:.3f} ms/frame (host clock), {ev_ms:.3f} ms/frame "
          f"(CUDA events), {1e3 / host_ms:.1f} fps; launches per frame "
          f"K1 {per_frame[0]} K2 {per_frame[1]} K4 {per_frame[2]} K5 "
          f"{per_frame[3]} K6 {per_frame[4]}; mask share {share:.4f}")
    if per_frame != (6.0, 6.0, 2.0, 3.0, 3.0):
        raise AssertionError(f"expected 6 launches of K1 and K2, 2 of K4 and "
                             f"3 of K5 and K6 per frame, got {per_frame}")
    small = compare_legacy_small(dev)
    print(f"[3] legacy 192x256 on the card vs on the CPU: {small}")

    hd_ms, hd_mag = run_stream_1080p(dev)
    print(f"[4] windowed stream 1920x1080: {hd_ms:.3f} ms/frame "
          f"({1e3 / hd_ms:.1f} fps), mean |flow| {hd_mag:.3f} px")
    hd = stream_1080p_breakdown(dev)
    print(f"[4] windowed stream 1920x1080, traced: "
          f"{hd['device_ms_per_frame']:.3f} ms/frame of device kernels, "
          f"{hd['launches_per_frame']:.0f} launches; K5 "
          f"{hd['k5_us_per_frame']:.2f} us and K6 {hd['k6_us_per_frame']:.2f}"
          f" us per frame ({hd['k5_records']} and {hd['k6_records']} "
          f"records), {100 * hd['prep_share']:.1f}% of the device time; K2 "
          f"{hd['k2_us_per_frame']:.2f} us ({hd['k2_records']} records) and "
          f"K4 {hd['k4_us_per_frame']:.2f} us ({hd['k4_records']}) per "
          f"frame; top kernels (us/frame) {hd['top_us_per_frame']}")

    tl_ms, tl_ev, tl_launches, _, _ = run_mode(dev, "timelines", FRAMES)
    print(f"[6] timelines 640x480, 201 vertices, {FRAMES} frames of "
          f"{RAW_W}x{RAW_H}: {tl_ms:.3f} ms/frame (host clock), "
          f"{tl_ev:.3f} ms/frame (CUDA events), {1e3 / tl_ms:.1f} fps; K3 "
          f"launches per frame {tl_launches / FRAMES}")
    if tl_launches != FRAMES:
        raise AssertionError(f"expected one K3 launch per frame, got "
                             f"{tl_launches} in {FRAMES} frames")
    for mode, n in (("streaklines", 10), ("populationMap", 5),
                    ("flowRedPoints", 5)):
        m_ms, m_ev, m_launches, verts, _ = run_mode(dev, mode, n)
        print(f"[6] {mode} 640x480, {verts.numel() // 2} vertices, {n} "
              f"frames: {m_ms:.3f} ms/frame (host clock), {m_ev:.3f} "
              f"ms/frame (CUDA events); K3 launches per frame "
              f"{m_launches / n}")
        if m_launches != n:
            raise AssertionError(f"{mode}: expected one K3 launch per "
                                 f"frame, got {m_launches} in {n}")
    print(f"[6] timelines 192x256 on the card vs on the CPU: "
          f"{compare_timelines_small(dev)}")

    dense = {}
    for mode, n in (("subtructAverageVectorWithWindow", FRAMES),
                    ("streamlines", 5), ("timelinesOnSubtractAverageVector", 5),
                    ("timelinesFarne", 5), ("subtructAverageVector", 5),
                    ("shearRate", 5), ("averageVector", 5)):
        dense[mode] = run_dense_mode(dev, mode, n)
        m_ms, m_ev, m_n, _ = dense[mode]
        iters = getattr(FarnebackParams, "windowed" if mode in (
            "subtructAverageVectorWithWindow", "shearRate") else
            "streamlines" if mode in ("streamlines",
                                      "timelinesOnSubtractAverageVector")
            else "subtract_average")().iterations
        want = {"K1": 3 * iters * n, "K2": 3 * iters * n, "K3": 0,
                "K4": 2 * n, "K5": 3 * (n + 1), "K6": 3 * (n + 1), "K7": 0,
                "K8": 0}
        print(f"[7] {mode} 640x480, {n} frames of {RAW_W}x{RAW_H}: "
              f"{m_ms:.3f} ms/frame (host clock), {m_ev:.3f} ms/frame (CUDA "
              f"events), {1e3 / m_ms:.1f} fps; launches {m_n}")
        if m_n != want:
            raise AssertionError(f"{mode}: expected launches {want}")
    held, peak = ring_step_memory(dev)
    print(f"[7] averageVector 640x480: its state holds {held:.1f} MiB of "
          f"device memory after init; the peak over 5 steps is {peak:.1f} "
          f"MiB (ring_update writes a new ring each step)")
    pallas_cfg = ModeConfig(warp_impl="pallas")
    n = 10
    p_ms, p_ev, p_n, _ = run_dense_mode(dev, "subtructAverageVector", n,
                                        pallas_cfg)
    print(f"[7] subtructAverageVector 640x480 on the portable engine "
          f"(warp_impl='pallas'), {n} frames: {p_ms:.3f} ms/frame (host "
          f"clock), {p_ev:.3f} ms/frame (CUDA events); launches {p_n}, K7 "
          f"{p_n['K7'] / n} per frame")
    want = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 3 * (n + 1),
            "K6": 3 * (n + 1), "K7": 9 * n, "K8": 0}
    if p_n != want:
        raise AssertionError(f"portable engine: expected launches {want}")
    t_ms, t_ev, t_n, _ = run_dense_mode(dev, "subtructAverageVector", n,
                                        ModeConfig(warp_impl="tiled"))
    print(f"[7] subtructAverageVector 640x480 on the tiled warp "
          f"(warp_impl='tiled'), {n} frames: {t_ms:.3f} ms/frame (host "
          f"clock), {t_ev:.3f} ms/frame (CUDA events); launches {t_n}, K8 "
          f"{t_n['K8'] / n} per frame")
    want = dict(want, K7=0, K8=9 * n)
    if t_n != want:
        raise AssertionError(f"tiled warp: expected launches {want}")
    tiled_k8 = t_n["K8"] / n
    k8_frame = k8_kernels_per_frame(dev)
    print(f"[7] K8 in one traced 640x480 frame of the tiled engine: "
          f"{k8_frame['device_kernels']} device kernels, "
          f"{k8_frame['calls']} calls")
    if k8_frame != {"device_kernels": 9, "calls": 9}:
        raise AssertionError(f"tiled engine: expected 9 K8 kernels and "
                             f"calls per frame, got {k8_frame}")
    print(f"[7] subtructAverageVectorWithWindow 192x256 on the card vs on "
          f"the CPU: {compare_dense_small(dev)}")
    print(f"[7] subtructAverageVectorWithWindow (warp_impl='tiled') "
          f"192x256 on the card vs on the CPU: "
          f"{compare_dense_small(dev, cfg=TILED_SMALL)}")
    for impl in ("tiled", "fused"):
        sav = dense_small_readings(dev, "subtructAverageVector", 3,
                                   ModeConfig(xdim=256, ydim=192,
                                              warp_impl=impl))
        print(f"[7] subtructAverageVector (warp_impl={impl!r}) 192x256 on "
              f"the card vs on the CPU (pixels read, not bounded): {sav}")
        if sav["ring_mean_median_px"] > DENSE_MEDIAN_PX or \
                sav["ring_mean_p99_px"] > DENSE_P99_PX:
            raise AssertionError(f"subtructAverageVector ({impl}) on {dev} "
                                 f"vs CPU: {sav}")

    launches = dict(zip(("K1", "K2", "K4", "K5", "K6"), launches),
                    K3=tl_launches, K7=p_n["K7"], K8=t_n["K8"])
    rows = kernel_rows(dev, launches, devs)
    for r in rows:
        lib = r["library_ms"]
        print(f"[5] {r['name']}: {r['ms'] * 1e3:.2f} us/launch on the "
              f"device ({r['wall_ms'] * 1e3:.2f} us per back-to-back call "
              f"with the host), plain {r['plain_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), library "
              f"{'-' if lib is None else f'{lib * 1e3:.2f} us'}")
    prep = {}
    for name, (hw, preset) in PREP_PYRAMIDS.items():
        levels, frame = prep_levels(*hw, preset, dev)
        for r in levels:
            print(f"[5] K5/K6 {name} L{r['level']} {r['hw'][0]}x{r['hw'][1]}"
                  f" (canvas {r['canvas'][0]}x{r['canvas'][1]}, window "
                  f"{r['window']}): K5 {r['k5_us']:.2f} us (min "
                  f"{r['k5_us_min']:.2f}, max {r['k5_us_max']:.2f}), bound "
                  f"{r['k5_bound_us']:.2f} ({r['k5_bound_by']}), issue floor "
                  f"{r['k5_floor_us']:.2f}; K6 {r['k6_us']:.2f} us (min "
                  f"{r['k6_us_min']:.2f}, max {r['k6_us_max']:.2f}), bound "
                  f"{r['k6_bound_us']:.2f} ({r['k6_bound_by']}), issue floor "
                  f"{r['k6_floor_us']:.2f}")
        print(f"[5] K5/K6 per {name} frame: K5 {frame['k5_us']:.2f} us "
              f"(bound {frame['k5_bound_us']:.2f}), K6 {frame['k6_us']:.2f} "
              f"us (bound {frame['k6_bound_us']:.2f}) on the device")
        prep[name] = (levels, frame)
    blur = blur_upsample_frames(dev)
    for name, res in blur.items():
        for key, kernel in (("k2", "K2"), ("k4", "K4")):
            levels, frame = res[key]
            for r in levels:
                where = (f"L{r['level']} {r['hw'][0]}x{r['hw'][1]} (padded "
                         f"{r['hpwp'][0]}x{r['hpwp'][1]}, half {r['half']}, "
                         f"x{r['iterations']})" if key == "k2" else
                         f"{r['src'][0]}x{r['src'][1]} -> {r['dst'][0]}x"
                         f"{r['dst'][1]} (padded {r['dst_pad'][0]}x"
                         f"{r['dst_pad'][1]})")
                print(f"[5] {kernel} {name} {where}: {r['us']:.2f} us (min "
                      f"{r['us_min']:.2f}, max {r['us_max']:.2f}), bound "
                      f"{r['bound_us']:.2f} ({r['bound_by']}), issue floor "
                      f"{r['floor_us']:.2f}")
            print(f"[5] {kernel} per {name} frame: {frame['us']:.2f} us on "
                  f"the device (bound {frame['bound_us']:.2f}, issue floor "
                  f"{frame['floor_us']:.2f})")
    k8 = k8_levels(dev)
    for r in k8["levels"]:
        print(f"[5] K8 tiled 640x480 L{r['level']} {r['hw'][0]}x"
              f"{r['hw'][1]} (tile {r['tile'][0]}x{r['tile'][1]}, bres "
              f"{r['bres']}, x{r['iterations']}): {r['us']:.2f} us/call on "
              f"the device ({r['kernels']} kernel), bound "
              f"{r['bound_us']:.2f} us (bytes)")
    print(f"[5] K8 per tiled-engine 640x480 frame: {k8['frame']['us']:.2f} "
          f"us on the device, {k8['frame']['kernels']} kernels (bound "
          f"{k8['frame']['bound_us']:.2f} us); 1080p halo (A, floor Z, "
          f"bound, us): {k8['halo_1080p']}")
    k8_new = k8_new_paths(dev)
    for r in k8_new["levels"]:
        print(f"[5] K8 {r['path']} {r['hw'][0]}x{r['hw'][1]} C{r['channels']}"
              f": {r['us']:.2f} us/call on the device, bound "
              f"{r['bound_us']:.2f} us (bytes)")
    print(f"[5] K8 per dense_lk 640x480 call (120 calls): "
          f"{k8_new['dense_lk_call']['us']:.2f} us on the device (bound "
          f"{k8_new['dense_lk_call']['bound_us']:.2f}); per stabilizeTPU "
          f"frame: {k8_new['stabilize_frame']['us']:.2f} us (bound "
          f"{k8_new['stabilize_frame']['bound_us']:.2f})")
    rows[-1]["new_paths_us"] = {"dense_lk_call": k8_new["dense_lk_call"],
                                "stabilize_frame": k8_new["stabilize_frame"]}
    k7_gs = k7_against_grid_sample(dev)
    print(f"[5] K7 and grid_sample at 640x480, budget 16, alternated "
          f"(median us of 50 launches per turn): {k7_gs}")
    bench = bench_rows(dev)
    for b in bench:
        ms = "  ".join(f"{v} {t * 1e3:.2f} us" for v, t in b["ms"].items())
        print(f"[8] bench_warp 1080x1920 bres {b['bres']} sw {b['sw']} (th "
              f"{b['th']}, grid {b['grid'][0]}x{b['grid'][1]}): {ms}; K8 "
              f"{b['k8_device_ms'] * 1e3:.2f} us on the device, bound "
              f"{b['k8_bound_ms'] * 1e3:.2f} us (bytes), plain "
              f"{b['k8_plain_ms'] * 1e3:.2f} us; checksums {b['checksum']}")
    rows[-1]["ms_1080p_halo"] = {f"bres{b['bres']}_sw{b['sw']}":
                                 b["k8_device_ms"] for b in bench}
    rows[-1]["us_per_tiled_frame"] = k8["frame"]["us"]
    rows[-1]["levels_us"] = [[r["level"], r["us"], r["bound_us"]]
                             for r in k8["levels"]]
    rows[0]["us_per_frame"] = {k: v["frame_us"] for k, v in
                               k1_levels.items()}
    rows[0]["levels_us"] = {k: [[r["level"], r["S"], r["ctas"],
                                 r["us"], r["bound_us"]]
                                for r in v["levels"]]
                            for k, v in k1_levels.items()}
    for i, key in ((4, "k5"), (5, "k6")):
        rows[i]["us_per_frame"] = {k: v[1][f"{key}_us"]
                                   for k, v in prep.items()}
        rows[i]["levels_us"] = {k: [[r["level"], r[f"{key}_us"],
                                     r[f"{key}_bound_us"]] for r in v[0]]
                                for k, v in prep.items()}
    rows[4]["k5_k6_share_of_1080p_frame"] = hd["prep_share"]
    for i, key in ((1, "k2"), (3, "k4")):
        rows[i]["us_per_frame"] = {k: v[key][1]["us"]
                                   for k, v in blur.items()}
        rows[i]["levels_us"] = {k: [[r["us"], r["bound_us"]]
                                    for r in v[key][0]]
                                for k, v in blur.items()}
        rows[i]["us_per_1080p_stream_frame"] = hd[f"{key}_us_per_frame"]
    rows[6]["alternated_us"] = k7_gs

    for mode, n in (("android", 6), ("averageHSV", 5), ("timex", 5),
                    ("brightColor", 5), ("phaseCorrelate", 5),
                    ("globalOrientation", 5)):
        m_ms, m_n, m_kernels, _ = run_simple_mode(dev, mode, n)
        per_frame = {k: v / n for k, v in m_n.items()}
        start = " from i = 89 (across the overlay warmup)" \
            if mode == "android" else ""
        print(f"[9] {mode} 640x480, {n} frames of {RAW_W}x{RAW_H}{start}"
              f": {m_ms:.3f} ms/frame (host clock), {m_kernels} device "
              f"kernels per frame (one traced frame); launches per frame "
              f"{per_frame}")
        want = ANDROID_LAUNCHES if mode == "android" else \
            dict.fromkeys(ANDROID_LAUNCHES, 0)
        if per_frame != want:
            raise AssertionError(f"{mode}: expected launches per frame "
                                 f"{want}")
    held, peak = ring_step_memory(dev, mode="averageHSV")
    print(f"[9] averageHSV 640x480: its state holds {held:.1f} MiB of "
          f"device memory after init; the peak over 5 steps is {peak:.1f} "
          f"MiB (ring_update writes a new ring each step)")
    for mode in SIMPLE_MODES:
        print(f"[9] {mode} 192x256 on the card vs on the CPU: "
              f"{compare_simple_small(dev, mode)}")

    golden = detector_golden_1080p(dev)
    print(f"[10] detector_1080p_iou {golden['detector_1080p_iou']:.4f}, "
          f"detector_1080p_mask_frac {golden['detector_1080p_mask_frac']:.4f}"
          f" (oracle {golden['oracle_mask_frac']:.4f}); detector_mask_scan "
          f"over 48 frames of 1920x1080: {golden['host_ms_per_frame']:.3f} "
          f"ms/frame (host clock); launches {golden['launches']}")
    stab_k8 = {}
    for features in ("harris", "akaze"):
        r = run_stabilize(dev, features)
        stab_k8[features] = r["launches_per_frame"]["K8"]
        print(f"[11] stabilizeTPU ({features}) 640x480, {STAB_FRAMES} frames "
              f"of a jittered clip through run_frames: "
              f"{r['host_ms_per_frame']:.3f} ms/frame (host clock); "
              f"{r['device_ms_per_frame']:.3f} ms/frame of device kernels, "
              f"{r['device_kernels_per_frame']:.0f} device kernels per "
              f"frame (traced), busy share {100 * r['busy_share']:.1f}%; "
              f"launches per frame {r['launches_per_frame']}; host syncs "
              f"per frame {r['host_syncs_per_frame']} ({r['syncs']}); "
              f"top kernels (us/frame) {r['top_kernels_us_per_frame']}; "
              f"residual jitter {r['output_jitter_px']:.4f} px against the "
              f"raw {r['raw_jitter_px']:.4f} px (limit {STAB_RESIDUAL} x "
              f"raw)")
        print(f"[11] stabilizeTPU ({features}) 192x256 on the card vs on "
              f"the CPU, the CPU's RANSAC noise injected (per step: H's "
              f"frame-corner distance px, inliers card / CPU, equal pixel "
              f"share, share more than one level apart): "
              f"{compare_stabilize_small(dev, features)}")
    work = benchmark_work(dev)
    lkw = work["dense_lk"]
    print(f"[12] benchmark work, one 640x480 pair: farneback "
          f"{work['farneback']['ms']:.2f} ms (launches "
          f"{work['farneback']['launches']}); dense_lk (dense grid, "
          f"{480 * 640} points) {lkw['ms']:.2f} ms, launches "
          f"{lkw['launches']}; traced: {lkw['device_ms']:.3f} ms of device "
          f"kernels, {lkw['device_kernels']} device kernels, busy share "
          f"{100 * lkw['busy_share']:.1f}%, host syncs "
          f"{lkw['host_syncs']}, top kernels (us) {lkw['top_kernels_us']}; "
          f"status share "
          f"{lkw['status_share']:.4f}, mean flow {lkw['mean_flow']}")
    print(f"[12] dense_lk 192x256 on the card vs on the CPU: "
          f"{compare_dense_lk_small(dev)}")
    print(f"[12] farneback_stream_lagged vs farneback_stream on the card, "
          f"640x480, 4 flows (max |d| each): {check_lagged(dev)}")
    rows[-1]["launches_by_path"] = {
        "tiled engine per 640x480 frame": tiled_k8,
        "stabilizeTPU per frame (harris, akaze)": [stab_k8["harris"],
                                                   stab_k8["akaze"]],
        "dense_lk per 640x480 call": lkw["launches"]["K8"]}

    t0 = time.perf_counter()
    c = cli_phase(dev)
    print(f"[13] frame pump 1280x720 -> 640x480, 8 frames: {c['pump']}")
    for name in ("no host prep", "pump"):
        print(f"[13] cli.main --mode legacy ({name}), {FRAMES} frames of "
              f"{RAW_W}x{RAW_H}: {c['legacy'][name]}")
    print(f"[13] legacy: cli.main's frames (no host prep) equal "
          f"run_frames' bit for bit; ms/frame (host clock, runs in the "
          f"order A B C C B A) {c['legacy']['ms_per_frame']}; launches per "
          f"frame {c['legacy']['launches_per_frame']}")
    print(f"[13] cli.main --mode timelines, {FRAMES} frames: "
          f"{c['timelines']}; frames (no host prep) equal run_frames' bit "
          f"for bit")
    print(f"[13] subtructAverageVector from 640x480 frames: gray upload vs "
          f"BGR upload {c['gray_upload']}")
    print(f"[13] cli.main --mode legacy --no-output: {c['no_output']}")
    for mode, r in c["resume"].items():
        print(f"[13] kill and resume, {mode}: {r}; bit-identical")
    print(f"[13] --mode benchmark: {c['benchmark']}")
    print(f"[13] --mode validate: {c['validate']}")
    print(f"[13] --mode legacy-full: {c['legacy_full']}")
    print(f"[13] phase 13 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    v = videos_phase(dev)
    print(f"[14] cli.main --videos --mode legacy --no-host-prep, {FRAMES} "
          f"frames of {RAW_W}x{RAW_H} a stream, N = 1, 2, 4: every stream's "
          f"frames equal run_frames' of its clip bit for bit, launches N x "
          f"one stream's; per lock-step frame at N = 4: "
          f"{v['launches_x4_per_lockstep_frame']}")
    print(f"[14] fps (host clock; runs in the order single, N = 1, 2, 4, 4, "
          f"2, 1, single): run_video of one clip {v['single_fps']} (stages "
          f"s {v['single_stages_s']}); " + "; ".join(
              f"N = {n}: aggregate {v[f'x{n}']['aggregate_fps']}, per "
              f"stream {v[f'x{n}']['per_stream_fps']} (stages s "
              f"{v[f'x{n}']['stages_s']})" for n in (1, 2, 4)))
    print(f"[14] traced N = 4 run: {v['x4'].get('traced')}")
    print(f"[14] cli.main --videos --mode timelines, N = 2: "
          f"{v['timelines_x2']}; frames equal run_frames' bit for bit")
    print(f"[14] clips of 40 and 25 frames: {v['unequal']} (stopped at the "
          f"shorter; no producer thread left; metrics written)")
    sp = spatial_phase(dev)
    for r, rank in enumerate(sp["ranks"]):
        print(f"[14] farneback_spatial 1920x1080, 2 ranks sharing the card "
              f"(gloo), halo 128, rank {r} band {rank['band']}: " +
              "; ".join(f"{name} {rank[name]['ms_per_pair']:.2f} ms a "
                        f"pair, launches a pair "
                        f"{rank[name]['launches_per_pair']}"
                        for name in SPATIAL_ENGINES) +
              f"; halo exchange (2 x 256 rows through host memory) ms "
              f"{[round(t, 3) for t in rank['exchange_ms']]}")
    print(f"[14] farneback_spatial against one process's farneback "
          f"(bounds {SPATIAL_BOUNDS}): tiled (windowed, levels 1) "
          f"{sp['tiled']}; fused (windowed) {sp['fused']}")
    farm = farm_phase(dev)
    print(f"[14] stream farm, 2 processes on the card (--coordinator, "
          f"gloo), 2 legacy clips each: all_streams_fps "
          f"{farm[0]['all_streams_fps']} = "
          f"{farm[0]['metrics']['aggregate_fps']} + "
          f"{farm[1]['metrics']['aggregate_fps']} in both ranks; one "
          f"process's N = 4 aggregate {v['x4']['aggregate_fps']}; rank "
          f"stages s {[f['metrics']['stages_s'] for f in farm]}")
    for i, k in enumerate(K_ROWS):
        rows[i]["launches_by_multi_device_path"] = {
            "run_videos legacy N = 4, per lock-step frame":
                v["launches_x4_per_lockstep_frame"][k],
            "run_videos timelines N = 2, per lock-step frame":
                v["timelines_x2"]["launches_per_lockstep_frame"][k],
            "farneback_spatial 1080p tiled, per rank and pair":
                sp["ranks"][0]["tiled"]["launches_per_pair"][k],
            "farneback_spatial 1080p fused, per rank and pair":
                sp["ranks"][0]["fused"]["launches_per_pair"][k]}
    print(f"[14] phase 14 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sf = space_phase(dev)
    tm = sf["timing"]
    print(f"[15] cli.main --videos --mesh-space 2, 2 processes sharing the "
          f"card ({tm['backend']}), mesh {tm['mesh']}, halo {tm['halo']}, "
          f"{FRAMES} frames of {RAW_W}x{RAW_H} at 640x480: timelines bit "
          f"for bit equal to run_frames ({sf['timelines_equal']}); legacy "
          f"overlays equal on {sf['overlay_share']:.6f}, rip masks on "
          f"{sf['mask_share']:.6f} of pixels; worst frame's flow against "
          f"one process {sf['flow_worst']} (bounds {SPATIAL_BOUNDS}); UPPER "
          f"equal on both ranks every frame ({sf['upper_equal']}); slab "
          f"rows {[r['slab_rows'] for r in sf['ranks']]}")
    for r, rank in enumerate(sf["ranks"]):
        print(f"[15] rank {r} launches: legacy "
              f"{rank['legacy']['launches']}, timelines "
              f"{rank['timelines']['launches']} ({FRAMES} frames)")
    print(f"[15] ms a frame per rank (host clock, legacy): "
          f"{[round(x['ms_per_frame'], 3) for x in tm['ranks']]}; one "
          f"process, same clip: {tm['one_process_ms_per_frame']:.3f}; "
          f"exchanges per rank and frame: " + "; ".join(
              f"{x['exchanges_per_frame']:.3f} calls, "
              f"{x['exchange_ms_per_frame']:.3f} ms, "
              f"{x['exchange_bytes_per_frame']:.0f} B (output gather "
              f"{x['output_gather_ms_per_frame']:.3f} ms)"
              for x in tm["ranks"]) +
          f"; timelines ms a frame per rank "
          f"{[round(x, 3) for x in tm['timelines_ms_per_frame']]}; card: "
          f"{card}")
    for r, x in enumerate(tm["ranks"]):
        print(f"[15] rank {r} legacy exchanges by kind (ms, bytes, calls a "
              f"frame): " + "; ".join(
                  f"{k} {v[0]:.3f} ms, {v[1]:.0f} B, {v[2]:.3f}"
                  for k, v in x["by_label_ms_bytes_calls_per_frame"].items()))
    per_rank = {k: v / FRAMES for k, v in
                sf["ranks"][0]["legacy"]["launches"].items()}
    per_rank_tl = {k: v / FRAMES for k, v in
                   sf["ranks"][0]["timelines"]["launches"].items()}
    for i, k in enumerate(K_ROWS):
        rows[i]["launches_by_space_path"] = {
            "legacy --mesh-space 2, per rank and frame": per_rank[k],
            "timelines --mesh-space 2, per rank and frame": per_rank_tl[k]}
    rows.append(k1b_row(dev, sf["ranks"][0]["legacy"]["launches"]["K1b"],
                        slab_devs["k1b_rel"], per_rank["K1b"]))
    print(f"[15] phase 15 took {time.perf_counter() - t0:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--compare-parent":
        compare_parent(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
