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
   legacy and dense-mode 640x480 pyramids and of the 1080p windowed one,
   with its cluster size S, CTAs, device time (median of 50 launches) and
   bound per level and its device time per frame; K2 at every level (its
   tile per level; pads zeroed, and at level 0 also not) and K4
   (resize_cf_padded) against its plain version and the dense two-matmul
   form at every level change of the eight ``BLUR_CHECKS`` geometries,
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
   included; one device kernel per K8 call in each layout;
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
   K1 and ``grid_sample``, with K8's bound and plain version.

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

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from ripcurrents_tpu_torch import bench_warp, kernels
from ripcurrents_tpu_torch.config import FarnebackParams, LKParams
from ripcurrents_tpu_torch.dynamics.particles import timeline_init
from ripcurrents_tpu_torch.flow import farneback as fb
from ripcurrents_tpu_torch.flow import fused_update as fu
from ripcurrents_tpu_torch.flow import lucas_kanade as lk
from ripcurrents_tpu_torch.flow import prep_kernel, warp_kernel
from ripcurrents_tpu_torch.flow.lk_kernel import (PATCH_MARGIN, lk_track,
                                                  lk_track_plain)
from ripcurrents_tpu_torch.ops import image as img_ops
from ripcurrents_tpu_torch.pipelines import modes, runner
from ripcurrents_tpu_torch.pipelines.common import MODES, ModeConfig
from ripcurrents_tpu_torch.pipelines.legacy import make_legacy
from ripcurrents_tpu_torch.synthetic import moving_frames
from ripcurrents_tpu_torch.trace_legacy import (launch_counts,
                                                reset_launches)

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
# The pyramids whose every level K1 is checked and timed at: the legacy
# detector's, the dense modes' (windowed() and subtract_average() share
# these K1 geometries at 640x480) and the 1080p windowed stream's.
K1_PYRAMIDS = {
    "legacy 640x480": ((480, 640), FarnebackParams.legacy()),
    "dense 640x480": ((480, 640), FarnebackParams.windowed()),
    "windowed 1080p": ((1080, 1920), FarnebackParams.windowed()),
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
# levels) and android's 4-level pyramid (a 260-tap L3 window).
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
}
# The geometries K2 and K4 are held to their plain versions at, every level
# (K2) and every level change (K4): the main paths' pyramids (legacy box 3,
# the dense modes' windowed Gaussian 10 and subtract_average's Gaussian
# 20, the 1080p stream), android's 4 levels (box 5), a ragged width, the
# 40x300 pyramid, and subtract_average at 40x300, whose 10- and 20-row
# levels are shorter than its 21-row window.
BLUR_CHECKS = {
    "legacy 640x480": ((480, 640), FarnebackParams.legacy()),
    "windowed 640x480": ((480, 640), FarnebackParams.windowed()),
    "subtract_average 640x480": ((480, 640),
                                 FarnebackParams.subtract_average()),
    "windowed 1080p": ((1080, 1920), FarnebackParams.windowed()),
    "android 640x480": ((480, 640), FarnebackParams.android()),
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


def check_update(prep, flow, bres):
    """K1 against its plain version on one level's inputs. Returns |d|,
    the share of elements that differ and the plain M; raises past
    K1_REL / K1_FRAC."""
    m = fu.farneback_update(prep, flow, bres)
    m_plain = fu.farneback_update_plain(
        prep["p0"], prep["p1"], flow, prep["counts"], prep["hw"],
        prep["th"], prep["sw"], bres)
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
        got = warp_kernel.warp_tiles(table, flow, None, th, tw, bres)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        plain = warp_kernel.warp_tiles_plain(table, flow, None, th, tw, bres)
        counts = warp_kernel.frame_counts(h, w, th, tw, device)
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
                not 0.0 < res["residual_clamped_share"] < 1.0 or \
                got.shape != (h, w, c):
            raise AssertionError(f"K8 frame layout, {name}: {res}")
        out[f"frame {name} C{c} bres {bres}"] = res
    return out


def k8_kernels_per_call(device):
    """Device kernels one K8 call launches in each layout (torch.profiler
    records of one call after a warm one): {layout: [kernel names]}."""
    g = halo_tiles_inputs(device, 2, None)
    table, flow = frame_tiles_inputs(480, 640, 5, 2, device)
    calls = {"halo": lambda: warp_kernel.warp_tiles(
                 g["table"], g["flow"], g["counts"], g["th"], g["sw"], 2),
             "frame": lambda: warp_kernel.warp_tiles(table, flow, None, 64,
                                                     256, 2)}
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out[name] = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    return out


def k8_kernels_per_frame(device, h=480, w=640):
    """K8's device kernels in one frame of the tiled engine at (h, w): the
    torch.profiler records (after a warm frame) whose name holds
    "warp_tiles" or "tile_sums", and the wrapper's launches."""
    f = moving_frames(2, h, w, device, color=False)
    e0, e1 = (fb.farneback_precompute(f[i], TILED_PRESET) for i in (0, 1))
    step = lambda: fb.farneback_from_expansions(  # noqa: E731
        e0, e1, (h, w), TILED_PRESET)
    step()
    torch.cuda.synchronize()
    before = warp_kernel.warp_tiles.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and
             ("warp_tiles" in e.name or "tile_sums" in e.name)]
    return {"device_kernels": len(names),
            "calls": warp_kernel.warp_tiles.launches - before}


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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in range(warm + 1, warm + frames + 1):
            _, exp = fb.farneback_stream(exp, gray[t], p)
        torch.cuda.synchronize(device)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
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


def ring_step_memory(device, steps=5, cfg: ModeConfig = ModeConfig()):
    """``averageVector`` (its 300-frame ring) stepped by hand at 640x480:
    (MiB of device memory its state holds after init, MiB of the peak
    during `steps` steps above what was allocated before init)."""
    raw = moving_frames(steps + 1, RAW_H, RAW_W, device)
    init, step = MODES["averageVector"](cfg, device=device)
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
    k8_devs = check_tiles(dev)
    devs["k8_max"] = max(r["max"] for r in k8_devs.values())
    for name, r in k8_devs.items():
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
