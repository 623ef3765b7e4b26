#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their
plain PyTorch versions.

Run from the repository root on a machine with one Hopper card and the
CUDA toolkit:

    python3 chip_smoke.py

Every phase passes or raises (the script catches nothing):

1. the card's name and power limit; build the seven kernels of ``csrc/``
   with nvcc for sm_90a and print the build time and the ptxas report;
2. K1 (farneback_update), K2 (farneback_blur_solve) and the level loop
   against their plain versions on the card, at the main path's shapes:
   640x480 level 0 of the legacy preset (table (5, 544, 896) bf16, bres 4,
   128-wide subcolumns, box 3) and 1080p level 0 of the windowed preset
   (bres 1, 640-wide subcolumns, Gaussian 10); K4 (resize_cf_padded)
   against its plain version and the dense two-matmul form at every level
   change of both; K3 (lk_track) against its plain version at 640x480
   with 201 points, 1280 points and 2 streams x 201 points, border and
   out-of-image points included; K5 (prep_y) and K6 (prep_x3) against
   their plain versions and the dense matmul form at every level of the
   640x480 legacy and 1080p windowed tables and of the 640x480
   channels-last tables of the portable engine; K7 (warp5_shift) against
   its plain version at 640x480 with flows inside and beyond +-16 px;
3. the legacy rip detector (``make_legacy``, 250 seeds) on 40 synthetic
   1280x720 moving-texture frames at 640x480: finite outputs of the right
   shapes, a live duty mask, K1 and K2 each launched 6 times, K4 twice and
   K5 and K6 3 times per frame; then the whole step at 192x256 on the card
   against the same step on the CPU (plain versions);
4. the windowed Farneback stream at 1920x1080;
5. each kernel's time per launch at the 640x480 shapes beside its plain
   version, its bound and a library call, as one JSON line;
6. the particle modes through ``run_frames`` at 640x480 from 1280x720
   frames: ``timelines`` (201 vertices, 40 frames, K3 once per frame),
   ``streaklines`` (1280 vertices), ``populationMap`` and
   ``flowRedPoints``; then ``timelines`` at 192x256 on the card against
   the same steps on the CPU;
7. the dense Farneback modes through ``run_frames`` at 640x480 from
   1280x720 frames: ``subtructAverageVectorWithWindow`` for 40 frames, the
   other six for a few frames each (``averageVector`` with its 300-frame
   ring), then ``subtructAverageVector`` on the portable engine
   (``warp_impl="pallas"``: K7 9 times per frame); then
   ``subtructAverageVectorWithWindow`` at 192x256 on the card against the
   same steps on the CPU.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels JSON, and the card's name and power limit come before
that. Without a card the script exits non-zero before printing a result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from ripcurrents_tpu_torch import kernels
from ripcurrents_tpu_torch.config import FarnebackParams, LKParams
from ripcurrents_tpu_torch.dynamics.particles import timeline_init
from ripcurrents_tpu_torch.flow import farneback as fb
from ripcurrents_tpu_torch.flow import fused_update as fu
from ripcurrents_tpu_torch.flow import lucas_kanade as lk
from ripcurrents_tpu_torch.flow import prep_kernel, warp_kernel
from ripcurrents_tpu_torch.flow.lk_kernel import lk_track, lk_track_plain
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
K2_TOL = 1e-5               # flow: |d| <= K2_TOL * (1 + |plain|)
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


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def level0_inputs(h, w, p: FarnebackParams, device, seed=0, flow_px=4.0):
    """Level-0 kernel inputs of preset p at (h, w): both frames' real
    expansion tables (the port's prep of two moving-texture frames) and a
    smooth random flow of up to +-flow_px with zero pads."""
    f = moving_frames(2, h, w, device, seed=seed, color=False)
    e0 = fb.farneback_precompute(f[0], p)[-1]
    e1 = fb.farneback_precompute(f[1], p)[-1]
    subcol = p.warp_subcol_hires if h * w >= p.warp_hires_px \
        else p.warp_subcol
    prep = fu.prepare_expansions(e0, e1, fu._row_tile(h), hw=(h, w),
                                 subcol=subcol)
    hp, wp = prep["hpwp"]
    g = torch.Generator().manual_seed(seed + 1)
    coarse = (torch.rand((1, 2, h // 16 + 2, w // 16 + 2), generator=g)
              * 2 - 1) * flow_px
    fl = F.interpolate(coarse, size=(h, w), mode="bilinear",
                       align_corners=False)[0]
    flow = torch.zeros((2, hp, wp), dtype=torch.float32)
    flow[:, :h, :w] = fl
    return prep, flow.to(device)


def _bres(p: FarnebackParams, h, w):
    wr = p.warp_residual_hires if (h * w >= p.warp_hires_px and
                                   p.warp_residual_hires is not None) \
        else p.warp_residual
    return wr[0] if isinstance(wr, tuple) else wr


def check_kernels(h, w, p: FarnebackParams, device, iterations=2):
    """K1, K2 and the level loop against their plain versions at level 0
    of preset p. Returns the deviations; raises past the bounds."""
    bres = _bres(p, h, w)
    prep, flow = level0_inputs(h, w, p, device)
    args = (prep["p0"], prep["p1"], flow, prep["counts"], prep["hw"],
            prep["th"], prep["sw"], bres)
    m = fu.farneback_update(prep, flow, bres)
    m_plain = fu.farneback_update_plain(*args)
    a, b = m.float(), m_plain.float()
    d1 = (a - b).abs()
    frac1 = (d1 > 0).float().mean().item()
    if not (bool((d1 <= K1_REL * b.abs()).all()) and frac1 <= K1_FRAC):
        raise AssertionError(f"K1 disagrees at {h}x{w}: max {d1.max()}, "
                             f"differing share {frac1}")

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
    pyr_prev, pyr_next, derivs = lk.prepare(prev, nxt, p)
    out, iters = lk_track(pyr_prev, pyr_next, derivs, pts, p)
    if device.type == "cuda":
        torch.cuda.synchronize(device)   # a fault in the kernel shows here
    ref, ref_iters = lk_track_plain(pyr_prev, pyr_next, derivs, pts, p)
    st, st_ref = out[..., 2] > 0.5, ref[..., 2] > 0.5
    both = st & st_ref
    d = (out[..., :2] - ref[..., :2]).norm(dim=-1)
    finite = torch.isfinite(d)
    if not bool(finite.all()) or int(both.sum()) < n * streams // 2:
        raise AssertionError(f"K3: {int((~finite).sum())} non-finite "
                             f"points, {int(both.sum())} tracked")
    dt = d[both]
    res = {"points": n * streams, "tracked": int(both.sum()),
           "px_max": d.max().item(), "px_median": dt.median().item(),
           "share_within": (dt <= LK_PX).float().mean().item(),
           "status_equal": (st == st_ref).float().mean().item(),
           "err_excess": ((out[..., 3] - ref[..., 3]).abs() -
                          LK_ERR_RTOL * ref[..., 3].abs()).max().item(),
           "iters_mean": iters.float().mean().item(),
           "iters_equal": (iters == ref_iters).float().mean().item()}
    if res["share_within"] < LK_SHARE or res["px_median"] >= LK_MEDIAN or \
            res["status_equal"] < LK_SHARE or \
            res["err_excess"] > 1e-7:
        raise AssertionError(f"K3 disagrees: {res}")
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
    launches = tuple(n for name, n in launch_counts().items()
                     if name not in ("K3", "K7"))
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


def compare_dense_small(device, mode="subtructAverageVectorWithWindow",
                        n=3):
    """A dense mode at 192x256 on `device` against the same steps on the
    CPU (plain versions), from the same frames: the ring mean of the flow
    and the output frames, held to the DENSE_* limits."""
    cfg = ModeConfig(xdim=256, ydim=192, window_size=3)
    raw = moving_frames(n + 1, 288, 384, torch.device("cpu"))
    res = {}
    for dev in (device, torch.device("cpu")):
        stats = runner.RunStats()
        outs = list(runner.run_frames(mode, raw, cfg, device=dev,
                                      stats=stats))
        res[dev.type] = (stats.state.ring.mean.cpu(), outs[-1].cpu())
    (mg, og), (mc, oc) = res[device.type], res["cpu"]
    d = (mg - mc).norm(dim=-1).flatten()
    out = {"ring_mean_median_px": d.median().item(),
           "ring_mean_p99_px": torch.quantile(d, 0.99).item(),
           "ring_mean_max_px": d.max().item(),
           "pixels_equal": (og == oc).all(dim=-1).float().mean().item()}
    if out["ring_mean_median_px"] > DENSE_MEDIAN_PX or \
            out["ring_mean_p99_px"] > DENSE_P99_PX or \
            out["pixels_equal"] < DENSE_PIXEL_SHARE:
        raise AssertionError(f"{mode} on {device} vs CPU: {out}")
    return out


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
    on the main path each kernel reads what the previous one wrote)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return us / 1e3 / reps


def kernel_rows(device, launches, devs):
    """Timing rows at the 640x480 shapes: K1, K2, K4, K5 and K6 at level 0
    of the legacy preset, K3 on the 201 timeline vertices, K7 at level 0 of
    the subtract_average preset. launches: {kernel: count} of the main
    paths; devs: the deviations of phase 2."""
    p = FarnebackParams.legacy()
    h, w = 480, 640
    bres = _bres(p, h, w)
    prep, flow = level0_inputs(h, w, p, device)
    hp, wp = prep["hpwp"]
    px = hp * wp
    m = fu.farneback_update(prep, flow, bres)
    args = (prep["p0"], prep["p1"], flow, prep["counts"], prep["hw"],
            prep["th"], prep["sw"], bres)
    wy, wx = fu._blur_weights_on(hp, h, p.winsize, p.gaussian, device)
    nt = wx.numel()

    k1 = lambda: fu.farneback_update(prep, flow, bres)  # noqa: E731
    k1_ms, k1_wall = device_ms(k1, 100), wall_ms(k1, 100)
    k1_plain = device_ms(lambda: fu.farneback_update_plain(*args), 10)
    # bytes: p0 and the sampled table (one bf16 per pixel and channel
    # each), flow read, M written; ops: ~45 for the 5-channel bilinear
    # sample and ~40 for the tail per pixel.
    k1_bytes = px * (5 * 2 + 5 * 2 + 2 * 4 + 5 * 2)
    k1_ops = px * 85
    k2 = lambda: fu.farneback_blur_solve(  # noqa: E731
        m, (h, w), p.winsize, p.gaussian, True)
    k2_ms, k2_wall = device_ms(k2, 100), wall_ms(k2, 100)
    k2_plain = device_ms(lambda: fu.farneback_blur_solve_plain(
        m, (h, w), wy, wx, True), 10)
    k2_bytes = px * (5 * 2 + 2 * 4)
    k2_ops = px * (5 * 2 * nt * 2 + 12)
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
    k4_ms, k4_wall = device_ms(k4, 100), wall_ms(k4, 100)
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
    prev, nxt = lk_inputs(device)
    pts = timeline_init((10.0, 150.0), (630.0, 400.0), 200,
                        device).vertices[None]
    pyr_prev, pyr_next, derivs = lk.prepare(prev, nxt, lkp)
    k3 = lambda: lk_track(pyr_prev, pyr_next, derivs, pts, lkp)  # noqa: E731
    _, iters = k3()
    k3_ms, k3_wall = device_ms(k3, 20), wall_ms(k3, 20)
    k3_plain = device_ms(
        lambda: lk_track_plain(pyr_prev, pyr_next, derivs, pts, lkp), 2)
    area = lkp.win[0] * lkp.win[1]
    k3_bytes = 4 * 4 * sum(lv.numel() for lv in pyr_prev) + pts.numel() * 12
    k3_iters = int(iters.sum())
    k3_ops = 2 * area * (pts.shape[1] * len(pyr_prev) * 15 + k3_iters * 6)
    print(f"[5] lk_track iterations at 640x480, 201 vertices: "
          f"{k3_iters} in all, {k3_iters / pts.shape[1]:.2f} per point over "
          f"{len(pyr_prev)} levels (at most "
          f"{lkp.max_iters * len(pyr_prev)})")

    # K5 and K6 at level 0 of the legacy 640x480 table (5, 544, 896) bf16.
    # Bytes: the frame (f32) and t (bf16) once each, the window weights;
    # the output (bf16) once. Ops: 2 per product over this geometry's
    # windows (K6: six sums) and 7 per pixel for the combine.
    img = moving_frames(1, h, w, device, color=False)[0].to(torch.float32)
    args = fb._prep_level_args(h, w, p, 0)
    k5, k6, k5_plain, k6_plain, _, t = prep_call(img, args)
    win = fb._prep_windows_on(args, device)
    ph, pw = args[8], args[9]
    k5_ms, k5_wall = device_ms(k5, 100), wall_ms(k5, 100)
    k5_plain_ms = device_ms(k5_plain, 5)
    k6_ms, k6_wall = device_ms(k6, 100), wall_ms(k6, 100)
    k6_plain_ms = device_ms(k6_plain, 5)
    k5_bytes = img.numel() * 4 + t.numel() * 2 + win["wy"].numel() * 4
    k5_ops = 2 * int(win["y_len"].sum()) * w
    k6_bytes = t.numel() * 2 + 5 * ph * pw * 2 + win["wx"].numel() * 4
    k6_ops = 6 * 2 * int(win["x_len"].sum()) * ph + 7 * ph * pw
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
    k7_ms, k7_wall = device_ms(k7, 100), wall_ms(k7, 100)
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
        row("lk_track", "ripcurrents_tpu_torch/csrc/lk_track.cu",
            "ripcurrents_tpu/flow/lk_pallas.py:322", launches["K3"],
            devs["k3_px_max"], k3_ms, k3_plain, k3_bytes, k3_ops, None,
            k3_wall),
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
    ]


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
    for stem, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"    {stem}: {line.strip()}")

    devs = check_kernels(480, 640, FarnebackParams.legacy(), dev)
    print(f"[2] 640x480 L0 legacy (bres 4, sw 128, box 3): {devs}")
    devs_hd = check_kernels(1080, 1920, FarnebackParams.windowed(), dev,
                            iterations=1)
    print(f"[2] 1080p L0 windowed (bres 1, sw 640, gauss 10): {devs_hd}")
    k4_devs = check_resize(480, 640, FarnebackParams.legacy(), dev)
    devs.update(k4_devs)
    print(f"[2] K4 at the legacy level changes (120x160 -> 240x320 -> "
          f"480x640, padded): {k4_devs}")
    print(f"[2] K4 at the 1080p windowed level changes: "
          f"{check_resize(1080, 1920, FarnebackParams.windowed(), dev)}")
    for name, (hw, preset) in {
            "640x480 legacy (5, Ph, Pw) bf16": ((480, 640),
                                                FarnebackParams.legacy()),
            "1080p windowed (5, Ph, Pw) bf16": ((1080, 1920),
                                                FarnebackParams.windowed()),
            "640x480 subtract_average (lh, lw, 5) f32": (
                (480, 640), dataclasses.replace(
                    FarnebackParams.subtract_average(), warp_impl="pallas"))
    }.items():
        prep_devs = check_prep(*hw, preset, dev)
        if name.startswith("640x480 legacy"):
            devs.update(prep_devs)
        print(f"[2] K5/K6 at every level of the {name} tables: {prep_devs}")
    k7_devs = check_warp(480, 640, dev)
    devs["k7_max"] = k7_devs["max_all"]
    print(f"[2] K7 at 640x480, budget 16, flows up to +-24 px: {k7_devs}")
    print(f"[2] K7 at 75x107, budget 4, flows up to +-7 px: "
          f"{check_warp(75, 107, dev, budget=4, flow_px=7.0)}")
    lk_devs = check_lk(dev, 201, timeline=True)
    devs["k3_px_max"] = lk_devs["px_max"]
    print(f"[2] K3 at 640x480, 201 timeline vertices: {lk_devs}")
    print(f"[2] K3 at 640x480, 1280 points: {check_lk(dev, 1280)}")
    print(f"[2] K3 at 640x480, 2 streams x 201 points: "
          f"{check_lk(dev, 201, streams=2)}")
    print(f"[2] K3 at 640x480, 192 points, window 21x21: "
          f"{check_lk(dev, 192, p=LKParams.red_points())}")

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
                "K4": 2 * n, "K5": 3 * (n + 1), "K6": 3 * (n + 1), "K7": 0}
        print(f"[7] {mode} 640x480, {n} frames of {RAW_W}x{RAW_H}: "
              f"{m_ms:.3f} ms/frame (host clock), {m_ev:.3f} ms/frame (CUDA "
              f"events), {1e3 / m_ms:.1f} fps; launches {m_n}")
        if m_n != want:
            raise AssertionError(f"{mode}: expected launches {want}")
    pallas_cfg = ModeConfig(warp_impl="pallas")
    n = 10
    p_ms, p_ev, p_n, _ = run_dense_mode(dev, "subtructAverageVector", n,
                                        pallas_cfg)
    print(f"[7] subtructAverageVector 640x480 on the portable engine "
          f"(warp_impl='pallas'), {n} frames: {p_ms:.3f} ms/frame (host "
          f"clock), {p_ev:.3f} ms/frame (CUDA events); launches {p_n}, K7 "
          f"{p_n['K7'] / n} per frame")
    want = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 3 * (n + 1),
            "K6": 3 * (n + 1), "K7": 9 * n}
    if p_n != want:
        raise AssertionError(f"portable engine: expected launches {want}")
    print(f"[7] subtructAverageVectorWithWindow 192x256 on the card vs on "
          f"the CPU: {compare_dense_small(dev)}")

    launches = dict(zip(("K1", "K2", "K4", "K5", "K6"), launches),
                    K3=tl_launches, K7=p_n["K7"])
    rows = kernel_rows(dev, launches, devs)
    for r in rows:
        lib = r["library_ms"]
        print(f"[5] {r['name']}: {r['ms'] * 1e3:.2f} us/launch on the "
              f"device ({r['wall_ms'] * 1e3:.2f} us per back-to-back call "
              f"with the host), plain {r['plain_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), library "
              f"{'-' if lib is None else f'{lib * 1e3:.2f} us'}")
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
