#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their
plain PyTorch versions.

Run from the repository root on a machine with one Hopper card and the
CUDA toolkit:

    python3 chip_smoke.py

Every phase passes or raises (the script catches nothing):

1. the card's name and power limit; build the kernels of ``csrc/`` with
   nvcc for sm_90a and print the build time and the ptxas report;
2. K1 (farneback_update), K2 (farneback_blur_solve) and the level loop
   against their plain versions on the card, at the main path's shapes:
   640x480 level 0 of the legacy preset (table (5, 544, 896) bf16, bres 4,
   128-wide subcolumns, box 3) and 1080p level 0 of the windowed preset
   (bres 1, 640-wide subcolumns, Gaussian 10);
3. the legacy rip detector (``make_legacy``, 250 seeds) on 40 synthetic
   1280x720 moving-texture frames at 640x480: finite outputs of the right
   shapes, a live duty mask, K1 and K2 each launched 6 times per frame;
   then the whole step at 192x256 on the card against the same step on
   the CPU (plain versions);
4. the windowed Farneback stream at 1920x1080;
5. each kernel's time per launch at 640x480 level 0 beside its plain
   version, its bound and a library call, as one JSON line.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels JSON, and the card's name and power limit come before
that. Without a card the script exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from ripcurrents_tpu_torch import kernels
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as fb
from ripcurrents_tpu_torch.flow import fused_update as fu
from ripcurrents_tpu_torch.pipelines.common import ModeConfig
from ripcurrents_tpu_torch.pipelines.legacy import make_legacy
from ripcurrents_tpu_torch.synthetic import moving_frames

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


def run_legacy(device, frames=FRAMES, xdim=640, ydim=480,
               raw_hw=(RAW_H, RAW_W)):
    """The main path: make_legacy at xdim x ydim (default 640x480, 250
    seeds) over `frames` synthetic raw frames. Returns (ms per warm frame
    by host clock, ms by CUDA events or None, launches of K1 and K2,
    mask share)."""
    cfg = ModeConfig(xdim=xdim, ydim=ydim, total_frames=frames)
    raw = moving_frames(frames + 1, *raw_hw, device)
    init, step = make_legacy(cfg, device=device)
    state = init(raw[0])
    fu.farneback_update.launches = 0
    fu.farneback_blur_solve.launches = 0
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
    launches = (fu.farneback_update.launches,
                fu.farneback_blur_solve.launches)
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
    """Timing rows at 640x480 level 0 of the legacy preset."""
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
            launches[0], devs["k1_max"], k1_ms, k1_plain, k1_bytes, k1_ops,
            None, k1_wall),
        row("farneback_blur_solve", "ripcurrents_tpu_torch/csrc/"
            "farneback_blur_solve.cu",
            "ripcurrents_tpu/flow/fused_update.py:823", launches[1],
            devs["k2_max"], k2_ms, k2_plain, k2_bytes, k2_ops, lib_ms,
            k2_wall),
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

    host_ms, ev_ms, launches, share = run_legacy(dev)
    per_frame = (launches[0] / FRAMES, launches[1] / FRAMES)
    print(f"[3] legacy 640x480, {FRAMES} frames of {RAW_W}x{RAW_H}: "
          f"{host_ms:.3f} ms/frame (host clock), {ev_ms:.3f} ms/frame "
          f"(CUDA events), {1e3 / host_ms:.1f} fps; launches per frame "
          f"K1 {per_frame[0]} K2 {per_frame[1]}; mask share {share:.4f}")
    if per_frame != (6.0, 6.0):
        raise AssertionError(f"expected 6 launches of K1 and K2 per frame, "
                             f"got {per_frame}")
    small = compare_legacy_small(dev)
    print(f"[3] legacy 192x256 on the card vs on the CPU: {small}")

    hd_ms, hd_mag = run_stream_1080p(dev)
    print(f"[4] windowed stream 1920x1080: {hd_ms:.3f} ms/frame "
          f"({1e3 / hd_ms:.1f} fps), mean |flow| {hd_mag:.3f} px")

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
