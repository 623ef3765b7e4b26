"""The host plans of K2 (farneback_blur_solve) and K4 (resize_cf_padded),
and K2's streamed summation order, on the CPU.

``fused_update.blur_plan`` cuts each pyramid level into K2's output tiles:
in the y pass a thread sums a strip of output rows at one column of the
tile or its x halo, reading M's rows through the replicate clamp; the
tile's mid values go to shared memory; in the x pass a thread sums a run
of output columns of one row. ``image.resize_plan`` sizes K4's grid.
These tests walk every level of the presets the port runs: every output
lies in exactly one tile; each tile's mid values cover every x window in
it; each block's threads, registers and shared memory fit the card. Then
they sum in K2's order (per tile, each strip's clamped source rows
streamed once in ascending order into every accumulator whose window
holds them, taps from the interior vector or the merged border rows; then
each run's mid values streamed once) with float32 tensor ops and hold the
result to ``farneback_blur_solve_plain`` bit for bit, and K4's quads
(tables read 4 columns at a time) to ``resize_cf_padded_plain``.
"""

import numpy as np
import pytest
import torch

from ripcurrents_tpu_torch import kernels
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as fb
from ripcurrents_tpu_torch.flow import fused_update as fu
from ripcurrents_tpu_torch.ops import image as im

torch.set_num_threads(1)

# Registers of an H100 SM: K2's launch bounds cap a thread at
# SM_REGISTERS / BLUR_MAX_THREADS of them.
SM_REGISTERS = 65536

# (size, preset) of every pyramid the port's fused engine runs, plus a
# ragged width and subtract_average's window over levels shorter than it,
# in three groups.
PYRAMIDS = {
    "640x480 legacy, windowed, subtract_average": (
        ((480, 640), "legacy"), ((480, 640), "windowed"),
        ((480, 640), "subtract_average")),
    "640x480 streamlines, android; windowed 1080p": (
        ((480, 640), "streamlines"), ((480, 640), "android"),
        ((1080, 1920), "windowed")),
    "legacy 75x107, subtract_average 40x300": (
        ((75, 107), "legacy"), ((40, 300), "subtract_average")),
}


def _levels(hw, preset):
    """(true size, padded size) of every level, coarsest first, as the
    fused engine pads them."""
    p = getattr(FarnebackParams, preset)()
    out = []
    for k in range(p.levels, -1, -1):
        _, lh, lw, _, _ = fb._level_geometry(*hw, p, k)
        th = fu._row_tile(lh)
        out.append(((lh, lw), (-(-lh // th) * th, -(-lw // 128) * 128)))
    return p, out


def _check_blur_plan(plan, hpwp, half):
    hp, wp = hpwp
    rows, cols = plan["rows"], plan["cols"]
    strip, run = plan["strip"], fu.BLUR_RUN
    gx, gy = plan["grid"]
    assert strip in (fu.BLUR_SMALL[2], fu.BLUR_LARGE[2])
    # every output in exactly one tile
    hits = np.zeros((gy * rows, gx * cols), np.int32)
    for ty in range(gy):
        for tx in range(gx):
            hits[ty * rows:(ty + 1) * rows, tx * cols:(tx + 1) * cols] += 1
    assert (hits[:hp, :wp] == 1).all()
    assert (gy - 1) * rows < hp and (gx - 1) * cols < wp
    assert rows % strip == 0 and cols % run == 0 and run % 4 == 0
    # mid column j holds image column x0 + mid_x0 + j, mid_x0 = -half
    # rounded to even (a strip's 2 columns are one aligned word of M):
    # output x0 + c's window [c - half, c + half] lies in the mid columns,
    # and the x pass's 16-byte reads of a run stay inside its row and fall
    # on distinct banks for 8 lanes on 8 rows
    he = half + half % 2
    assert plan["mid_x0"] == -he and plan["mid_cols"] == cols + 2 * he
    assert (cols + 2 * he) % 2 == 0
    span4 = 4 * -(-(he - half + run + 2 * half) // 4)
    assert cols - run + span4 <= plan["pitch"] and plan["pitch"] % 8 == 4
    assert plan["mid_cols"] <= plan["pitch"]
    # one strip and one run a thread; the block fits the card
    assert plan["y_tasks"] == plan["mid_cols"] // 2 * (rows // strip)
    assert plan["x_tasks"] == rows * (cols // run)
    assert max(plan["y_tasks"], plan["x_tasks"]) <= plan["threads"]
    assert plan["threads"] % 32 == 0
    assert plan["threads"] <= fu.BLUR_MAX_THREADS
    assert plan["threads"] * (SM_REGISTERS // fu.BLUR_MAX_THREADS) \
        <= SM_REGISTERS
    assert plan["shared"] == 5 * rows * plan["pitch"] * 4
    assert plan["shared"] <= kernels.MAX_SHARED


@pytest.mark.parametrize("name", sorted(PYRAMIDS))
def test_tiles_cover_every_output_once_and_stage_their_windows(name):
    """K2 at every level and K4 at every level change: each output in one
    tile, every window in the tile's mid values, every block within the
    card's limits, and K4's grid one wave of RESIZE_MIN_BLOCKS blocks an
    SM unless its threads already take RESIZE_MAX_ROWS rows."""
    for hw0, preset in PYRAMIDS[name]:
        p, levels = _levels(hw0, preset)
        half = p.winsize // 2
        for hw, hpwp in levels:
            _check_blur_plan(fu.blur_plan(*hpwp, half, hw), hpwp, half)
        for _, (dph, dpw) in levels[1:]:
            plan = im.resize_plan(dph, dpw)
            gx, gy = plan["grid"]
            assert gx * 128 >= dpw > (gx - 1) * 128
            band = im.RESIZE_WARPS * plan["rows"]
            assert gy * band >= dph > (gy - 1) * band
            assert plan["rows"] <= im.RESIZE_MAX_ROWS
            assert gx * gy <= kernels.H100_SMS * im.RESIZE_MIN_BLOCKS or \
                plan["rows"] == im.RESIZE_MAX_ROWS


def test_plan_takes_short_chains_where_a_level_cannot_fill_the_card():
    """A level with fewer than BLUR_LATENCY_TAPS output taps takes
    BLUR_SMALL (1-row strips on 8x32 tiles), a larger one BLUR_LARGE; the
    legacy coarse levels are small, level 0 of 640x480 and of 1080p large
    and give every SM at least one tile."""
    for hw, half in (((120, 160), 1), ((240, 320), 1), ((120, 160), 5)):
        assert hw[0] * hw[1] * (2 * half + 1) < fu.BLUR_LATENCY_TAPS
        plan = fu.blur_plan(hw[0], -(-hw[1] // 128) * 128, half, hw)
        assert (plan["rows"], plan["cols"], plan["strip"]) == fu.BLUR_SMALL
    for hw, half in (((480, 640), 1), ((480, 640), 5), ((1080, 1920), 5)):
        plan = fu.blur_plan(*hw, half, hw)
        assert (plan["rows"], plan["cols"], plan["strip"]) == fu.BLUR_LARGE
        assert plan["grid"][0] * plan["grid"][1] >= kernels.H100_SMS


def test_interior_weight_rows_equal_the_taps():
    """A row whose window stays inside the level merges no taps, so its
    merged y weights equal the x taps: the kernel's interior strips take
    the taps from registers."""
    for half in range(fu.MHALO_Y + 1):
        for gaussian in (False, True):
            h = 2 * half + 9
            wy, wx = fu._blur_weights(h + 7, h,
                                      fu._blur_taps(2 * half + 1, gaussian))
            for y in range(half, h - half):
                assert np.array_equal(wy[y], wx)


def test_bf16_products_are_exact_so_one_fma_rounds_as_product_and_add():
    """K2 adds each product of its sums with one FMA. Every tap (merged
    border rows included) is a bf16 value and so is every value it
    multiplies (M, and the mid values rounded to bf16), so a product has
    at most 16 significant bits and is exact in float32 down to 2**-134:
    one rounding of acc + w*v then equals the plain version's rounded
    product followed by a rounded add. Shown on the taps of every
    half-width, box and Gaussian, times bf16 values over 2**-60..2**60."""
    rng = np.random.default_rng(7)
    vals = torch.from_numpy(
        (rng.uniform(1, 2, 4096) * np.exp2(rng.integers(-60, 61, 4096)) *
         rng.choice([-1.0, 1.0], 4096)).astype(np.float32)).to(
        torch.bfloat16).to(torch.float32)
    for half in range(fu.MHALO_Y + 1):
        for gaussian in (False, True):
            wy, wx = fu._blur_weights(40, 2 * half + 3,
                                      fu._blur_taps(2 * half + 1, gaussian))
            taps = torch.from_numpy(np.unique(np.concatenate([wy.ravel(),
                                                              wx])))
            assert torch.equal(taps, taps.to(torch.bfloat16).float())
            p32 = (taps[:, None] * vals[None, :]).double()
            p64 = taps.double()[:, None] * vals.double()[None, :]
            assert torch.equal(p32, p64)
            assert p64[p64 != 0].abs().min() >= 2.0 ** -134


def _m_input(hp, wp, seed):
    """M (5, hp, wp) bf16 shaped like the normal equations (g11, g22 > 0,
    |g12| small), from a numpy seed."""
    rng = np.random.default_rng(seed)
    u, v, r = (rng.standard_normal((hp, wp)).astype(np.float32)
               for _ in range(3))
    m = np.stack([u * u + 0.1, 0.3 * u * v, v * v + 0.1, r, 0.5 * r * u])
    return torch.from_numpy(m).to(torch.bfloat16)


def _k2_streamed(m, hw, wy, wx, half, plan, zero_pads):
    """K2's sums in the kernel's order, per tile of `plan`, with float32
    tensor ops: the y pass a strip at a time (each clamped source row
    once, ascending, into every accumulator whose window holds it;
    interior strips with the taps, border strips with their merged rows)
    over the tile's columns and x halo, the bf16 mid values, the x pass a
    run at a time, the solve and the zeroed pads."""
    h, w = hw
    _, hp, wp = m.shape
    rows, cols = plan["rows"], plan["cols"]
    strip, run = plan["strip"], fu.BLUR_RUN
    gx, gy = plan["grid"]
    nt = 2 * half + 1
    y0 = torch.arange(gy) * rows
    x0 = torch.arange(gx) * cols
    srows = (y0[:, None] - half + torch.arange(rows + 2 * half)).clamp(0,
                                                                     h - 1)
    ncols = plan["mid_cols"]
    scols = (x0[:, None] + plan["mid_x0"] +
             torch.arange(ncols)).clamp(0, w - 1)
    src = m.float()[:, srows[:, None, :, None], scols[None, :, None, :]]
    strips = rows // strip
    first = y0[:, None] + torch.arange(strips) * strip       # (gy, S)
    interior = (first - half >= 0) & (first + strip - 1 + half <= h - 1)
    out_rows = (first[..., None] + torch.arange(strip)).clamp(max=hp - 1)
    wrow = torch.where(interior[..., None, None], wx, wy[out_rows])
    acc = torch.zeros((5, gy, gx, strips, strip, ncols))
    for i in range(strip + 2 * half):
        v = src[:, :, :, torch.arange(strips) * strip + i, :]
        for k in range(strip):
            o = i - k
            if 0 <= o < nt:
                wk = wrow[:, :, k, o][None, :, None, :, None]
                acc[:, :, :, :, k] = acc[:, :, :, :, k] + wk * v
    mid = acc.to(torch.bfloat16).float().reshape(5, gy, gx, rows, ncols)
    runs = cols // run
    a = torch.zeros((5, gy, gx, rows, runs, run))
    off = -plan["mid_x0"] - half      # mid column of output x0's window
    for j in range(run + 2 * half):
        v = mid[..., torch.arange(runs) * run + off + j]
        for q in range(run):
            o = j - q
            if 0 <= o < nt:
                a[..., q] = a[..., q] + wx[o] * v
    g = a.reshape(5, gy, gx, rows, cols)
    idet = 1.0 / (g[0] * g[2] - g[1] * g[1] + 1e-3)
    dx = (g[2] * g[3] - g[1] * g[4]) * idet
    dy = (g[0] * g[4] - g[1] * g[3]) * idet
    out = torch.stack([dx, dy]).permute(0, 1, 3, 2, 4).reshape(
        2, gy * rows, gx * cols)[:, :hp, :wp]
    if zero_pads:
        valid = ((torch.arange(hp) < h)[:, None] &
                 (torch.arange(wp) < w)[None, :])
        out = torch.where(valid, out, 0.0)
    return out


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("half", [0, 1, 2, 5, 10, 16])
def test_streamed_sums_match_plain_bit_for_bit(half):
    """K2's order against the plain version, bit for bit, box and
    Gaussian, with the level's own plan and with tiles of both shapes
    forced past its edges: a ragged level (37x75 in 40x96), a one-tile
    level (8x20 in 8x32) and a level shorter than the window (max(1, half)
    rows)."""
    winsize = 2 * half + 1
    for i, (hw, hpwp, gaussian) in enumerate(
            (hw, hpwp, gaussian) for gaussian in (False, True)
            for hw, hpwp in (((37, 75), (40, 96)), ((8, 20), (8, 32)),
                             ((max(1, half), 50), (16, 64)))):
        m = _m_input(*hpwp, seed=10 * half + i)
        wy, wx = fu._blur_weights_on(hpwp[0], hw[0], winsize, gaussian,
                                     torch.device("cpu"))
        plans = [fu.blur_plan(*hpwp, half, hw)] + [
            dict(fu.blur_tile(r, c, half, strip),
                 grid=(-(-hpwp[1] // c), -(-hpwp[0] // r)))
            for r, c in ((24, 64), (16, 128)) for strip in (1, 2)]
        for zero_pads in (True, False):
            plain = fu.farneback_blur_solve_plain(m, hw, wy, wx, zero_pads)
            for plan in plans:
                got = _k2_streamed(m, hw, wy, wx, half, plan, zero_pads)
                assert torch.equal(_bits(got), _bits(plain)), \
                    (hw, gaussian, plan["rows"], plan["cols"], zero_pads)


def test_k4_quads_match_plain_bit_for_bit():
    """K4 reads each thread's 4 columns of taps as two 16-byte quads of
    each table and each row's taps as one pair: gathered that way, the
    upsample of every legacy and 1080p level change equals the plain
    version bit for bit."""
    for hw, preset in (((480, 640), "legacy"), ((1080, 1920), "windowed"),
                       ((75, 107), "legacy")):
        p, levels = _levels(hw, preset)
        for (st, sp), (dt, dp) in zip(levels, levels[1:]):
            rng = np.random.default_rng(dp[0])
            img = torch.zeros((2,) + sp)
            img[:, :st[0], :st[1]] = torch.from_numpy(
                rng.standard_normal((2,) + st).astype(np.float32))
            key = im.resize_key(img, st, dt, dp, 1.0 / p.pyr_scale)
            yidx, yw, xidx, xw = im._padded_taps_on(key, img.device)
            quads_i = xidx.reshape(-1, 8)   # 4 columns' (idx0, idx1) pairs
            quads_w = xw.reshape(-1, 8)
            c0, c1 = quads_i[:, 0::2].reshape(-1), quads_i[:, 1::2].reshape(-1)
            w0, w1 = quads_w[:, 0::2].reshape(-1), quads_w[:, 1::2].reshape(-1)
            r0, r1 = img[:, yidx[:, 0].long()], img[:, yidx[:, 1].long()]
            wy0, wy1 = yw[:, 0, None], yw[:, 1, None]
            t0 = im._fma(wy1, r1[:, :, c0.long()], wy0 * r0[:, :, c0.long()])
            t1 = im._fma(wy1, r1[:, :, c1.long()], wy0 * r0[:, :, c1.long()])
            got = im._fma(w1, t1, w0 * t0)
            plain = im.resize_cf_padded_plain(img, yidx, yw, xidx, xw)
            assert torch.equal(_bits(got), _bits(plain))
            assert dp[1] % 4 == 0
