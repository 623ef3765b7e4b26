"""The host tile plans of K5 (prep_y) and K6 (prep_x3), on the CPU.

``prep_kernel.y_plan`` and ``x_plan`` cut each pyramid level into the
tiles the kernels run: K5 blocks of level rows, K6 blocks of 32 output
rows by groups of one or two columns, each staging in shared memory the
source span its windows read, widened to the union of the windows it
shares and aligned, with zero weights on the widened taps. These tests
walk every level of the presets the port runs (legacy, windowed,
subtract_average on the portable engine, android at 640x480, windowed at
1080p): every nonzero output lies in exactly one tile and every pad in a
zeroing block; each tile's staged span covers every window in it; each
block's shared memory fits the card. Then they sum in the kernels' order
(the widened windows, ascending source index) with float32 tensor ops and
hold the result to the plain versions bit for bit, on small geometries
that include the ragged and one-tile levels.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ripcurrents_tpu_torch import kernels
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as fb
from ripcurrents_tpu_torch.flow import prep_kernel as pk

torch.set_num_threads(1)

GEOMETRIES = {
    "legacy 640x480": ((480, 640), "legacy", "fused"),
    "windowed 640x480": ((480, 640), "windowed", "fused"),
    "subtract_average 640x480 channels-last": ((480, 640),
                                               "subtract_average", "pallas"),
    "android 640x480": ((480, 640), "android", "fused"),
    "windowed 1080p": ((1080, 1920), "windowed", "fused"),
}


def _levels(hw, preset, warp_impl):
    p = dataclasses.replace(getattr(FarnebackParams, preset)(),
                            warp_impl=warp_impl)
    for k in range(p.levels, -1, -1):
        args = fb._prep_level_args(*hw, p, k)
        yield args, pk.band_windows(*fb._level_prep_matrices(*args))


def _check_k5_tiles(win, ph):
    a, b = win["y_rows"]
    live = (win["y_len"].reshape(3, ph) > 0).any(axis=0)
    assert live[a:b].all() and not live[:a].any() and not live[b:].any()
    # row tiles of Y_WARPS rows cover [a, b) once; zero tiles the rest
    tiles = win["y_tiles"]
    assert len(tiles) == -(-(b - a) // pk.Y_WARPS)
    assert win["y_zero_tiles"] * pk.Y_WARPS >= ph - (b - a) > \
        (win["y_zero_tiles"] - 1) * pk.Y_WARPS
    start, count = win["y_span"].T
    lo3, ln3 = win["y_lo"].reshape(3, ph), win["y_len"].reshape(3, ph)
    for i, (first, n) in enumerate(tiles):
        assert 0 < n <= win["y_stage"]
        for y in range(a + i * pk.Y_WARPS, min(a + (i + 1) * pk.Y_WARPS, b)):
            assert count[y] % 4 == 0 and count[y] <= win["y_taps"]
            assert first <= start[y] and start[y] + count[y] <= first + n
            assert (lo3[:, y] >= start[y]).all()
            assert (lo3[:, y] + ln3[:, y] <= start[y] + count[y]).all()
    assert (count[:a] == 0).all() and (count[b:] == 0).all()
    assert win["y_shared"] == 4 * (win["y_stage"] * 32 * win["y_cols"] +
                                   pk.Y_WARPS * 3 * win["y_taps"])


def _check_k6_tiles(win, ph, pw):
    a, b = win["x_cols_nz"]
    live = win["x_len"] > 0
    assert live[a:b].all() and not live[:a].any() and not live[b:].any()
    cols = win["x_cols"]
    groups = -(-(b - a) // cols)
    assert len(win["x_span"]) == groups
    assert len(win["x_tiles"]) == -(-groups // pk.X_WARPS)
    ya, yb = win["y_rows"]
    assert win["x_row_tiles"] == -(-(yb - ya) // pk.X_ROWS)
    # each nonzero output (row, column) in exactly one compute tile
    hits = np.zeros((ph, pw), np.int32)
    for rt in range(win["x_row_tiles"]):
        r0 = ya + rt * pk.X_ROWS
        for ct in range(len(win["x_tiles"])):
            c0 = a + ct * pk.X_WARPS * cols
            hits[r0:min(r0 + pk.X_ROWS, yb),
                 c0:min(c0 + pk.X_WARPS * cols, b)] += 1
    assert (hits[ya:yb, a:b] == 1).all()
    hits[ya:yb, a:b] = 0
    assert not hits.any()
    # zeroing blocks cover every canvas row when there is a pad
    pads = (ya, yb, a, b) != (0, ph, 0, pw)
    assert win["x_zero_blocks"] * pk.ZERO_ROWS >= (ph if pads else 0)
    start, count = win["x_span"].T
    lo, ln = win["x_lo"], win["x_len"]
    for g in range(groups):
        assert start[g] % 4 == 0 and count[g] % 4 == 0
        assert count[g] <= win["x_taps"]
        first, n = win["x_tiles"][g // pk.X_WARPS]
        assert first % 8 == 0 and n % 8 == 0 and n < win["x_pitch"]
        assert first <= start[g] and start[g] + count[g] <= first + n
        for c in range(a + g * cols, min(a + (g + 1) * cols, b)):
            assert start[g] <= lo[c] and lo[c] + ln[c] <= start[g] + count[g]
    assert win["x_pitch"] % 8 == 4


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_tiles_cover_every_output_once_and_stage_their_windows(name):
    """K5 and K6 at every level: the tiles cover the nonzero outputs once,
    stage every window they run, and fit the card's shared memory."""
    taps = []
    for args, win in _levels(*GEOMETRIES[name]):
        ph, pw = args[8], args[9]
        _check_k5_tiles(win, ph)
        _check_k6_tiles(win, ph, pw)
        for key in ("y_shared", "x_shared"):
            assert win[key] <= kernels.MAX_SHARED
        taps.append(win["y_taps"])
    # the longest window of the presets: android's 4-level L3, 260 taps
    assert max(taps) == (260 if name.startswith("android") else 132)


def test_column_pairs_only_where_the_level_has_warps_to_spare():
    """A thread takes two columns (K5, K6) only where the level still
    gives every SM WARPS_PER_SM warps: legacy 640x480 pairs K5 at L0-L1
    and K6 at L0, the coarse levels run a column per thread."""
    got = [(w["y_cols"], w["x_cols"])
           for _, w in _levels((480, 640), "legacy", "fused")]
    assert got == [(1, 1), (2, 1), (2, 2)]


def _bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def _frame(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32))


def _k5_widened(img, win):
    """t summed as K5 sums it: level row y over its widened window
    [start, start + count), rows past the frame read as zero, in
    ascending source row."""
    h, w = img.shape
    wy_u = torch.from_numpy(win["wy_u"])
    ph, _, taps = wy_u.shape
    start = torch.from_numpy(win["y_span"][:, 0]).long()
    v = torch.cat([img.to(torch.bfloat16).to(torch.float32),
                   torch.zeros(taps, w)])
    acc = torch.zeros(ph, 3, w)
    for j in range(taps):
        acc = acc + wy_u[:, :, j, None] * v[start + j][:, None, :]
    return acc.permute(1, 0, 2).reshape(3 * ph, w).to(torch.bfloat16)


def _k6_widened(t, win, ph, ig, out_dtype, channels_first):
    """The five channels summed as K6 sums them: each column group over
    its widened window, columns past t read as zero, in ascending source
    column; pads zero."""
    wx_u = torch.from_numpy(win["wx_u"])
    groups, _, cols, taps = wx_u.shape
    a, b = win["x_cols_nz"]
    pw = win["x_lo"].size
    start = torch.from_numpy(win["x_span"][:, 0]).long()
    tf = torch.cat([t.to(torch.float32), torch.zeros(t.shape[0], taps)], 1)
    s0, s1, s2 = tf[:ph], tf[ph:2 * ph], tf[2 * ph:]
    z = torch.zeros(ph, groups, cols)
    b1, b2, b3, b4, b5, b6 = z, z, z, z, z, z
    for j in range(taps):
        src = start + j
        u0, u1, u2 = (s[:, src, None] for s in (s0, s1, s2))
        g, xg, xxg = wx_u[:, 0, :, j], wx_u[:, 1, :, j], wx_u[:, 2, :, j]
        b1 = b1 + u0 * g
        b3 = b3 + u1 * g
        b5 = b5 + u2 * g
        b2 = b2 + u0 * xg
        b6 = b6 + u1 * xg
        b4 = b4 + u0 * xxg
    ig11, ig03, ig33, ig55 = ig
    ch = torch.stack([b2 * ig11, b3 * ig11, b1 * ig03 + b4 * ig33,
                      b1 * ig03 + b5 * ig33, b6 * ig55])
    out = torch.zeros(5, ph, pw)
    out[:, :, a:b] = ch.reshape(5, ph, groups * cols)[:, :, :b - a]
    ya, yb = win["y_rows"]
    out[:, :ya] = 0.0
    out[:, yb:] = 0.0
    out = out if channels_first else out.permute(1, 2, 0)
    return out.to(out_dtype)


@pytest.mark.parametrize("hw,preset,warp_impl,pairs", [
    ((75, 107), "legacy", "fused", False),     # ragged, width not /8
    ((75, 107), "legacy", "fused", True),      # pairs over odd widths
    ((40, 300), "legacy", "fused", False),     # one-tile coarse levels
    ((96, 128), "windowed", "pallas", False),  # channels-last float32
    ((480, 640), "android", "fused", False),   # the 260-tap coarsest level
], ids=["75x107", "75x107-pairs", "40x300", "channels-last", "android"])
def test_widened_sums_equal_the_plain_versions_bit_for_bit(
        hw, preset, warp_impl, pairs, monkeypatch):
    """The kernels' order of summation (widened windows with zero weights)
    gives the plain versions' bits at every level; with column pairs
    forced, the last pair of an odd width holds one real column."""
    if pairs:
        monkeypatch.setattr(pk, "WARPS_PER_SM", 0)
    img = _frame(*hw)
    channels_first = warp_impl == "fused"
    odt = torch.bfloat16 if channels_first else torch.float32
    for args, win in _levels(hw, preset, warp_impl):
        ph = args[8]
        ig = fb._poly_exp_consts(args[4], args[5])[3:]
        t = pk.prep_y_plain(img, torch.from_numpy(win["y_lo"]),
                            torch.from_numpy(win["wy"]))
        assert torch.equal(_bits(_k5_widened(img, win)), _bits(t))
        want = pk.prep_x3_plain(t, torch.from_numpy(win["x_lo"]),
                                torch.from_numpy(win["wx"]), ph, ig, odt,
                                channels_first)
        got = _k6_widened(t, win, ph, ig, odt, channels_first)
        assert torch.equal(_bits(got), _bits(want))
        assert got.abs().sum() > 0
        if pairs:
            assert win["y_cols"] == win["x_cols"] == 2
