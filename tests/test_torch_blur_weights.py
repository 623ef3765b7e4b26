"""K2's weights (interior rows, exact bf16 products) and K4's quads
against its plain version bit for bit, on the CPU.

Inputs and what is held: ``tests/_torch_blur_geometry.py``.
"""

import numpy as np
import torch

from ripcurrents_tpu_torch.flow import fused_update as fu
from ripcurrents_tpu_torch.ops import image as im

from _torch_blur_geometry import _bits, _levels

torch.set_num_threads(1)


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
