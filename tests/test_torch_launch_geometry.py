"""The host-side launch geometry of K1 and K3, on the CPU.

K1 (``farneback_update``) runs one thread-block cluster of S CTAs per
(row tile x subcolumn) base block; ``cluster_size`` picks S per pyramid
level. These tests walk every level geometry the presets give at the
port's working sizes (640x480, 1080p, the ragged 40x300) and hold the
choice to its docstring: S a power of two, S <= min(16, th) so the even
row split leaves no CTA empty and covers the tile, the CTA count blocks
x S, and S the largest at which the card holds every cluster of the
level at once. K3's shared-memory size (the staged source pixels of the
I, Ix and Iy windows and the J patch) is held to the kernel's formula
and to two blocks per SM.
"""

import pytest

from ripcurrents_tpu_torch.config import FarnebackParams, LKParams
from ripcurrents_tpu_torch.flow import farneback as fb
from ripcurrents_tpu_torch.flow import fused_update as fu
from ripcurrents_tpu_torch.flow import lk_kernel


def _levels(h, w, p):
    """(th, hp, wp, sw) of every pyramid level of preset p at (h, w), as
    farneback_from_expansions builds them."""
    subcol = p.warp_subcol
    if h * w >= p.warp_hires_px and p.warp_subcol_hires is not None:
        subcol = p.warp_subcol_hires
    out = []
    for k in range(p.levels, -1, -1):
        _, lh, lw, _, _ = fb._level_geometry(h, w, p, k)
        th = fu._row_tile(lh)
        hp, wp = -(-lh // th) * th, -(-lw // 128) * 128
        out.append((th, hp, wp, fu._subcol_width(wp, subcol)))
    return out


# Clusters of K1 an NVIDIA H100 80GB HBM3 holds at once, by cluster size
# (cudaOccupancyMaxActiveClusters, printed by chip_smoke.py [1]), and a
# card that holds no 16-CTA cluster.
H100 = {1: 264, 2: 132, 4: 62, 8: 30, 16: 14}
NO16 = {**H100, 16: 0}


@pytest.mark.parametrize("hw", [(480, 640), (1080, 1920), (40, 300)],
                         ids=["640x480", "1080p", "40x300"])
@pytest.mark.parametrize("preset", ["legacy", "windowed",
                                    "subtract_average"])
def test_k1_cluster_size_at_every_level(preset, hw):
    p = getattr(FarnebackParams, preset)()
    levels = _levels(*hw, p)
    for th, hp, wp, sw in levels:
        s, ctas = fu.cluster_size(th, hp, wp, sw, H100)
        blocks = (hp // th) * (wp // sw)
        assert s & (s - 1) == 0 and 1 <= s <= min(fu.MAX_CLUSTER, th)
        assert ctas == blocks * s
        rows = [(r + 1) * th // s - r * th // s for r in range(s)]
        assert min(rows) >= 1 and sum(rows) == th
        # every cluster of the level resident at once, and S the largest
        # such power of two
        assert s == 1 or blocks <= H100[s]
        assert 2 * s > min(fu.MAX_CLUSTER, th) or blocks > H100[2 * s]
    if hw == (480, 640):
        assert fu.cluster_size(*levels[-1], H100)[1] >= 120   # level 0
        # the one- and two-block coarse levels take the largest cluster
        for th, hp, wp, sw in levels[:-1]:
            if (hp // th) * (wp // sw) <= 2:
                assert fu.cluster_size(th, hp, wp, sw,
                                       H100)[0] == fu.MAX_CLUSTER


def test_k1_cluster_size_keeps_to_the_card_limit():
    """A card that holds no 16-CTA cluster of K1 caps S at 8; the CTA
    count follows."""
    for th, hp, wp, sw in _levels(480, 640, FarnebackParams.windowed()):
        s16, _ = fu.cluster_size(th, hp, wp, sw, H100)
        s8, ctas8 = fu.cluster_size(th, hp, wp, sw, NO16)
        assert s8 == min(s16, 8)
        assert ctas8 == (hp // th) * (wp // sw) * s8


@pytest.mark.parametrize("preset", ["particles", "dense_grid", "red_points"])
def test_k3_shared_bytes_fit_two_blocks_per_sm(preset):
    wx, wy = getattr(LKParams, preset)().win
    m = lk_kernel.PATCH_MARGIN
    want = 16 * (wx + 1) * (wy + 1) + 4 * (wx + 2 * m + 1) * (wy + 2 * m + 1)
    got = lk_kernel.shared_bytes((wx, wy))
    assert got == want
    assert 2 * (got + 1024) <= lk_kernel.MAX_SHARED
