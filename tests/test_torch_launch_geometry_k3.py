"""K3's shared-memory size against its formula and two blocks per SM,
on the CPU.

What is held: ``tests/_torch_launch_geometry.py``.
"""

import pytest

from ripcurrents_tpu_torch.config import LKParams
from ripcurrents_tpu_torch.flow import lk_kernel


@pytest.mark.parametrize("preset", ["particles", "dense_grid", "red_points"])
def test_k3_shared_bytes_fit_two_blocks_per_sm(preset):
    wx, wy = getattr(LKParams, preset)().win
    m = lk_kernel.PATCH_MARGIN
    want = 16 * (wx + 1) * (wy + 1) + 4 * (wx + 2 * m + 1) * (wy + 2 * m + 1)
    got = lk_kernel.shared_bytes((wx, wy))
    assert got == want
    assert 2 * (got + 1024) <= lk_kernel.MAX_SHARED
