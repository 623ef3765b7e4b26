"""K1's cluster size at every pyramid level (subtract_average at
40x300) and on a card that holds no 16-CTA cluster, on the CPU.

Inputs and what is held: ``tests/_torch_launch_geometry.py``.
"""

import pytest

from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import fused_update as fu

from _torch_launch_geometry import (H100, K1_CASES, NO16, _levels,
                                    k1_cluster_size_at_every_level)


@pytest.mark.parametrize("preset,hw", K1_CASES[8:])
def test_k1_cluster_size_at_every_level(preset, hw):
    k1_cluster_size_at_every_level(preset, hw)


def test_k1_cluster_size_keeps_to_the_card_limit():
    """A card that holds no 16-CTA cluster of K1 caps S at 8; the CTA
    count follows."""
    for th, hp, wp, sw in _levels(480, 640, FarnebackParams.windowed()):
        s16, _ = fu.cluster_size(th, hp, wp, sw, H100)
        s8, ctas8 = fu.cluster_size(th, hp, wp, sw, NO16)
        assert s8 == min(s16, 8)
        assert ctas8 == (hp // th) * (wp // sw) * s8
