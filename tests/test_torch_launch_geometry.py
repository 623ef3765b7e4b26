"""K1's cluster size at every pyramid level of the presets (legacy,
and windowed at 640x480), on the CPU.

Inputs and what is held: ``tests/_torch_launch_geometry.py``.
"""

import pytest

from _torch_launch_geometry import K1_CASES, k1_cluster_size_at_every_level


@pytest.mark.parametrize("preset,hw", K1_CASES[:4])
def test_k1_cluster_size_at_every_level(preset, hw):
    k1_cluster_size_at_every_level(preset, hw)
