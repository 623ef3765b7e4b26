"""K1's cluster size at every pyramid level of the presets (windowed
at 1080p and 40x300, subtract_average at 640x480 and 1080p), on the
CPU.

Inputs and what is held: ``tests/_torch_launch_geometry.py``.
"""

import pytest

from _torch_launch_geometry import K1_CASES, k1_cluster_size_at_every_level


@pytest.mark.parametrize("preset,hw", K1_CASES[4:8])
def test_k1_cluster_size_at_every_level(preset, hw):
    k1_cluster_size_at_every_level(preset, hw)
