"""K5's and K6's tile plans at every level of the legacy, windowed,
channels-last and android 640x480 pyramids, on the CPU.

Inputs and what is held: ``tests/_torch_prep_geometry.py``.
"""

import pytest
import torch

from _torch_prep_geometry import (
    GEOMETRIES, tiles_cover_every_output_once_and_stage_their_windows)

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(GEOMETRIES)[:4])
def test_tiles_cover_every_output_once_and_stage_their_windows(name):
    tiles_cover_every_output_once_and_stage_their_windows(name)
