"""K5's and K6's tile plans at every level of the windowed 1080p pyramid,
and where a thread takes two columns, on the CPU.

Inputs and what is held: ``tests/_torch_prep_geometry.py``.
"""

import pytest
import torch

from _torch_prep_geometry import (
    GEOMETRIES, _levels,
    tiles_cover_every_output_once_and_stage_their_windows)

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(GEOMETRIES)[4:])
def test_tiles_cover_every_output_once_and_stage_their_windows(name):
    tiles_cover_every_output_once_and_stage_their_windows(name)


def test_column_pairs_only_where_the_level_has_warps_to_spare():
    """A thread takes two columns (K5, K6) only where the level still
    gives every SM WARPS_PER_SM warps: legacy 640x480 pairs K5 at L0-L1
    and K6 at L0, the coarse levels run a column per thread."""
    got = [(w["y_cols"], w["x_cols"])
           for _, w in _levels((480, 640), "legacy", "fused")]
    assert got == [(1, 1), (2, 1), (2, 2)]
