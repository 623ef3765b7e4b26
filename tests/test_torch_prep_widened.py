"""K5's and K6's widened summation order emulated on the CPU against the
plain versions bit for bit: the ragged and one-tile legacy levels.

Inputs and what is held: ``tests/_torch_prep_geometry.py``.
"""

import pytest
import torch

from _torch_prep_geometry import (
    WIDENED_CASES, widened_sums_equal_the_plain_versions_bit_for_bit)

torch.set_num_threads(1)


@pytest.mark.parametrize("hw,preset,warp_impl,pairs", WIDENED_CASES[:3])
def test_widened_sums_equal_the_plain_versions_bit_for_bit(
        hw, preset, warp_impl, pairs, monkeypatch):
    widened_sums_equal_the_plain_versions_bit_for_bit(
        hw, preset, warp_impl, pairs, monkeypatch)
