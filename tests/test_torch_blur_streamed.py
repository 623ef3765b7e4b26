"""K2's streamed summation order emulated on the CPU against its plain
version bit for bit, box and Gaussian: half-widths 0-5.

Inputs and what is held: ``tests/_torch_blur_geometry.py``.
"""

import pytest
import torch

from _torch_blur_geometry import HALVES, streamed_sums_match_plain_bit_for_bit

torch.set_num_threads(1)


@pytest.mark.parametrize("half", HALVES[:4])
def test_streamed_sums_match_plain_bit_for_bit(half):
    streamed_sums_match_plain_bit_for_bit(half)
