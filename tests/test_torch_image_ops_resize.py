"""The port's uint8 resizes against the JAX package, within 1 LSB: the
first four cases.

Inputs and tolerances: ``tests/_torch_image_ops.py``.
"""

import pytest
import torch

from _torch_image_ops import RESIZE_CASES, resize_u8_within_one_lsb

torch.set_num_threads(1)


@pytest.mark.parametrize("fn,src,dst", RESIZE_CASES[:4])
def test_resize_u8_within_one_lsb(fn, src, dst):
    resize_u8_within_one_lsb(fn, src, dst)
