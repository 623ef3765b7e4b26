"""K4's plain version against the dense two-matmul form it replaces, bit
for bit.

Inputs and tolerances: ``tests/_torch_resize_padded.py``.
"""

import pytest
import torch

from ripcurrents_tpu_torch.ops import image as timg

from _torch_resize_padded import GEOMETRIES, _flow

torch.set_num_threads(1)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_plain_equals_dense_bit_for_bit(geom):
    src_true, dst_true, src_pad, dst_pad, scale = geom
    img = torch.from_numpy(_flow((2,) + src_pad))
    got = timg.resize_bilinear_cf_padded(img, src_true, dst_true, dst_pad,
                                         scale)
    key = timg.resize_key(img, src_true, dst_true, dst_pad, scale)
    want = timg.resize_cf_padded_dense(img, key)
    assert got.shape == (2,) + dst_pad and got.dtype == torch.float32
    assert float((got - want).abs().max()) == 0.0
    assert timg.resize_bilinear_cf_padded.launches == 0   # no kernel on CPU
