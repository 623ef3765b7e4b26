"""The port's uint8 resizes against the JAX package (the last cases,
within 1 LSB) and the padded channels-first flow upsample (within 1e-5,
pads exactly zero).

Inputs and tolerances: ``tests/_torch_image_ops.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.ops import image as jimg
from ripcurrents_tpu_torch.ops import image as timg

from _torch_image_ops import RESIZE_CASES, resize_u8_within_one_lsb

torch.set_num_threads(1)


@pytest.mark.parametrize("fn,src,dst", RESIZE_CASES[4:])
def test_resize_u8_within_one_lsb(fn, src, dst):
    resize_u8_within_one_lsb(fn, src, dst)


def test_resize_bilinear_cf_padded_matches_jax():
    rng = np.random.default_rng(3)
    src_true, src_pad = (20, 38), (24, 128)
    dst_true, dst_pad = (40, 75), (48, 128)
    x = rng.normal(0, 3, (2,) + src_pad).astype(np.float32)
    want = np.asarray(jimg.resize_bilinear_cf_padded(
        jnp.asarray(x), src_true, dst_true, dst_pad, 2.0))
    got = timg.resize_bilinear_cf_padded(torch.from_numpy(x), src_true,
                                         dst_true, dst_pad, 2.0).numpy()
    assert got.shape == want.shape == (2,) + dst_pad
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[:, dst_true[0]:, :].any()
    assert not got[:, :, dst_true[1]:].any()
