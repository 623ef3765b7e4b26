"""The port's grayscale and Gaussian kernel against the JAX package,
exact.

Inputs and tolerances: ``tests/_torch_image_ops.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.ops import image as jimg
from ripcurrents_tpu_torch.ops import image as timg
from ripcurrents_tpu_torch.ops.conv import gaussian_kernel

from _torch_image_ops import _img

torch.set_num_threads(1)


def test_bgr_to_gray_exact():
    img = _img((72, 128, 3))
    want = np.asarray(jimg.bgr_to_gray(jnp.asarray(img)))
    got = timg.bgr_to_gray(torch.from_numpy(img)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (5, 0.5), (7, 1.5)])
def test_gaussian_kernel_matches_jax(ksize, sigma):
    from ripcurrents_tpu.ops.conv import gaussian_kernel as jax_kernel
    np.testing.assert_array_equal(gaussian_kernel(ksize, sigma),
                                  jax_kernel(ksize, sigma))
