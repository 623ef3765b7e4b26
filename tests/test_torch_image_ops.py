"""The port's frame-prep ops against the JAX package, on the same numpy
inputs: grayscale exact, uint8 resizes within 1 LSB (float32 matmul
rounding can move a value across a .5 boundary), the padded
channels-first flow upsample within 1e-5 with pads exactly zero."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.ops import image as jimg
from ripcurrents_tpu_torch.ops import image as timg
from ripcurrents_tpu_torch.ops.conv import gaussian_kernel

torch.set_num_threads(1)


def _img(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def test_bgr_to_gray_exact():
    img = _img((72, 128, 3))
    want = np.asarray(jimg.bgr_to_gray(jnp.asarray(img)))
    got = timg.bgr_to_gray(torch.from_numpy(img)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["resize_bilinear", "resize_area"])
@pytest.mark.parametrize("src,dst", [((72, 128, 3), (48, 64)),
                                     ((45, 80), (30, 40)),
                                     ((30, 40, 3), (45, 80))])
def test_resize_u8_within_one_lsb(fn, src, dst):
    img = _img(src, seed=len(src))
    want = np.asarray(getattr(jimg, fn)(jnp.asarray(img), dst))
    got = getattr(timg, fn)(torch.from_numpy(img), dst).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


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


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (5, 0.5), (7, 1.5)])
def test_gaussian_kernel_matches_jax(ksize, sigma):
    from ripcurrents_tpu.ops.conv import gaussian_kernel as jax_kernel
    np.testing.assert_array_equal(gaussian_kernel(ksize, sigma),
                                  jax_kernel(ksize, sigma))
