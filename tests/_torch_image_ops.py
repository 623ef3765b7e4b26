"""The port's frame-prep ops against the JAX package, on the same numpy
inputs: grayscale exact, uint8 resizes within 1 LSB (float32 matmul
rounding can move a value across a .5 boundary), the padded
channels-first flow upsample within 1e-5 with pads exactly zero.

Inputs and the resize test's body, shared by ``test_torch_image_ops.py``,
``test_torch_image_ops_resize.py`` and ``test_torch_image_ops_padded.py``.
"""

import numpy as np
import torch

import jax.numpy as jnp

from ripcurrents_tpu.ops import image as jimg
from ripcurrents_tpu_torch.ops import image as timg

# (fn, src, dst) of test_resize_u8_within_one_lsb
RESIZE_CASES = [(fn, src, dst)
                for src, dst in [((72, 128, 3), (48, 64)),
                                 ((45, 80), (30, 40)),
                                 ((30, 40, 3), (45, 80))]
                for fn in ["resize_bilinear", "resize_area"]]


def _img(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def resize_u8_within_one_lsb(fn, src, dst):
    img = _img(src, seed=len(src))
    want = np.asarray(getattr(jimg, fn)(jnp.asarray(img), dst))
    got = getattr(timg, fn)(torch.from_numpy(img), dst).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
