"""The port's library functions that no pipeline of it calls (ops/conv.py
``pad2d``, ``gaussian_blur``, ``box_blur``, ``pyr_down``; ops/image.py
``rgb_to_gray``, ``resize_bilinear_cf``; ops/morphology.py ``dilate``,
``erode``, ``morph_gradient``) against the JAX functions on the same
numpy inputs.

Tolerances are those of the JAX package's own tests of these functions
(``tests/test_image_ops.py``, ``tests/test_ops_misc.py``,
``tests/test_fused_update.py``): blurs rtol 1e-4 / atol 1e-3 (the
filters are float32 sums of the same taps in the same order), the
channels-first resize rtol = atol = 1e-5, padding, grayscale and
morphology exact.
"""

import jax.numpy as jnp
import numpy as np
import torch

from ripcurrents_tpu.ops import conv as jconv
from ripcurrents_tpu.ops import image as jimg
from ripcurrents_tpu.ops import morphology as jmorph
from ripcurrents_tpu_torch.ops import conv, image, morphology

torch.set_num_threads(1)


def test_conv_matches_jax(rng):
    gray = rng.uniform(0, 255, (45, 61)).astype(np.float32)
    colour = rng.uniform(0, 255, (24, 30, 3)).astype(np.float32)
    for img in (gray, colour):
        for border in ("replicate", "reflect101", "constant"):
            want = np.asarray(jconv.pad2d(jnp.asarray(img), 3, 1, 2, 4,
                                          border))
            got = conv.pad2d(torch.from_numpy(img), 3, 1, 2, 4, border)
            np.testing.assert_array_equal(got.numpy(), want)
        calls = [("gaussian_blur", (3, 0.0)), ("gaussian_blur", (9, 1.5)),
                 ("gaussian_blur", (15, 1.2)), ("box_blur", (5,)),
                 ("pyr_down", ())]
        for name, args in calls:
            want = np.asarray(getattr(jconv, name)(jnp.asarray(img), *args))
            got = getattr(conv, name)(torch.from_numpy(img), *args).numpy()
            assert got.shape == want.shape, name
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3,
                                       err_msg=name)


def test_image_matches_jax(rng):
    rgb = rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        image.rgb_to_gray(torch.from_numpy(rgb)).numpy(),
        np.asarray(jimg.rgb_to_gray(jnp.asarray(rgb))))
    flow = rng.normal(0, 2, (2, 37, 150)).astype(np.float32)
    for out_hw in ((75, 300), (19, 75), (40, 151)):
        want = np.asarray(jimg.resize_bilinear_cf(jnp.asarray(flow), out_hw))
        got = image.resize_bilinear_cf(torch.from_numpy(flow), out_hw)
        assert got.dtype == torch.float32 and got.shape == (2, *out_hw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_morphology_matches_jax(rng):
    mask = (rng.uniform(size=(60, 80)) > 0.8).astype(np.uint8) * 255
    grey = rng.normal(0, 3, (30, 41)).astype(np.float32)
    for img in (mask, grey):
        for shape in ((5, 5), (3, 7)):
            k = morphology.ellipse_kernel(*shape)
            for name in ("dilate", "erode", "morph_gradient"):
                want = np.asarray(getattr(jmorph, name)(jnp.asarray(img), k))
                got = getattr(morphology, name)(torch.from_numpy(img), k)
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=name)
