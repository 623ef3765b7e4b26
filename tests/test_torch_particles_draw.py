"""The population's initial points, and the circles and blend of the
overlays, against the JAX package.

Inputs and tolerances: ``tests/_torch_particles.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.viz import draw as jdraw
from ripcurrents_tpu_torch.dynamics import particles as tparts
from ripcurrents_tpu_torch.viz import draw as tdraw

from _torch_particles import T, _canvas


@pytest.mark.parametrize("bias", [True, False])
def test_population_init_range(bias):
    """With the reference's rand()+1 quirk the points land in [rect_end,
    2*rect_end - rect_start]; without it, inside the rectangle."""
    s, e = np.array([250.0, 150.0]), np.array([300.0, 200.0])
    gen = torch.Generator().manual_seed(3)
    v = tparts.population_init(tuple(s), tuple(e), 500, gen, bias)\
        .vertices.numpy()
    lo, hi = (e, 2 * e - s) if bias else (s, e)
    assert v.shape == (500, 2) and v.dtype == np.float32
    assert (v >= lo).all() and (v <= hi).all()
    assert (v.max(0) - v.min(0) > 0.9 * (e - s)).all()
    again = tparts.population_init(tuple(s), tuple(e), 500,
                                   torch.Generator().manual_seed(3), bias)
    np.testing.assert_array_equal(again.vertices.numpy(), v)


def test_draw_circles_exact():
    img = _canvas()
    centers = np.array([[10.5, 10.5], [11.5, 20.5], [0.2, 0.7], [79.6, 59.4],
                        [-3.0, 30.0], [200.0, 10.0], [40.49, 29.51]],
                       np.float32)
    valid = np.array([1, 1, 1, 1, 1, 1, 0], bool)
    for radius, v in ((4, None), (2, valid), (10, valid)):
        want = jdraw.draw_circles(
            jnp.asarray(img), jnp.asarray(centers), radius, (100, 0, 0),
            None if v is None else jnp.asarray(v))
        got = tdraw.draw_circles(T(img), T(centers), radius, (100, 0, 0),
                                 None if v is None else T(v))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_blend_exact():
    a, b = _canvas(1), _canvas(2)
    for alpha, beta in ((0.5, 0.5), (0.3, 0.9)):
        want = jdraw.blend(jnp.asarray(a), jnp.asarray(b), alpha, beta)
        got = tdraw.blend(T(a), T(b), alpha, beta)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
