"""Polylines with a validity mask, and each particle system's tracked
step, against the JAX package.

Inputs and tolerances: ``tests/_torch_particles.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu.dynamics import particles as jparts
from ripcurrents_tpu.viz import draw as jdraw
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.dynamics import particles as tparts
from ripcurrents_tpu_torch.viz import draw as tdraw

from _torch_particles import SMALL, T, _canvas, _pair


def test_draw_polyline_with_valid_exact():
    img = _canvas(3)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-5, 85, (12, 2)).astype(np.float32)
    valid = np.arange(12) < 7
    for thickness in (1, 2):
        want = jdraw.draw_polyline(jnp.asarray(img), jnp.asarray(pts),
                                   (0, 0, 100), thickness,
                                   valid=jnp.asarray(valid))
        got = tdraw.draw_polyline(T(img), T(pts), (0, 0, 100), thickness,
                                  valid=T(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("system", ["timeline", "population", "streakline"])
def test_tracked_step_matches_jax(system):
    f0, f1 = _pair()
    rng = np.random.default_rng(5)
    verts = np.stack([rng.uniform(5, 123, 16),
                      rng.uniform(5, 91, 16)], 1).astype(np.float32)
    p = convert.lk_params(SMALL)
    if system == "streakline":
        js = jparts.StreaklineState(jnp.asarray(verts[0]),
                                    jnp.asarray(verts), jnp.asarray(5))
        ts = tparts.StreaklineState(T(verts[0]), T(verts), torch.tensor(5))
        want = jparts.streakline_step(js, jnp.asarray(f0), jnp.asarray(f1),
                                      SMALL, 128, 96)
        got = tparts.streakline_step(ts, T(f0), T(f1), p, 128, 96)
        assert int(got.count) == int(want.count) == 6
    else:
        jstate = getattr(jparts, f"{system.capitalize()}State")
        tstate = getattr(tparts, f"{system.capitalize()}State")
        want = getattr(jparts, f"{system}_step")(
            jstate(jnp.asarray(verts)), jnp.asarray(f0), jnp.asarray(f1),
            SMALL)
        got = getattr(tparts, f"{system}_step")(tstate(T(verts)), T(f0),
                                                T(f1), p)
    want = jax.tree.map(np.asarray, want)
    d = np.abs(got.vertices.numpy() - want.vertices)
    assert d.max() < 1e-3
    assert np.abs(got.vertices.numpy() - verts).max() > 0.5   # it moved
