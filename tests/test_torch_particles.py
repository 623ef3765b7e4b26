"""The port's particle systems against the JAX package: the LK
parameters, the streakline and timeline states.

Inputs and tolerances: ``tests/_torch_particles.py``.
"""

import numpy as np
import torch

import jax.numpy as jnp

from ripcurrents_tpu.config import LKParams as JaxLKParams
from ripcurrents_tpu.dynamics import particles as jparts
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.config import LKParams
from ripcurrents_tpu_torch.dynamics import particles as tparts

from _torch_particles import SMALL, T


def test_lk_params_carries_every_field():
    for name in ("particles", "dense_grid", "red_points"):
        assert convert.lk_params(getattr(JaxLKParams, name)()) == \
            getattr(LKParams, name)()
    assert convert.lk_params(SMALL) == LKParams((15, 15), 2, 10, 0.03, 1e-4)


def test_streakline_init_and_advance_match_jax():
    rng = np.random.default_rng(1)
    cap = 12
    js = jparts.streakline_init((40.0, 30.0), cap)
    ts = tparts.streakline_init((40.0, 30.0), cap)
    for _ in range(4):
        # some jumps beyond 10% of the frame are rejected
        tracked = np.asarray(js.vertices) + \
            rng.normal(0, 8, (cap, 2)).astype(np.float32)
        js = jparts.streakline_advance(js, jnp.asarray(tracked), 128, 96)
        ts = tparts.streakline_advance(ts, T(tracked), 128, 96)
        np.testing.assert_array_equal(ts.vertices.numpy(),
                                      np.asarray(js.vertices))
        assert int(ts.count) == int(js.count)
    assert ts.count.dtype == torch.int32


def test_streakline_advance_batches_systems():
    rng = np.random.default_rng(2)
    n, cap = 3, 6
    gens = rng.uniform(0, 90, (n, 2)).astype(np.float32)
    verts = rng.uniform(0, 90, (n, cap, 2)).astype(np.float32)
    count = np.array([1, cap - 1, cap], np.int32)
    tracked = verts + rng.normal(0, 6, verts.shape).astype(np.float32)
    both = tparts.streakline_advance(
        tparts.StreaklineState(T(gens), T(verts), T(count)), T(tracked),
        128, 96)
    for i in range(n):
        one = jparts.streakline_advance(
            jparts.StreaklineState(jnp.asarray(gens[i]),
                                   jnp.asarray(verts[i]),
                                   jnp.asarray(count[i])),
            jnp.asarray(tracked[i]), 128, 96)
        np.testing.assert_array_equal(both.vertices[i].numpy(),
                                      np.asarray(one.vertices))
        assert int(both.count[i]) == int(one.count)


def test_timeline_init_matches_jax():
    want = jparts.timeline_init((10.0, 150.0), (630.0, 400.0), 200)
    got = tparts.timeline_init((10.0, 150.0), (630.0, 400.0), 200)
    assert got.vertices.shape == (201, 2)
    np.testing.assert_array_equal(got.vertices.numpy(),
                                  np.asarray(want.vertices))
