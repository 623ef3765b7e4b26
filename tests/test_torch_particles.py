"""The port's particle systems and overlay drawing against the JAX package
on the same numpy inputs: state updates and rasterization exact (integer
pixels, float32 ops in the same order), LK-tracked steps within 1e-3 px
(float32 summation order inside the tracker)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu.config import LKParams as JaxLKParams
from ripcurrents_tpu.dynamics import particles as jparts
from ripcurrents_tpu.viz import draw as jdraw
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.config import LKParams
from ripcurrents_tpu_torch.dynamics import particles as tparts
from ripcurrents_tpu_torch.viz import draw as tdraw

torch.set_num_threads(1)

T = torch.from_numpy
SMALL = JaxLKParams((15, 15), 2, 10, 0.03, 1e-4)


def _pair(h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h + 8, w + 8)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    return (base[4:h + 4, 4:w + 4].astype(np.uint8),
            base[3:h + 3, 2:w + 2].astype(np.uint8))


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


def _canvas(seed=0, h=60, w=80):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


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
