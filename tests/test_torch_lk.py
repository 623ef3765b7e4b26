"""The port's sparse Lucas-Kanade tracker (its plain PyTorch version, which
is what runs on CPU tensors) against the JAX package on the same numpy
inputs: the uint8 pyramid exact, Scharr within 1e-5, tracked points
against ``pyr_lk(impl="gather")`` (median < 1e-3 px, 99% < 0.05 px, err
rtol 1e-4: both follow the same arithmetic and differ by float32
summation order only), and against the Pallas kernel in interpret mode on
interior points at that kernel's own test bounds (median < 0.05 px, p90
< 0.5 px: the TPU kernel freezes its halo and clamps at the border)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu.config import LKParams as JaxLKParams
from ripcurrents_tpu.flow import lucas_kanade as jlk
from ripcurrents_tpu.flow.lk_pallas import pyr_lk_pallas
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.config import LKParams
from ripcurrents_tpu_torch.flow import lucas_kanade as tlk
from ripcurrents_tpu_torch.flow.lk_kernel import lk_track, lk_track_plain

torch.set_num_threads(1)

H, W = 160, 200


def _frames():
    """A drifting smooth texture under moving wave bands, two frames."""
    rng = np.random.default_rng(77)
    yy = np.mgrid[0:H, 0:W][0].astype(np.float32)
    base = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)

    def make(t):
        wave = 60 * np.sin(2 * np.pi * (yy / 24.0 - t * 0.11)) * (yy / H)
        drift = np.roll(base, shift=t, axis=1)
        return np.clip(drift * 0.7 + wave + 60, 0, 255).astype(np.uint8)
    return make(0), make(1)


@pytest.fixture(scope="module")
def pair():
    return _frames()


def _points(n, seed, margin=-12.0):
    """n random points from `margin` px inside the border (negative:
    outside it), plus corners and points far outside the image."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(margin, W - margin, n),
                    rng.uniform(margin, H - margin, n)], axis=1)
    extra = [[0, 0], [W - 1, H - 1], [0.5, H - 1.5], [-300, -300],
             [5000, 20], [W + 60, H + 60]]
    return np.concatenate([pts, extra]).astype(np.float32)


def _gather(f0, f1, pts, p):
    res = jlk.pyr_lk(jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(pts), p,
                     impl="gather")
    return jax.tree.map(np.asarray, res)


def _port(f0, f1, pts, p):
    return tlk.pyr_lk(torch.from_numpy(f0), torch.from_numpy(f1),
                      torch.from_numpy(pts), convert.lk_params(p))


def _check_against_gather(got, want, p):
    d = np.sqrt(((got.points.numpy() - want.points) ** 2).sum(-1))
    assert np.isfinite(d).all()
    assert np.median(d) < 1e-3 and np.percentile(d, 99) < 0.05
    np.testing.assert_allclose(got.err.numpy(), want.err, rtol=1e-4,
                               atol=1e-7)
    # the port's status adds the min-eigenvalue gate to the gather path's
    expect = want.status & (want.err >= p.min_eig_threshold)
    assert (got.status.numpy() == expect).mean() >= 0.99


def test_build_pyramid_is_exact(pair):
    want = jlk.build_pyramid(jnp.asarray(pair[0]), 3)
    got = tlk.build_pyramid(torch.from_numpy(pair[0]), 3)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a batch of frames goes through the same ops
    both = tlk.build_pyramid(torch.from_numpy(np.stack(pair)), 3)
    for g, b in zip(got, both):
        assert torch.equal(g, b[0])


def test_scharr_matches_jax(pair):
    lvl = jlk.build_pyramid(jnp.asarray(pair[1]), 1)[1]
    want = jlk._scharr(lvl)
    got = tlk._scharr(torch.from_numpy(np.array(lvl)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_reflect101_beyond_one_period():
    idx = np.arange(-40, 40, dtype=np.int32)
    want = np.asarray(jlk._reflect101(jnp.asarray(idx), 7))
    got = tlk._reflect101(torch.from_numpy(idx), 7).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,p,want", [
    ((480, 640), LKParams.particles(), 3),
    ((30, 40), LKParams.particles(), 0),
])
def test_pyramid_levels_shrink_to_the_window(hw, p, want):
    assert tlk.pyramid_levels(hw, p) == want
    assert tlk.pyramid_levels((160, 200), LKParams.particles()) == 1
    assert tlk.pyramid_levels((96, 128), LKParams.red_points()) == 2


@pytest.mark.parametrize("preset", ["particles", "dense_grid"])
def test_plain_pyr_lk_matches_gather(pair, preset):
    """Interior, border and out-of-image points."""
    p = getattr(JaxLKParams, preset)()
    pts = _points(40, seed=3)
    _check_against_gather(_port(*pair, pts, p), _gather(*pair, pts, p), p)


def test_plain_pyr_lk_1300_points_in_one_call(pair):
    """More points than the TPU kernel's 384-point chunks hold."""
    p = JaxLKParams((15, 15), 2, 10, 0.03, 1e-4)
    pts = _points(1294, seed=5, margin=4.0)
    assert len(pts) == 1300
    _check_against_gather(_port(*pair, pts, p), _gather(*pair, pts, p), p)


def test_two_stream_batch_equals_two_single_calls(pair):
    p = LKParams((15, 15), 2, 10, 0.03, 1e-4)
    f = torch.from_numpy(np.stack(pair))
    prev, nxt = f, torch.flip(f, dims=(0,))
    pts = torch.from_numpy(np.stack([_points(30, 1), _points(30, 2)]))
    both = tlk.pyr_lk(prev, nxt, pts, p)
    assert both.points.shape == (2, 36, 2) and both.status.shape == (2, 36)
    for s in range(2):
        one = tlk.pyr_lk(prev[s], nxt[s], pts[s], p)
        for a, b in zip(both, one):
            assert torch.equal(a[s], b)


@pytest.mark.parametrize("preset", ["particles", "dense_grid"])
def test_plain_pyr_lk_matches_pallas_interior(pair, preset):
    p = getattr(JaxLKParams, preset)()
    m = max(p.win) // 2 + 6
    pts = _points(24, seed=11, margin=float(m))[:24]
    want = pyr_lk_pallas(jnp.asarray(pair[0]), jnp.asarray(pair[1]),
                         jnp.asarray(pts), p, interpret=True)
    got = _port(*pair, pts, p)
    st = np.asarray(want.status)
    d = np.sqrt(((got.points.numpy() - np.asarray(want.points)) ** 2)
                .sum(-1))[st]
    assert np.median(d) < 0.05 and np.percentile(d, 90) < 0.5
    # interior points: the TPU kernel's status rule is the port's
    assert (got.status.numpy() == st).mean() > 0.85


def test_status_includes_the_min_eigenvalue_gate(pair):
    """A textureless half: the gather path reports its points tracked,
    the port (like cv2 and the TPU kernel) does not."""
    f0, f1 = (f.copy() for f in pair)
    f0[:, :W // 2] = 90
    f1[:, :W // 2] = 90
    p = JaxLKParams.dense_grid()
    pts = _points(40, seed=9, margin=14.0)[:40]
    want = _gather(f0, f1, pts, p)
    got = _port(f0, f1, pts, p)
    gated = want.err < p.min_eig_threshold
    assert gated.sum() >= 5 and want.status[gated].all()
    assert not got.status.numpy()[gated].any()
    np.testing.assert_array_equal(got.status.numpy(), want.status & ~gated)


def test_iteration_count_and_wrapper_checks(pair):
    p = LKParams((15, 15), 2, 10, 0.03, 1e-4)
    f = torch.from_numpy(np.stack(pair))
    pyr_prev, pyr_next, derivs = tlk.prepare(f[:1], f[1:], p)
    pts = torch.from_numpy(_points(20, 4))[None]
    out, iters = lk_track(pyr_prev, pyr_next, derivs, pts, p)
    out2, iters2 = lk_track_plain(pyr_prev, pyr_next, derivs, pts, p)
    assert torch.equal(out, out2) and torch.equal(iters, iters2)
    assert lk_track.launches == 0          # CPU tensors launch no kernel
    assert iters.dtype == torch.int32 and int(iters.max()) <= 3 * 10
    assert int(iters[0, -3:].sum()) == 0   # points far outside never iterate
    with pytest.raises(ValueError):
        lk_track(pyr_prev, pyr_next, derivs, pts.double(), p)
    with pytest.raises(ValueError):
        lk_track(pyr_prev, pyr_next[:-1], derivs, pts, p)
    with pytest.raises(ValueError):
        tlk.pyr_lk(f[0], f[1, :-1], pts[0], p)
