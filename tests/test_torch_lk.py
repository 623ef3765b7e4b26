"""The port's sparse Lucas-Kanade tracker against the JAX package: the
pyramid, Scharr, the reflect-101 border and the wrapper's checks.

Inputs and tolerances: ``tests/_torch_lk.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.flow import lucas_kanade as jlk
from ripcurrents_tpu_torch.config import LKParams
from ripcurrents_tpu_torch.flow import lucas_kanade as tlk
from ripcurrents_tpu_torch.flow.lk_kernel import lk_track, lk_track_plain

from _torch_lk import _points, pair


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
