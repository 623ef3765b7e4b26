"""Inputs, bounds and helpers shared by ``test_torch_lk.py``,
``test_torch_lk_levels.py``, ``test_torch_lk_gather.py``,
``test_torch_lk_pallas.py``. The tests are split into files of at most 4
collected tests, so that xdist's ``--dist loadfile`` starts each after
``tests/test_spatial.py``.

The port's sparse Lucas-Kanade tracker (its plain PyTorch version, which
is what runs on CPU tensors) against the JAX package on the same numpy
inputs: the uint8 pyramid exact, Scharr within 1e-5, tracked points
against ``pyr_lk(impl="gather")`` (median < 1e-3 px, 99% < 0.05 px, err
rtol 1e-4: both follow the same arithmetic and differ by float32
summation order only), and against the Pallas kernel in interpret mode on
interior points at that kernel's own test bounds (median < 0.05 px, p90
< 0.5 px: the TPU kernel freezes its halo and clamps at the border).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu.flow import lucas_kanade as jlk
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.flow import lucas_kanade as tlk

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
