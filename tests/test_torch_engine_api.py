"""The Farneback engine's expansions and ``init_flow`` on the portable
engine against the JAX package.

Inputs and tolerances: ``tests/_torch_engine_api.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu.config import FarnebackParams as JaxParams
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb

from _torch_engine_api import REL, _close, _frames, _init_flow, jfb


@pytest.mark.parametrize("impl", ["shifted", "banded"])
def test_poly_exp_matches_jax(impl):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (75, 107)).astype(np.float32)
    for cf in (False, True):
        want = jax.jit(functools.partial(
            jfb.poly_exp, n=15, sigma=1.2, channels_first=cf, impl=impl))(
                jnp.asarray(img))
        got = tfb.poly_exp(torch.from_numpy(img), 15, 1.2,
                           channels_first=cf, impl=impl)
        _close(got.numpy(), want, 0 if cf else -1)


def test_gauss_blur_and_correlations_match_jax():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (40, 57)).astype(np.float32)
    for ksize, sigma in ((5, 1.0), (9, 1.5)):
        k = np.asarray(tfb.gaussian_kernel(ksize, sigma), np.float32)
        want = jfb._gauss_blur_reflect(jnp.asarray(img), jnp.asarray(k))
        got = tfb._gauss_blur_reflect(torch.from_numpy(img), k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=REL, atol=1e-4)
    ks = [np.array([0.25, 0.5, 0.25], np.float32),
          np.array([-1.0, 0.0, 1.0], np.float32)]
    for axis in (0, 1):
        for got, want in zip(tfb._corr1d_multi(torch.from_numpy(img), ks,
                                               axis),
                             jfb._corr1d_multi(jnp.asarray(img), ks, axis)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_flow_portable_engine_matches_jax(monkeypatch):
    """farneback with init_flow on the tiled portable engine against the
    JAX one on the TPU's prep; the start flow changes the result."""
    f0, f1 = _frames()
    init = _init_flow()
    monkeypatch.setattr(jfb, "_pallas_ok",
                        functools.lru_cache(maxsize=1)(lambda: True))
    jp = dataclasses.replace(JaxParams.subtract_average(), warp_impl="tiled")
    want = np.asarray(jax.jit(lambda a, b, i: jfb.farneback(a, b, jp, i))(
        jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(init)))
    tp = dataclasses.replace(FarnebackParams.subtract_average(),
                             warp_impl="tiled")
    got = tfb.farneback(torch.from_numpy(f0), torch.from_numpy(f1), tp,
                        torch.from_numpy(init)).numpy()
    d = np.sqrt(((got - want) ** 2).sum(-1))
    assert np.median(d) <= 1e-3 and (d <= 0.05).mean() >= 0.99, \
        (np.median(d), (d <= 0.05).mean())
    plain = tfb.farneback(torch.from_numpy(f0), torch.from_numpy(f1),
                          tp).numpy()
    assert np.abs(plain - got).max() > 0.01          # init_flow is used
