"""The rest of the Farneback engine's public surface against the JAX
package, on the CPU: the "shifted" expansion, ``init_flow`` of
``farneback`` / ``farneback_from_expansions`` on both engines,
``channels_first``, and the chunked and multi-stream steps.

- ``poly_exp`` ("shifted" and "banded"), ``_gauss_blur_reflect`` and
  ``farneback_precompute`` with ``poly_impl="shifted"``: within 1e-5 of
  the channel's scale (float32 sums; the resize and banded forms are
  matmuls, summed in another order).
- ``init_flow`` on the portable engine end to end against JAX at 96x128
  (the portable bounds of ``test_torch_warp.py``: median <= 1e-3 px, 99%
  within 0.05 px), and on the fused engine from the same (JAX) tables
  against the TPU's fused engine in interpret mode (the windowed stream
  bounds of ``test_torch_farneback.py``).
- ``farneback_stream_chunk`` and ``farneback_stream_multi`` loop over the
  single-stream engine: equal to stepping by hand, value for value.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.config import FarnebackParams as JaxParams
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.convert import expansions_from_numpy
from ripcurrents_tpu_torch.flow import farneback as tfb

jfb = importlib.import_module("ripcurrents_tpu.flow.farneback")

torch.set_num_threads(1)

REL = 1e-5
H, W = 96, 128


def _close(got, want, axis, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(np.moveaxis(want, axis, 0)).reshape(
        want.shape[axis], -1).max(1)
    scale = np.expand_dims(scale, tuple(i for i in range(want.ndim)
                                        if i != axis % want.ndim))
    assert (np.abs(got - want) <= rel * scale + 1e-30).all(), \
        (np.abs(got - want) / scale).max()


def _frames(n=2, seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    yy = np.mgrid[0:h, 0:w][0].astype(np.float32)
    base = rng.uniform(0, 255, (h, w)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    out = []
    for t in range(n):
        wave = 60 * np.sin(2 * np.pi * (yy / 24.0 - t * 0.11)) * (yy / h)
        out.append(np.clip(np.roll(base, t, axis=1) * 0.7 + wave + 60,
                           0, 255).astype(np.uint8))
    return out


def _init_flow(h=H, w=W):
    """A smooth starting flow of about a pixel."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([1.2 + 0.5 * np.sin(yy / 20.0),
                     0.4 * np.cos(xx / 30.0)], -1).astype(np.float32)


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


@pytest.mark.parametrize("warp_impl", ["tiled", "fused"])
def test_precompute_shifted_matches_jax(warp_impl):
    """JAX on the CPU expands channels last; the port's fused engine takes
    (5, lh, lw) float32 tables and pads them itself."""
    f0 = _frames(1)[0]
    jp = dataclasses.replace(JaxParams.windowed(), poly_impl="shifted",
                             warp_impl="tiled")
    want = jax.jit(lambda a: jfb.farneback_precompute(a, jp))(
        jnp.asarray(f0))
    tp = dataclasses.replace(FarnebackParams.windowed(), poly_impl="shifted",
                             warp_impl=warp_impl)
    got = tfb.farneback_precompute(torch.from_numpy(f0), tp)
    assert len(got) == len(want) == 3
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        g = g.permute(1, 2, 0) if warp_impl == "fused" else g
        _close(g.numpy(), w_, -1)


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


def test_init_flow_fused_engine_matches_tpu_path(monkeypatch):
    """From the same JAX tables, the port's fused engine with init_flow
    against the TPU's fused engine (interpret mode), blocked on before the
    port runs, within the windowed stream bounds of
    test_torch_farneback.py (median < 1e-4 px, mean < 0.003 px, < 0.03%
    of pixels above 0.1 px; its one-bf16-ULP flips of M grow at this
    size). Measured: median 1.2e-7, mean 2.1e-4, max 0.031 px; without
    init_flow the same engines differ by as much (mean 1.7e-4 px)."""
    f0, f1 = _frames()
    init = _init_flow()
    monkeypatch.setattr(jfb, "_pallas_ok",
                        functools.lru_cache(maxsize=1)(lambda: True))
    jp = JaxParams.windowed()
    with pltpu.force_tpu_interpret_mode():
        e0 = jfb.farneback_precompute(jnp.asarray(f0), jp)
        e1 = jfb.farneback_precompute(jnp.asarray(f1), jp)
        want = jfb.farneback_from_expansions(e0, e1, (H, W), jp,
                                             jnp.asarray(init))
        want = np.asarray(jax.block_until_ready(want))
    e0, e1 = ([np.asarray(e) for e in es] for es in (e0, e1))
    got = tfb.farneback_from_expansions(
        expansions_from_numpy(e0), expansions_from_numpy(e1), (H, W),
        FarnebackParams.windowed(), torch.from_numpy(init)).numpy()
    d = np.sqrt(((got - want) ** 2).sum(-1))
    assert np.median(d) < 1e-4 and d.mean() < 0.003 and \
        (d > 0.1).mean() < 3e-4, (np.median(d), d.mean(), d.max())
    plain = tfb.farneback_from_expansions(
        expansions_from_numpy(e0), expansions_from_numpy(e1), (H, W),
        FarnebackParams.windowed()).numpy()
    assert np.abs(plain - got).max() > 0.01          # init_flow is used


@pytest.mark.parametrize("warp_impl", ["fused", "tiled"])
def test_stream_init_flow_and_channels_first(warp_impl):
    """farneback_stream with init_flow equals farneback with it, and
    channels_first is the same flow as (2, h, w)."""
    f0, f1 = (torch.from_numpy(f) for f in _frames())
    init = torch.from_numpy(_init_flow())
    p = dataclasses.replace(FarnebackParams.legacy(), warp_impl=warp_impl)
    exp0 = tfb.farneback_precompute(f0, p)
    flow, exp1 = tfb.farneback_stream(exp0, f1, p, init)
    cf, _ = tfb.farneback_stream(exp0, f1, p, init, channels_first=True)
    assert flow.shape == (H, W, 2) and cf.shape == (2, H, W)
    assert torch.equal(torch.movedim(cf, 0, -1), flow)
    assert torch.equal(tfb.farneback(f0, f1, p, init), flow)
    assert all(torch.equal(a, b) for a, b in
               zip(exp1, tfb.farneback_precompute(f1, p)))


def test_stream_chunk_equals_steps():
    frames = torch.from_numpy(np.stack(_frames(4)))
    p = FarnebackParams.legacy()
    exp = tfb.farneback_precompute(frames[0], p)
    flows, last = tfb.farneback_stream_chunk(exp, frames[1:], p)
    cf, _ = tfb.farneback_stream_chunk(exp, frames[1:], p,
                                       channels_first=True)
    assert flows.shape == (3, H, W, 2) and cf.shape == (3, 2, H, W)
    for t in range(3):
        step, exp = tfb.farneback_stream(exp, frames[t + 1], p)
        assert torch.equal(flows[t], step)
        assert torch.equal(cf[t], torch.movedim(step, -1, 0))
    assert all(torch.equal(a, b) for a, b in zip(last, exp))


@pytest.mark.parametrize("consume", [False, True])
def test_stream_multi_equals_steps(consume):
    """2 streams x 2 frames: each stream stepped by hand. With consume, the
    per-frame reductions come back stacked (N, F) and no flow does."""
    p = dataclasses.replace(FarnebackParams.subtract_average(),
                            warp_impl="tiled")
    frames = torch.from_numpy(np.stack([np.stack(_frames(3, seed=s))
                                        for s in range(2)]))
    firsts = [tfb.farneback_precompute(frames[s, 0], p) for s in range(2)]
    exps = tuple(torch.stack(ts) for ts in zip(*firsts))

    def reduce(fl):
        return fl.mean(dim=(0, 1)), fl.norm(dim=-1).max()

    def flip(f):
        return torch.flip(f, dims=[1])

    out, new = tfb.farneback_stream_multi(
        exps, frames[:, 1:], p, consume=reduce if consume else None,
        frame_map=flip)
    assert len(new) == 3 and all(t.shape[0] == 2 for t in new)
    for s in range(2):
        exp = firsts[s]
        for t in range(2):
            step, exp = tfb.farneback_stream(exp, flip(frames[s, t + 1]), p)
            if consume:
                mean, peak = reduce(step)
                assert out[0].shape == (2, 2, 2) and out[1].shape == (2, 2)
                assert torch.equal(out[0][s, t], mean)
                assert torch.equal(out[1][s, t], peak)
            else:
                assert out.shape == (2, 2, H, W, 2)
                assert torch.equal(out[s, t], step)
        assert all(torch.equal(a[s], b) for a, b in zip(new, exp))
