"""The port's dense LK (``flow/dense_lk.py``) and
``farneback_stream_lagged`` against the JAX package, on the CPU, on the
same numpy inputs made from a seed.

Tolerances, as measured:

- ``dense_lk`` (``LKParams.dense_grid()``: window 21, 3 levels, 30
  iterations) at 96x128 and 120x160 on a (2, 1) px shift of smoothed
  noise: flow within FLOW_PX of JAX's everywhere, median within 1e-6 px
  (measured: max 7.2e-7, median 1.2e-7 px; the banded window sums are
  matrix products summed in another order), status equal on >= 99.9% of
  pixels (measured: all); one tiled warp (K8 on the card) per iteration
  and level;
- ``farneback_stream_lagged`` on the tiled portable engine over 3 frames:
  each flow equal to ``farneback_stream``'s of the same pair, value for
  value, and within the portable engine's bounds of JAX's lagged stream
  (median <= 1e-3 px, 99% within 0.05 px; ``test_torch_engine_api.py``).
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu.config import FarnebackParams as JaxParams
from ripcurrents_tpu.config import LKParams as JaxLK
from ripcurrents_tpu.flow import dense_lk as jdl
from ripcurrents_tpu_torch.config import FarnebackParams, LKParams
from ripcurrents_tpu_torch.flow import dense_lk as tdl
from ripcurrents_tpu_torch.flow import farneback as tfb

jfb = importlib.import_module("ripcurrents_tpu.flow.farneback")

torch.set_num_threads(1)

FLOW_PX = 1e-4


def _shifted_pair(h, w, seed=3, dx=2, dy=1):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h + 8, w + 8)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    return (base[4:4 + h, 4:4 + w].astype(np.uint8),
            base[4 - dy:4 - dy + h, 4 - dx:4 - dx + w].astype(np.uint8))


@pytest.mark.parametrize("hw", [(96, 128), (120, 160)])
def test_dense_lk_matches_jax(hw, monkeypatch):
    a, b = _shifted_pair(*hw)
    jf, js = jdl.dense_lk(jnp.asarray(a), jnp.asarray(b),
                          JaxLK.dense_grid())
    calls = []
    warp = tdl._warp5_tiled

    def counted(table, flow, bres):
        calls.append((tuple(table.shape), bres, flow.is_contiguous()))
        return warp(table, flow, bres=bres)
    monkeypatch.setattr(tdl, "_warp5_tiled", counted)
    tf, ts = tdl.dense_lk(torch.from_numpy(a), torch.from_numpy(b),
                          LKParams.dense_grid())
    d = np.abs(tf.numpy() - np.asarray(jf))
    assert d.max() <= FLOW_PX and np.median(d) <= 1e-6, \
        (d.max(), np.median(d))
    assert (ts.numpy() == np.asarray(js)).mean() >= 0.999
    assert ts.dtype == torch.bool and tf.shape == hw + (2,)
    mean = tf.numpy()[ts.numpy()].mean(0)
    assert np.abs(mean - (2, 1)).max() < 0.1
    levels = tdl.pyramid_levels(hw, LKParams.dense_grid()) + 1
    assert len(calls) == 30 * levels
    assert all(c[0][-1] == 1 and c[1] == 4 and c[2] for c in calls)


def test_farneback_stream_lagged_matches_jax_and_stream(monkeypatch):
    rng = np.random.default_rng(0)
    h, w = 96, 128
    yy = np.mgrid[0:h, 0:w][0].astype(np.float32)
    base = rng.uniform(0, 255, (h, w)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    frames = [np.clip(np.roll(base, t, axis=1) * 0.7 + 60 + 60 * np.sin(
        2 * np.pi * (yy / 24.0 - t * 0.11)) * (yy / h), 0, 255)
        .astype(np.uint8) for t in range(5)]
    monkeypatch.setattr(jfb, "_pallas_ok",
                        functools.lru_cache(maxsize=1)(lambda: True))
    jp = dataclasses.replace(JaxParams.subtract_average(), warp_impl="tiled")
    tp = dataclasses.replace(FarnebackParams.subtract_average(),
                             warp_impl="tiled")
    jstep = jax.jit(lambda c, f: jfb.farneback_stream_lagged(c, f, jp))
    jcarry = (jfb.farneback_precompute(jnp.asarray(frames[0]), jp),
              jfb.farneback_precompute(jnp.asarray(frames[1]), jp))
    t = [torch.from_numpy(f) for f in frames]
    carry = (tfb.farneback_precompute(t[0], tp),
             tfb.farneback_precompute(t[1], tp))
    exp = carry[0]
    for i in range(2, 5):
        jflow, jcarry = jstep(jcarry, jnp.asarray(frames[i]))
        flow, carry = tfb.farneback_stream_lagged(carry, t[i], tp)
        want, exp = tfb.farneback_stream(exp, t[i - 1], tp)
        assert torch.equal(flow, want)
        d = np.sqrt(((flow.numpy() - np.asarray(jflow)) ** 2).sum(-1))
        assert np.median(d) <= 1e-3 and (d <= 0.05).mean() >= 0.99, \
            (i, np.median(d), (d <= 0.05).mean())
    assert all(torch.equal(a, b) for a, b in zip(
        carry[1], tfb.farneback_precompute(t[4], tp)))
    assert float(flow[..., 0].mean()) > 0.5       # the texture moves
