"""``farneback_precompute`` with the shifted expansion, ``init_flow``
on the fused engine against the TPU path, and the chunked stream.

Inputs and tolerances: ``tests/_torch_engine_api.py``.
"""

import dataclasses
import functools

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

from _torch_engine_api import H, W, _close, _frames, _init_flow, jfb


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
