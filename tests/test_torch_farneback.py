"""The port's Farneback engine (expansion prep + pyramid loop) against
the JAX fused path, on the CPU (JAX Pallas kernels in interpret mode).

Frames are a smooth texture drifting 1 px per frame under moving wave
bands (the pattern of tests/conftest.py beach_frames): the winsize-3
legacy preset is chaotic at weak texture, so white noise would measure
that chaos rather than the port.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.config import FarnebackParams as JaxParams
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.convert import expansions_from_numpy
from ripcurrents_tpu_torch.flow import farneback as tfb

jfb = importlib.import_module("ripcurrents_tpu.flow.farneback")

torch.set_num_threads(1)

H, W = 192, 256


def _frames(n=2, seed=0):
    rng = np.random.default_rng(seed)
    yy = np.mgrid[0:H, 0:W][0].astype(np.float32)
    base = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    out = []
    for t in range(n):
        wave = 60 * np.sin(2 * np.pi * (yy / 24.0 - t * 0.11)) * (yy / H)
        out.append(np.clip(np.roll(base, t, axis=1) * 0.7 + wave + 60,
                           0, 255).astype(np.uint8))
    return out


def _level_args(k):
    return jfb._prep_level_args(H, W, JaxParams.legacy(), k)


def _jax_poly(img, args):
    _, _, lh, lw, n, sig, ss, bs, ph, pw, off = args
    return np.asarray(jfb.poly_exp_level(
        jnp.asarray(img, jnp.float32), lh, lw, n, sig, ss, bs,
        channels_first=True, pad_hw=(ph, pw), pad_off=off,
        out_dtype=jnp.bfloat16)).astype(np.float32)


def _port_poly(img, args, operand_dtype=torch.bfloat16):
    """The port's channels-first bf16 level table: the banded K5/K6 plain
    versions (bf16 operands), or the dense form with float32 operands."""
    _, _, lh, lw, n, sig, ss, bs, ph, pw, off = args
    f = torch.from_numpy(img).to(torch.float32)
    if operand_dtype == torch.float32:
        out = tfb.poly_exp_level_dense(f, lh, lw, n, sig, ss, bs, (ph, pw),
                                       off, torch.bfloat16, torch.float32)
    else:
        out = tfb.poly_exp_level(f, lh, lw, n, sig, ss, bs,
                                 channels_first=True, pad_hw=(ph, pw),
                                 pad_off=off, out_dtype=torch.bfloat16)
    return out.to(torch.float32).numpy()


@pytest.mark.parametrize("level", [2, 1, 0])
def test_poly_exp_level_matches_jax_dense(level, monkeypatch):
    """With float32 operands, the dense f32 form (the JAX CPU path): within
    one bf16 ULP (measured identical)."""
    monkeypatch.setattr(jfb, "_pallas_ok",
                        functools.lru_cache(maxsize=1)(lambda: False))
    img = _frames(1)[0]
    args = _level_args(level)
    want = _jax_poly(img, args)
    got = _port_poly(img, args, operand_dtype=torch.float32)
    assert got.shape == want.shape == (5, args[8], args[9])
    assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7).all()


@pytest.mark.parametrize("level", [2, 1, 0])
def test_poly_exp_level_vs_tpu_blocked_bf16(level, monkeypatch):
    """With its default bf16 operands, against the blocked path the TPU
    runs (bf16 matmul inputs, f32 accumulation): the bound of the TPU's
    own prep kernel against that path (tests/test_fused_update.py), mean
    |d| < 1e-4 and under 0.1% of entries off by more than 0.01. Measured
    at 192x256: mean 2e-7 to 3.4e-6, 5e-6 to 6e-5 above 0.01 (one-ULP bf16
    flips from the summation order). Pads exactly zero."""
    monkeypatch.setattr(jfb, "_pallas_ok",
                        functools.lru_cache(maxsize=1)(lambda: True))
    img = _frames(1)[0]
    args = _level_args(level)
    want, got = _jax_poly(img, args), _port_poly(img, args)
    d = np.abs(got - want)
    assert d.mean() < 1e-4, d.mean()
    assert (d > 0.01).mean() < 1e-3, (d > 0.01).mean()
    _, _, lh, lw, *_ = args
    pad = np.ones(got.shape[1:], bool)
    pad[32:32 + lh, 128:128 + lw] = False
    assert not got[:, pad].any()


def _flow_dev(got, want):
    d = np.sqrt(((got - want) ** 2).sum(-1))
    return np.median(d), d.mean(), (d > 0.1).mean()


# (median, mean, fraction > 0.1 px) of the stream's flow deviation, ~3x
# the measured (see test_stream_matches_tpu_fused_path)
STREAM_BOUNDS = {"legacy": (1e-4, 0.006, 0.007),
                 "windowed": (1e-4, 0.003, 3e-4)}


@pytest.fixture(scope="module", params=list(STREAM_BOUNDS))
def tpu_stream(request):
    """One stream step from the JAX expansions of frame 0, on the JAX side
    exactly as the TPU runs it (fused kernels in interpret mode, blocked
    bf16 prep): (preset, JAX flow, JAX expansions of both frames, port
    flow, port expansions of frame 1)."""
    preset = request.param
    mp = pytest.MonkeyPatch()
    mp.setattr(jfb, "_pallas_ok",
               functools.lru_cache(maxsize=1)(lambda: True))
    try:
        f0, f1 = _frames(2)
        jp = getattr(JaxParams, preset)()
        tp = getattr(FarnebackParams, preset)()
        with pltpu.force_tpu_interpret_mode():
            e0 = jfb.farneback_precompute(jnp.asarray(f0), jp)
            want, e1 = jfb.farneback_stream(e0, jnp.asarray(f1), jp)
    finally:
        mp.undo()
    e0, e1 = ([np.asarray(e) for e in es] for es in (e0, e1))
    got, nxt = tfb.farneback_stream(expansions_from_numpy(e0),
                                    torch.from_numpy(f1), tp)
    return preset, np.asarray(want), (e0, e1), got, nxt


def test_stream_matches_tpu_fused_path(tpu_stream):
    """farneback_stream end to end against the JAX engine as the TPU runs
    it. The new frame's tables differ by one-ULP bf16 flips (mean < 1e-5),
    which the chaotic winsize-3 legacy preset amplifies at a few pixels.
    Measured at 192x256: legacy median 1.2e-7 / mean 0.0018 px with 0.22%
    of pixels above 0.1 px; windowed 3.6e-7 / 0.0010 px with 0.004%."""
    preset, want, _, got, nxt = tpu_stream
    assert got.shape == (H, W, 2) and len(nxt) == 3
    med, mean, frac = _flow_dev(got.numpy(), want)
    bounds = STREAM_BOUNDS[preset]
    assert med < bounds[0] and mean < bounds[1] and frac < bounds[2], \
        (med, mean, frac)


def test_engine_matches_tpu_fused_path(tpu_stream):
    """From the same expansion tables (the JAX ones of both frames) the
    port's pyramid loop agrees with the TPU's fused engine. Measured at
    192x256: median <= 1.2e-7 px, mean <= 2.1e-5 px, nothing above
    0.1 px."""
    preset, want, (e0, e1), _, _ = tpu_stream
    same = tfb.farneback_from_expansions(
        expansions_from_numpy(e0), expansions_from_numpy(e1), (H, W),
        getattr(FarnebackParams, preset)())
    med, mean, frac = _flow_dev(same.numpy(), want)
    assert med < 1e-4 and mean < 1e-4 and frac == 0.0, (med, mean, frac)


def test_engine_rejects_unported_warps():
    import dataclasses
    for kw in ({"warp_impl": "tiled"}, {"poly_impl": "shifted"}):
        p = dataclasses.replace(FarnebackParams.legacy(), **kw)
        with pytest.raises(ValueError, match="ROADMAP"):
            tfb.farneback_precompute(torch.zeros((H, W)), p)
