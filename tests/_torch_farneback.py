"""Inputs, bounds and helpers shared by ``test_torch_farneback.py``,
``test_torch_farneback_bf16.py``, ``test_torch_farneback_stream.py``.
The tests are split into files of at most 4 collected tests, so that
xdist's ``--dist loadfile`` starts each after ``tests/test_spatial.py``.

The port's Farneback engine (expansion prep + pyramid loop) against
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
