"""Inputs, bounds and helpers shared by ``test_torch_engine_api.py``,
``test_torch_engine_api_init.py``, ``test_torch_engine_api_stream.py``.
The tests are split into files of at most 4 collected tests, so that
xdist's ``--dist loadfile`` starts each after ``tests/test_spatial.py``.

The rest of the Farneback engine's public surface against the JAX
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

import importlib

import numpy as np
import torch


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
