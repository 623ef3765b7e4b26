"""K7 (warp5_shift) and the portable Farneback engine against the JAX
package, on the CPU.

- K7's plain version against ``warp5_shift_pallas`` in interpret mode (the
  TPU's (2b+2)^2-tap sum) at small budgets, everywhere, displacements
  beyond the budget included: the same function, whose extra terms are
  exact zeros, summed by XLA with its own roundings (|d| <= 1e-6,
  measured 1.2e-7); and against the exact bilinear
  gather on the pixels the mask keeps (<= 5e-5, the JAX package's bound).
- ``update_matrices`` ("gather", "shift", and "pallas" against the JAX
  "shift", the same function in XLA), ``_blur_m`` and ``_solve_flow``
  against JAX on the same float32 inputs: within 1e-5 relative to the
  channel's scale (float32 sums in another order).
- the portable ``farneback`` end to end at 96x128 against JAX on its
  TPU prep (``_pallas_ok`` True: the blocked bf16 prep): median within
  1e-3 px, 99% of pixels within 0.05 px. Measured: median <= 1.8e-6 px,
  worst pixel 2.6e-4 px.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.config import FarnebackParams as JaxParams
from ripcurrents_tpu.flow.warp_pallas import warp5_shift_pallas
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb
from ripcurrents_tpu_torch.flow import warp_kernel

jfb = importlib.import_module("ripcurrents_tpu.flow.farneback")

torch.set_num_threads(1)

REL = 1e-5


def _inputs(h, w, flow_px, seed=0):
    rng = np.random.default_rng(seed)
    r0 = rng.uniform(-1, 1, (h, w, 5)).astype(np.float32)
    r1 = rng.uniform(-1, 1, (h, w, 5)).astype(np.float32)
    flow = rng.uniform(-flow_px, flow_px, (h, w, 2)).astype(np.float32)
    flow[::7, ::5] = np.round(flow[::7, ::5])         # integer displacements
    return r0, r1, flow


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).reshape(-1, want.shape[-1]).max(0) + 1e-30
    assert (np.abs(got - want) <= rel * scale).all(), \
        (np.abs(got - want) / scale).max()


@pytest.mark.parametrize("budget,flow_px", [(4, 7.0), (8, 11.0)])
def test_plain_k7_matches_pallas_kernel(budget, flow_px):
    _, r1, flow = _inputs(40, 200, flow_px, seed=budget)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(warp5_shift_pallas(
            jnp.asarray(r1), jnp.asarray(flow), budget, th=32, tw=128))
    got = warp_kernel.warp5_shift(torch.from_numpy(r1),
                                  torch.from_numpy(flow), budget).numpy()
    assert got.shape == want.shape == (40, 200, 5)
    assert np.abs(got - want).max() <= 1e-6, np.abs(got - want).max()
    beyond = (np.abs(flow) > budget).any(-1)
    assert beyond.mean() > 0.1                 # the mask's other side is hit


def test_plain_k7_matches_gather_where_the_mask_keeps():
    _, r1, flow = _inputs(64, 256, 20.0, seed=3)
    r1t, ft = torch.from_numpy(r1), torch.from_numpy(flow)
    got = warp_kernel.warp5_shift(r1t, ft, 16)
    _, inside = tfb._warp5_shift_mask(64, 256, ft, 16)
    want, inside_g = tfb._warp5_gather(r1t, ft)
    m = inside.numpy()
    assert 0.3 < m.mean() < 0.9
    assert not (m & ~inside_g.numpy()).any()
    np.testing.assert_allclose(got.numpy()[m], want.numpy()[m], atol=5e-5)
    jwant, jinside = jfb._warp5_gather(jnp.asarray(r1), jnp.asarray(flow))
    np.testing.assert_array_equal(inside_g.numpy(), np.asarray(jinside))
    _close(want.numpy(), jwant)


@pytest.mark.parametrize("impl", ["gather", "shift", "pallas"])
def test_update_matrices_matches_jax(impl):
    r0, r1, flow = _inputs(48, 80, 9.0, seed=7)
    want = jfb.update_matrices(jnp.asarray(r0), jnp.asarray(r1),
                               jnp.asarray(flow), 8,
                               "shift" if impl == "pallas" else impl)
    got = tfb.update_matrices(torch.from_numpy(r0), torch.from_numpy(r1),
                              torch.from_numpy(flow), 8, impl)
    _close(got.numpy(), want)
    if impl == "gather":            # warp_budget None is the gather too
        same = tfb.update_matrices(torch.from_numpy(r0),
                                   torch.from_numpy(r1),
                                   torch.from_numpy(flow), None, "shift")
        assert torch.equal(same, got)


def test_blur_and_solve_match_jax():
    rng = np.random.default_rng(11)
    m = rng.uniform(-2, 2, (37, 53, 5)).astype(np.float32)
    m[..., 0] += 4.0
    m[..., 2] += 4.0
    for winsize, gaussian in ((20, True), (10, True), (3, False)):
        _close(tfb._blur_m(torch.from_numpy(m), winsize, gaussian).numpy(),
               jfb._blur_m(jnp.asarray(m), winsize, gaussian))
    _close(tfb._solve_flow(torch.from_numpy(m)).numpy(),
           jfb._solve_flow(jnp.asarray(m)))


H, W = 96, 128


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    yy = np.mgrid[0:H, 0:W][0].astype(np.float32)
    base = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    out = []
    for t in range(2):
        wave = 60 * np.sin(2 * np.pi * (yy / 24.0 - t * 0.11)) * (yy / H)
        out.append(np.clip(np.roll(base, t, axis=1) * 0.7 + wave + 60,
                           0, 255).astype(np.uint8))
    return out


@functools.lru_cache(maxsize=None)
def _jax_flow(preset, impl):
    f0, f1 = _frames()
    jp = dataclasses.replace(getattr(JaxParams, preset)(), warp_impl=impl)
    mp = pytest.MonkeyPatch()
    mp.setattr(jfb, "_pallas_ok", functools.lru_cache(maxsize=1)(lambda: True))
    try:
        return np.asarray(jfb.farneback(jnp.asarray(f0), jnp.asarray(f1), jp))
    finally:
        mp.undo()


def _port_flow(preset, impl):
    f0, f1 = _frames()
    tp = dataclasses.replace(getattr(FarnebackParams, preset)(),
                             warp_impl=impl)
    return tfb.farneback(torch.from_numpy(f0), torch.from_numpy(f1),
                         tp).numpy()


@pytest.mark.parametrize("preset,impl", [("subtract_average", "shift"),
                                         ("windowed", "gather"),
                                         ("subtract_average", "pallas")])
def test_portable_farneback_matches_jax(preset, impl):
    got = _port_flow(preset, impl)
    want = _jax_flow(preset, "shift" if impl == "pallas" else impl)
    assert got.shape == want.shape == (H, W, 2) and np.isfinite(got).all()
    d = np.sqrt(((got - want) ** 2).sum(-1))
    assert np.median(d) <= 1e-3 and (d <= 0.05).mean() >= 0.99, \
        (np.median(d), (d <= 0.05).mean())
    assert np.abs(want).mean() > 0.5                 # real motion


def test_pallas_equals_shift_in_the_port_on_the_cpu():
    """On CPU tensors the "pallas" warp is K7's plain version, the same
    function as "shift": equal update matrices and equal flow. The
    portable precompute gives (lh, lw, 5) float32 tables."""
    r0, r1, flow = (torch.from_numpy(a) for a in _inputs(40, 64, 20.0))
    assert torch.equal(tfb.update_matrices(r0, r1, flow, 16, "pallas"),
                       tfb.update_matrices(r0, r1, flow, 16, "shift"))
    assert warp_kernel.warp5_shift.launches == 0
    np.testing.assert_array_equal(_port_flow("windowed", "pallas"),
                                  _port_flow("windowed", "shift"))
    p = dataclasses.replace(FarnebackParams.subtract_average(),
                            warp_impl="pallas")
    tables = tfb.farneback_precompute(torch.from_numpy(_frames()[0]), p)
    assert [tuple(t.shape) for t in tables] == [(24, 32, 5), (48, 64, 5),
                                               (96, 128, 5)]
    assert all(t.dtype == torch.float32 for t in tables)


def test_warp_wrapper_checks_its_inputs():
    _, r1, flow = (torch.from_numpy(a) for a in _inputs(16, 24, 3.0))
    for bad in (r1.to(torch.float64), r1[:, :-1], r1.transpose(0, 1)):
        with pytest.raises(ValueError):
            warp_kernel.warp5_shift(bad, flow, 4)
    with pytest.raises(ValueError):
        warp_kernel.warp5_shift(r1, flow, -1)
    with pytest.raises(ValueError):
        warp_kernel.warp5_shift(r1.to("meta"), flow.to("meta"), 4)
