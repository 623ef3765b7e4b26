"""Inputs, bounds and helpers shared by ``test_torch_legacy.py``,
``test_torch_legacy_views.py``, ``test_torch_legacy_state.py``,
``test_torch_legacy_imports.py``. The tests are split into files of at
most 4 collected tests, so that xdist's ``--dist loadfile`` starts each
after ``tests/test_spatial.py``.

The port's legacy rip-detector step against the JAX legacy step.

Both start from the same state: the JAX init state, carried across with
``convert.legacy_state_from_numpy``, with framecount set past the 30-frame
warmup and a random accumulator so that the duty mask is live. Both then
step over the same 3 moving-texture frames, and all ten LegacyOutputs
fields and the new state are compared.

The JAX side runs exactly the TPU's path in interpret mode: the fused
Pallas kernels and the blocked expansion prep with bf16 matmul inputs,
which is what the port implements. The remaining differences are one-ULP
bf16 flips in the expansion tables (summation order), which the chaotic
winsize-3 legacy preset grows over 3 frames to ~0.016 px mean
displacement difference, and which move some continuous-valued uint8
views by a level.

Bounds are about 3x what was measured on this input (in brackets):
share of differing pixels for the uint8 views, IoU for the mask, mean
and p99 of the field displacement difference in px.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu.pipelines.legacy import make_legacy as jax_make_legacy
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.pipelines.common import ModeConfig
from ripcurrents_tpu_torch.pipelines.legacy import make_legacy

jfb = importlib.import_module("ripcurrents_tpu.flow.farneback")

torch.set_num_threads(1)

RH, RW = 288, 384          # raw frame; the pipeline works at 192x256

BOUNDS = {                              # [measured]
    "overlay_bgr": 0.001,               # [0.00016]
    "streamlines_bgr": 0.001,           # [0]
    "density_bgr": 0.015,               # [0.0051]
    "displacement_bgr": 0.04,           # [0.013]
    "distance_bgr": 0.04,               # [0.013]
    "ratio_bgr": 0.1,                   # [0.035]
    "flow_hsv_bgr": 0.4,                # [0.14]
    "duty_bgr": 0.002,                  # [0.00039]
    "hist_wheel_bgr": 0.1,              # [0.034]
}
MASK_IOU = 0.995                        # [0.99909]
DISP = (0.05, 0.4)                      # (mean, p99) [0.016, 0.13]


def _frames(n):
    rng = np.random.default_rng(0)
    yy = np.mgrid[0:RH, 0:RW][0].astype(np.float32)
    base = rng.uniform(0, 255, (RH, RW)).astype(np.float32)
    k = np.ones(7) / 7
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    out = []
    for t in range(n):
        wave = 50 * np.sin(2 * np.pi * (yy / 30.0 - t * 0.11)) * (yy / RH)
        g = np.clip(np.roll(base, 2 * t, axis=1) * 0.7 + wave + 50, 0, 255)
        out.append(np.stack([g * 0.9, g, np.clip(g * 1.1, 0, 255)],
                            -1).astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def runs():
    """(JAX outputs+state, port outputs+state) after 3 steps."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jfb, "_pallas_ok",
               functools.lru_cache(maxsize=1)(lambda: True))
    try:
        frames = _frames(4)
        kw = dict(xdim=256, ydim=192, total_frames=40, legacy_seeds=16)
        jinit, jstep = jax_make_legacy(JaxModeConfig(**kw))
        _, tstep = make_legacy(ModeConfig(**kw), device="cpu")
        with pltpu.force_tpu_interpret_mode():
            js = jax.tree.map(np.asarray, jinit(jnp.asarray(frames[0])))
            acc = np.random.default_rng(1).integers(0, 9, (192, 256))
            js = js._replace(accumulator=acc.astype(np.float32),
                             framecount=np.int32(35))
            ts = convert.legacy_state_from_numpy(js)
            js = jax.tree.map(jnp.asarray, js)
            step = jax.jit(jstep)
            for f in frames[1:]:
                js, jo = step(js, jnp.asarray(f))
                ts, to = tstep(ts, f)
            jo, js = jax.tree.map(np.asarray, (jo, js))
    finally:
        mp.undo()
    return (jo, js), (to, ts)


def uint8_views(runs, field):
    (jo, _), (to, _) = runs
    got, want = getattr(to, field).numpy(), getattr(jo, field)
    assert got.dtype == np.uint8 and got.shape == want.shape
    frac = (got != want).any(-1).mean()
    assert frac <= BOUNDS[field], frac
