"""Inputs, bounds and helpers shared by ``test_torch_android.py``,
``test_torch_android_whole.py``, ``test_torch_android_scan.py``. The
tests are split into files of at most 4 collected tests, so that xdist's
``--dist loadfile`` starts each after ``tests/test_spatial.py``.

The port's android mode, its stages and ``detector_mask_scan`` against
the JAX package, on the CPU, on the same numpy inputs made from a seed.

Tolerances, as measured:

- ``bin_1d``, ``upper_from_1d``, ``upper_1d``, ``classify_android``,
  ``android_duty_viz`` and ``android_local_rip``: equal;
- the android step over 3 frames with the flow shared (the same flows fed
  to both sides), across the 90-frame overlay warmup and past the
  histogram's overflow guard: overlay and carried state equal;
- the android step over 3 frames with each side's own flow (the JAX
  engine as the TPU runs it, its Pallas kernels in interpret mode): the
  flows differ by one-ULP bf16 flips of the prep, and the cumulative
  threshold walk amplifies a flip into a reclassified pixel, so the red
  overlay is held by its IoU (>= ANDROID_IOU) and the overlay frames by
  their equal-pixel share (>= ANDROID_SHARE);
- ``detector_mask_scan`` over 8 frames (warmup 2): the final masks agree
  on >= DETECTOR_SHARE of pixels (the share ``chip_smoke.py`` holds a
  dense mode to on the card).
"""

import importlib
import importlib.util
import pathlib

import numpy as np
import torch

import jax.numpy as jnp

from ripcurrents_tpu.config import HistogramParams as JaxHist
from ripcurrents_tpu.pipelines import android as jandroid
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.pipelines import android
from ripcurrents_tpu_torch.pipelines.common import ModeConfig

jfb = importlib.import_module("ripcurrents_tpu.flow.farneback")

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
T = torch.from_numpy
J = jnp.asarray
H, W = 96, 128
RH, RW = 144, 192
ANDROID_IOU = 0.9
ANDROID_SHARE = 0.99
DETECTOR_SHARE = 0.98
NEW_MODES = ("android", "averageHSV", "timex", "brightColor",
             "phaseCorrelate", "globalOrientation")


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


FRAMES = _frames(4)


def _flows(n, seed=0):
    """Smooth random flows of up to ~3 px, with a fast band."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        coarse = rng.normal(0, 1.0, (H // 8 + 1, W // 8 + 1, 2))
        f = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:H, :W]
        f[30:50, :, 0] += 3.0
        out.append(f.astype(np.float32))
    return out


def _live_accumulator(i):
    """An accumulator whose duty bands (at frame count i) mix low (< 5%)
    and mid (5-20%) pixels inside a channel x in [36, 100), so the local
    windows there win; elsewhere hi duty."""
    rng = np.random.default_rng(9)
    acc = np.full((H, W), 0.5 * i, np.float32)
    lo = rng.integers(0, int(0.04 * i), (H, W))
    mid = rng.integers(int(0.08 * i), int(0.17 * i), (H, W))
    mix = np.where(rng.uniform(size=(H, W)) < 0.5, lo, mid)
    acc[:, 36:100] = mix[:, 36:100]
    return acc


def _shared_flow_run(monkeypatch, jstate, tstate, flows, frames):
    """Step JAX's and the port's android over `frames` with `flows` fed
    to both. Returns ((JAX states, outputs), (port states, outputs))."""
    feeds = {"jax": iter(flows), "port": iter(flows)}
    monkeypatch.setattr(
        jandroid, "flow_stream_step",
        lambda fs, gray, fb: (J(next(feeds["jax"])), fs))
    monkeypatch.setattr(
        android, "flow_stream_step",
        lambda fs, gray, fb: (T(next(feeds["port"])), fs))
    _, jstep = jandroid.make_android(JaxModeConfig(xdim=W, ydim=H))
    _, tstep = android.make_android(ModeConfig(xdim=W, ydim=H),
                                    device="cpu")
    jrun, trun = [], []
    for raw in frames:
        jstate, jout = jstep(jstate, J(raw))
        tstate, tout = tstep(tstate, raw)
        jrun.append((jstate, np.asarray(jout)))
        trun.append((tstate, tout.numpy()))
    return jrun, trun


def _assert_states_equal(tstate, jstate):
    got = convert.state_to_numpy(tstate)
    for k in ("stable", "accumulator", "hist", "histsum", "i"):
        w = np.asarray(getattr(jstate, k))
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _jax_init():
    """JAX's initial android state without expansion tables (the shared
    flow replaces the stream)."""
    hp = JaxHist.android()
    return jandroid.AndroidState(
        jandroid.FlowStream(()),
        jnp.zeros((android.STABILIZE, H, W, 2), jnp.float32),
        jnp.zeros((H, W), jnp.float32), jnp.zeros(hp.bins, jnp.int32),
        jnp.array(0, jnp.int32), jnp.array(0, jnp.int32))


def _jax_table(t: torch.Tensor):
    """A port bf16 expansion table as a JAX array of the same bits."""
    return J(t.view(torch.int16).numpy().view(jnp.bfloat16))


def _detector_grays(n=8):
    """8 gray 96x128 frames: drifting texture, wave bands on the left 80
    columns only (a calm right side keeps the duty mask mixed)."""
    rng = np.random.default_rng(0)
    yy = np.mgrid[0:H, 0:W][0].astype(np.float32)
    base = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones(7) / 7
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    band = np.arange(W)[None, :] < 80
    return np.stack([np.clip(
        np.roll(base, 2 * t, axis=1) * 0.7 + 50 +
        50 * np.sin(2 * np.pi * (yy / 30.0 - t * 0.11)) * (yy / H) * band,
        0, 255).astype(np.uint8) for t in range(n)])
