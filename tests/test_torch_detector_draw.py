"""The detector's streamline field, polylines and trails against the
JAX package.

Inputs and tolerances: ``tests/_torch_detector.py``.
"""

import numpy as np
import torch

import jax.numpy as jnp

from ripcurrents_tpu.dynamics import advect as jadv
from ripcurrents_tpu.pipelines import modes as jmodes
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu.viz import draw as jdraw
from ripcurrents_tpu_torch.dynamics import advect as tadv
from ripcurrents_tpu_torch.pipelines import modes as tmodes
from ripcurrents_tpu_torch.pipelines.common import ModeConfig
from ripcurrents_tpu_torch.viz import draw as tdraw

from _torch_detector import H, T, W, _close, _flow


def test_streamline_field_and_streamlines():
    f = _flow(9, scale=1.5)
    rng = np.random.default_rng(10)
    disp = rng.normal(0, 2, (H, W, 2)).astype(np.float32)
    dist = rng.uniform(0, 5, (H, W)).astype(np.float32)
    js = jadv.streamline_field(jadv.FieldState(jnp.asarray(disp),
                                               jnp.asarray(dist)),
                               jnp.asarray(f), 2.0, 1, 3.0)
    ts = tadv.streamline_field(tadv.FieldState(T(disp), T(dist)), T(f),
                               2.0, 1, torch.tensor(3.0))
    _close(ts.disp, js.disp)
    _close(ts.dist, js.dist)
    seeds = np.floor(rng.uniform(0, 1, (16, 2)) *
                     np.float32([W, H])).astype(np.float32)
    seeds[0] = [0.0, 5.0]      # starts out of bounds
    jr = jadv.streamlines(jnp.asarray(seeds), jnp.asarray(f), 2.0, 4, 3.0)
    tr = tadv.streamlines(T(seeds), T(f), 2.0, 4, torch.tensor(3.0))
    _close(tr.points, jr.points)
    _close(tr.final, jr.final)
    np.testing.assert_array_equal(tr.seg_valid.numpy(),
                                  np.asarray(jr.seg_valid))


def test_draw_polyline_exact():
    rng = np.random.default_rng(11)
    pts = rng.uniform(-10, 75, (12, 2)).astype(np.float32)
    valid = rng.uniform(size=12) < 0.8
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    for thick in (1, 3):
        want = np.asarray(jdraw.draw_polyline(
            jnp.asarray(img), jnp.asarray(pts), (10, 200, 30), thick,
            valid=jnp.asarray(valid)))
        got = tdraw.draw_polyline(T(img), T(pts), (10, 200, 30), thick,
                                  valid=T(valid)).numpy()
        np.testing.assert_array_equal(got, want)


def test_trails_exact():
    """The legacy step's trail canvas and its rainbow composite."""
    f = _flow(12, scale=2.0)
    rng = np.random.default_rng(13)
    seeds = np.floor(rng.uniform(0, 1, (20, 2)) *
                     np.float32([W, H])).astype(np.float32)
    overlay = np.where(rng.uniform(size=(H, W)) < 0.1, 90, 0).astype(
        np.uint8)
    frame = rng.integers(0, 256, (H, W, 3), np.uint8)
    jcfg = JaxModeConfig(xdim=W, ydim=H, total_frames=40)
    tcfg = ModeConfig(xdim=W, ydim=H, total_frames=40)
    js, jo = jmodes._advect_and_draw_trails(
        jnp.asarray(seeds), jnp.asarray(overlay), jnp.asarray(f),
        jnp.int32(7), jcfg, dt=2.0, iters=1, upper=jnp.float32(4.0))
    ts, to = tmodes._advect_and_draw_trails(
        T(seeds), T(overlay), T(f), torch.tensor(7, dtype=torch.int32),
        tcfg, dt=2.0, iters=1, upper=torch.tensor(4.0))
    _close(ts, js)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(
        tmodes._composite_trails(T(frame), to).numpy(),
        np.asarray(jmodes._composite_trails(jnp.asarray(frame), jo)))
