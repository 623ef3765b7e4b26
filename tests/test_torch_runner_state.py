"""The frame runner's frame count and the ring buffer's state, on the CPU.

``run_frames`` fills ``ModeConfig.total_frames`` from the source as the
JAX runner fills it from the video (``max(count, 1)``); the trail modes,
which shade by it, refuse a source without a length unless the count is
given. ``ring_update`` is a function of its input state, as JAX
``analysis/meanflow.py: ring_update`` is: stepping a held state again
gives the same result, so a run resumed from a held state equals an
unbroken one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.analysis import meanflow as jmeanflow
from ripcurrents_tpu_torch.analysis import meanflow
from ripcurrents_tpu_torch.pipelines import runner
from ripcurrents_tpu_torch.pipelines.common import MODES, ModeConfig

torch.set_num_threads(1)

RH, RW = 144, 192          # raw frames; the modes work at 96x128
KW = dict(xdim=128, ydim=96, seed=3, window_size=3, n_streamline_seeds=6)


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


FRAMES = _frames(5)


def test_trail_mode_takes_a_generator_given_its_frame_count():
    """streamlines over a generator with total_frames given yields what the
    same frames as a list yield; without it every mode that shades by the
    count raises."""
    want = list(runner.run_frames("streamlines", FRAMES, ModeConfig(**KW),
                                  device="cpu"))
    cfg = ModeConfig(**KW, total_frames=len(FRAMES))
    got = list(runner.run_frames("streamlines", iter(FRAMES), cfg,
                                 device="cpu"))
    assert len(got) == len(want) == len(FRAMES) - 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for mode in ("legacy", "streamlines", "timelinesOnSubtractAverageVector",
                 "timelinesFarne"):
        with pytest.raises(ValueError, match="total_frames"):
            next(runner.run_frames(mode, iter(FRAMES), ModeConfig(**KW),
                                   device="cpu"))


def test_ring_update_replays_from_a_held_state_as_jax():
    """A 4-slot ring stepped once, then stepped again from the same held
    state, gives mean [1, 2] both times, as JAX ring_update does on the
    same numpy inputs; the held state's buffer is not written."""
    value = np.array([4.0, 8.0], np.float32)
    held = meanflow.ring_init(4, (2,))
    first = meanflow.ring_update(held, torch.from_numpy(value))
    again = meanflow.ring_update(held, torch.from_numpy(value))
    jheld = jmeanflow.ring_init(4, (2,))
    jfirst = jmeanflow.ring_update(jheld, jnp.asarray(value))
    jagain = jmeanflow.ring_update(jheld, jnp.asarray(value))
    for got, want in ((first, jfirst), (again, jagain)):
        np.testing.assert_array_equal(got.mean.numpy(), [1.0, 2.0])
        np.testing.assert_array_equal(got.mean.numpy(),
                                      np.asarray(want.mean))
        np.testing.assert_array_equal(got.buffer.numpy(),
                                      np.asarray(want.buffer))
        assert int(got.index) == int(want.index) == 1
    assert not held.buffer.any() and int(held.index) == 0


def test_windowed_mode_resumed_from_a_held_state_equals_an_unbroken_run():
    """subtructAverageVectorWithWindow (ring of 3) stopped after 2 frames
    and resumed twice from the held state: both resumed runs give the
    unbroken run's frames and final ring."""
    cfg = ModeConfig(**KW, total_frames=len(FRAMES))
    init, step = MODES["subtructAverageVectorWithWindow"](cfg, device="cpu")
    state = init(FRAMES[0])
    unbroken = []
    for i, raw in enumerate(FRAMES[1:]):
        state, out = step(state, raw)
        unbroken.append(out)
        if i == 1:
            held = state
    final = state
    for _ in range(2):
        state, outs = held, []
        for raw in FRAMES[3:]:
            state, out = step(state, raw)
            outs.append(out)
        for g, w in zip(outs, unbroken[2:]):
            assert torch.equal(g, w)
        assert torch.equal(state.ring.buffer, final.ring.buffer)
        assert torch.equal(state.ring.mean, final.ring.mean)


def test_ring_update_matches_jax_over_a_wrapped_sequence():
    """Six steps of a 4-slot ring (the ring wraps) agree with JAX value for
    value, and every intermediate state keeps its own buffer."""
    rng = np.random.default_rng(5)
    values = rng.normal(size=(6, 3, 2)).astype(np.float32)
    st = meanflow.ring_init(4, (3, 2))
    jst = jmeanflow.ring_init(4, (3, 2))
    states = []
    for v in values:
        st = meanflow.ring_update(st, torch.from_numpy(v))
        jst = jmeanflow.ring_update(jst, jnp.asarray(v))
        states.append((st, np.asarray(jst.buffer)))
        np.testing.assert_allclose(st.mean.numpy(), np.asarray(jst.mean),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(st.buffer.numpy(),
                                      np.asarray(jst.buffer))
    for got, want in states:
        np.testing.assert_array_equal(got.buffer.numpy(), want)
