"""The port's ``stabilizeTPU`` mode against the JAX package, on the CPU.

Each step of JAX's mode splits its key and draws the RANSAC noise from
the subkey; the tests recompute that noise with the same JAX calls and
hand it to the port's step through ``feature_stab.gumbel_noise`` (the
port's own draw comes from a generator seeded from (seed, framecount)).
Both start from JAX's first state, carried over by
``convert.stabilize_state_from_numpy``. At 120x160, 3 steps of a
jittered clip (``synthetic.make_jittered_clip``), tolerances as measured:

- each step from JAX's state before it: the corrected frame and the
  carried gray at most PIXEL_SHARE of pixels apart, by one uint8 level
  (measured: Harris equal; AKAZE 0.016-0.031%);
- 3 steps chained on each side: Harris equal; AKAZE drifts, since each
  frame registers to the previous corrected one and the two SVDs' last
  digits compound: the phase-correlation shift between the two outputs
  within CHAIN_PX (measured <= 0.018 px at step 3).

The port's own draws are a function of the state: replaying a step from
a held state gives the same frame, and ``run_frames`` equals stepping
by hand. A ``slow`` test holds the port's stabilizer to the reference
AKAZE / SIFT stabilizer on the jittered clip, as
``tests/test_stabilize_vs_akaze.py`` holds the JAX one.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu.pipelines import modes as jmodes  # noqa: F401
from ripcurrents_tpu.pipelines.common import MODES as JAX_MODES
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.flow import feature_stab as tfs
from ripcurrents_tpu_torch.flow.phasecorr import (hanning_window,
                                                  phase_correlate)
from ripcurrents_tpu_torch.pipelines import runner
from ripcurrents_tpu_torch.pipelines.common import MODES, ModeConfig
from ripcurrents_tpu_torch.synthetic import make_jittered_clip

torch.set_num_threads(1)

H, W = 120, 160
PIXEL_SHARE = 1e-3
CHAIN_PX = 0.05
FRAMES = make_jittered_clip(np.random.default_rng(5), H, W, 4, blobs=40)[0]


def _jax_noise(sub):
    keys = jax.random.split(sub, 64)
    return torch.from_numpy(np.asarray(
        jax.vmap(lambda k: jax.random.gumbel(k, (256,)))(keys)))


def _apart(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return d.reshape(H, W, -1).max(-1)


def _shift_px(a, b):
    """Phase-correlation shift (px) between two frames' interiors."""
    win = hanning_window(H - 40, W - 48)
    sl = np.s_[20:H - 20, 24:W - 24, 0]
    s = phase_correlate(torch.from_numpy(np.asarray(a)[sl]).float(),
                        torch.from_numpy(np.asarray(b)[sl]).float(),
                        win).shift
    return float(s.abs().max())


@pytest.mark.parametrize("features", ["harris", "akaze"])
def test_stabilize_steps_match_jax(features, monkeypatch):
    jinit, jstep = JAX_MODES["stabilizeTPU"](JaxModeConfig(
        xdim=W, ydim=H, stab_features=features))
    _, step = MODES["stabilizeTPU"](ModeConfig(
        xdim=W, ydim=H, stab_features=features), device="cpu")
    js = jinit(jnp.asarray(FRAMES[0]))
    ts = convert.stabilize_state_from_numpy(jax.tree.map(np.asarray, js))
    assert ts.prev_gray.dtype == torch.uint8 and int(ts.framecount) == 0
    noise = []
    monkeypatch.setattr(tfs, "gumbel_noise", lambda g, t, n, d: noise[0])
    key = js.key
    for i in range(1, 4):
        key, sub = jax.random.split(key)
        noise[:] = [_jax_noise(sub)]
        forced = convert.stabilize_state_from_numpy(
            jax.tree.map(np.asarray, js))
        fs, fo = step(forced, FRAMES[i])
        js, jo = jstep(js, jnp.asarray(FRAMES[i]))
        ts, to = step(ts, FRAMES[i])
        for got, want in ((fo, jo), (fs.prev_gray, js.prev_gray)):
            d = _apart(got, want)
            assert d.max() <= 1 and (d > 0).mean() <= PIXEL_SHARE, \
                (i, d.max(), (d > 0).mean())
        assert int(ts.framecount) == int(js.framecount) == i
        if features == "harris":
            assert np.array_equal(to.numpy(), np.asarray(jo))
        assert _shift_px(to, jo) <= CHAIN_PX
    assert to.shape == (H, W, 3) and to.dtype == torch.uint8


def test_state_replay_and_run_frames():
    for features in ("harris", "akaze"):
        cfg = ModeConfig(xdim=W, ydim=H, stab_features=features)
        init, step = MODES["stabilizeTPU"](cfg, device="cpu")
        s0 = init(FRAMES[0])
        s1, o1 = step(s0, FRAMES[1])
        held = convert.state_to_numpy(s1)
        s2, o2 = step(s1, FRAMES[2])
        s2b, o2b = step(s1, FRAMES[2])         # replay from the held state
        assert torch.equal(o2, o2b) and torch.equal(s2.prev_gray,
                                                    s2b.prev_gray)
        assert all(np.array_equal(v, convert.state_to_numpy(s1)[k])
                   for k, v in held.items())   # the step wrote no input
        stats = runner.RunStats()
        outs = list(runner.run_frames("stabilizeTPU", FRAMES[:3], cfg,
                                      device="cpu", stats=stats))
        assert len(outs) == 2 and stats.frames == 2
        assert torch.equal(outs[0], o1) and torch.equal(outs[1], o2)
        # a frame registered to itself stays put, bar the warp's edge
        s, o = step(init(FRAMES[1]), FRAMES[1])
        assert (o.numpy()[:-1, :-1] == FRAMES[1][:-1, :-1]).mean() > 0.999
    with pytest.raises(ValueError):
        MODES["stabilizeTPU"](ModeConfig(stab_features="sift"), device="cpu")
    # the same (seed, step) gives the same draw; another step another one
    a, b, c = (tfs.gumbel_noise(tfs.step_generator(0, s, "cpu"), 64, 256,
                                "cpu") for s in (4, 4, 5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all() and a.shape == (64, 256)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError):
        next(runner.run_frames("stabilizeTPU", FRAMES, ModeConfig()))


def _jax_oracle():
    path = pathlib.Path(__file__).with_name("test_stabilize_vs_akaze.py")
    spec = importlib.util.spec_from_file_location("stab_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_stabilize_matches_akaze_on_jittered_clip():
    """The port's stabilizer on the reference clip of
    ``tests/test_stabilize_vs_akaze.py`` (240x320, 8 frames, +-4 px
    jitter): both engines cancel most of the jitter and stay within half
    a pixel of the cv2 AKAZE (SIFT) stabilizer's residual."""
    oracle = _jax_oracle()
    frames, _ = oracle.make_jittered_clip(np.random.default_rng(1234))
    raw = oracle.residual_jitter(frames)
    assert raw > 2.0
    ak = oracle.residual_jitter(oracle.akaze_stabilize(frames))
    for features in ("harris", "akaze"):
        cfg = ModeConfig(xdim=oracle.W, ydim=oracle.H, stab_features=features)
        out = [frames[0]] + [o.numpy() for o in runner.run_frames(
            "stabilizeTPU", frames, cfg, device="cpu")]
        tp = oracle.residual_jitter(np.stack(out))
        assert tp < 0.35 * raw, (features, tp, raw)
        assert tp < ak + 0.5, (features, tp, ak)
