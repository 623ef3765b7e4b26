"""The port's android mode and its stages against the JAX package:
the 1-D histogram stages, the stages, three steps with the flow
shared and a step across the overlay warmup.

Inputs and tolerances: ``tests/_torch_android.py``.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu.analysis import classify as jcls
from ripcurrents_tpu.config import HistogramParams as JaxHist
from ripcurrents_tpu.ops import hist as jhist
from ripcurrents_tpu.pipelines import android as jandroid
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.analysis import classify as cls
from ripcurrents_tpu_torch.config import (ANDROID_OVERLAY_WARMUP,
                                          HistogramParams)
from ripcurrents_tpu_torch.ops import hist

from _torch_android import (FRAMES, H, J, T, W, _assert_states_equal, _flows,
                            _jax_init, _live_accumulator, _shared_flow_run)


def test_bin_1d_and_upper_from_1d_exact():
    """One frame's histogram and a cumulative one (the 3% walk over the
    sum of three frames' histograms) equal JAX; so does upper_1d."""
    rng = np.random.default_rng(1)
    hp, jhp = HistogramParams.android(), JaxHist.android()
    th, ts = torch.zeros(hp.bins, dtype=torch.int32), torch.tensor(0)
    jh, js = jnp.zeros(hp.bins, jnp.int32), jnp.array(0, jnp.int32)
    for scale in (0.4, 1.5, 6.0):
        mag = rng.exponential(scale, (H, W)).astype(np.float32)
        mag[0, :5] = 50.0                        # past the last bin
        dh, ds = hist.bin_1d(T(mag), hp)
        jdh, jds = jhist.bin_1d(J(mag), jhp)
        np.testing.assert_array_equal(dh.numpy(), np.asarray(jdh))
        assert int(ds) == int(jds) == int(dh.sum()) <= H * W - 5
        th, ts, jh, js = th + dh, ts + ds, jh + jdh, js + jds
        assert float(hist.upper_from_1d(th, ts, hp)) == \
            float(jhist.upper_from_1d(jh, js, jhp))
        assert float(hist.upper_1d(T(mag), hp)) == \
            float(jhist.upper_1d(J(mag), jhp))
    empty = torch.zeros(hp.bins, dtype=torch.int32)
    assert float(hist.upper_from_1d(empty, torch.tensor(0), hp)) == \
        float(jhist.upper_from_1d(jnp.zeros(hp.bins, jnp.int32),
                                  jnp.array(0, jnp.int32), jhp))


def test_android_stages_exact():
    """classify_android, android_duty_viz and android_local_rip (int32
    prefix sums; JAX sums float32, exact below 2^24) equal JAX, with a
    live rip mask."""
    rng = np.random.default_rng(2)
    mag = rng.exponential(0.5, (H, W)).astype(np.float32)
    ang = rng.uniform(0, 360, (H, W)).astype(np.float32)
    for upper in (0.8, 1.7):
        for got, want in zip(
                cls.classify_android(T(ang), T(mag), torch.tensor(upper),
                                     0.5, 0.2),
                jcls.classify_android(J(ang), J(mag), jnp.float32(upper),
                                      0.5, 0.2)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in (40, 91):
        acc = _live_accumulator(i)
        out = cls.android_duty_viz(T(acc), torch.tensor(i))
        jout = jcls.android_duty_viz(J(acc), jnp.int32(i))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        mask = cls.android_local_rip(out, 20)
        np.testing.assert_array_equal(
            mask.numpy(), np.asarray(jcls.android_local_rip(jout, 20)))
        if i == 91:
            assert 200 < int((mask > 0).sum()) < H * W // 2


def test_android_mode_matches_jax_over_three_steps(monkeypatch):
    """From the converted JAX initial state, 3 steps with shared flows:
    equal overlays and states; the held state is not written."""
    jstate = _jax_init()
    tstate = convert.android_state_from_numpy(
        jax.tree.map(np.asarray, jstate))
    held = tstate.stable.clone()
    jrun, trun = _shared_flow_run(monkeypatch, jstate, tstate, _flows(3),
                                  FRAMES[1:])
    for (js, jo), (ts, to) in zip(jrun, trun):
        np.testing.assert_array_equal(to, jo)
        _assert_states_equal(ts, js)
    assert torch.equal(tstate.stable, held)
    assert int(trun[-1][0].i) == 3 and float(trun[-1][0].accumulator.sum()) > 0


def test_android_step_across_the_warmup(monkeypatch):
    """From a JAX state at i = ANDROID_OVERLAY_WARMUP - 1 with a live
    accumulator: no red overlay at i = 90, the same red overlay as JAX at
    91 and 92."""
    j0 = _jax_init()
    i0 = ANDROID_OVERLAY_WARMUP - 1
    jstate = j0._replace(accumulator=J(_live_accumulator(i0)),
                         i=jnp.array(i0, jnp.int32))
    tstate = convert.android_state_from_numpy(
        jax.tree.map(np.asarray, jstate))
    jrun, trun = _shared_flow_run(monkeypatch, jstate, tstate,
                                  _flows(3, seed=1), FRAMES[1:])
    reds = []
    for (js, jo), (ts, to), raw in zip(jrun, trun, FRAMES[1:]):
        np.testing.assert_array_equal(to, jo)
        _assert_states_equal(ts, js)
        resized = np.asarray(jandroid.resize_area(J(raw), (H, W)))
        reds.append(int(((to[..., 2] == 255) &
                         (resized[..., 2] != 255)).sum()))
    assert [int(ts.i) for ts, _ in trun] == [90, 91, 92]
    assert reds[0] == 0 and reds[1] > 100, reds
