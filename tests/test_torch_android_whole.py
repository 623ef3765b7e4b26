"""The android step past the histogram's overflow guard, the whole
step against JAX's engine, the rip clip's copies and the jni
golden (``slow``).

Inputs and tolerances: ``tests/_torch_android.py``.
"""

import functools
import hashlib
import importlib
import importlib.util
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.pipelines import android as jandroid
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.config import (ANDROID_OVERLAY_WARMUP,
                                          HistogramParams)
from ripcurrents_tpu_torch.ops import hist
from ripcurrents_tpu_torch.pipelines import android
from ripcurrents_tpu_torch.pipelines import runner
from ripcurrents_tpu_torch.pipelines.common import ModeConfig
from ripcurrents_tpu_torch.synthetic import make_rip_clip

from _torch_android import (ANDROID_IOU, ANDROID_SHARE, FRAMES, H, J, REPO, T,
                            W, _assert_states_equal, _flows, _jax_init,
                            _jax_table, _live_accumulator, _shared_flow_run,
                            jfb)


def test_cumulative_histogram_overflow_guard(monkeypatch):
    """Past 2^30 the cumulative counters halve (as JAX's
    test_cumulative_histogram_overflow_guard): the port's step equals
    JAX's there, the counters shrink, and the threshold holds within one
    bin."""
    j0 = _jax_init()
    counts = jnp.arange(100, dtype=jnp.int32) * (1 << 18)
    big = j0._replace(hist=counts, histsum=jnp.sum(counts))
    assert int(big.histsum) > (1 << 30)
    tbig = convert.android_state_from_numpy(jax.tree.map(np.asarray, big))
    jrun, trun = _shared_flow_run(monkeypatch, big, tbig, _flows(1),
                                  FRAMES[1:2])
    (js, jo), (ts, to) = jrun[0], trun[0]
    np.testing.assert_array_equal(to, jo)
    _assert_states_equal(ts, js)
    assert 0 < int(ts.histsum) < int(tbig.histsum)
    hp = HistogramParams.android()
    u0 = float(hist.upper_from_1d(tbig.hist, tbig.histsum, hp))
    u1 = float(hist.upper_from_1d(tbig.hist // 2, tbig.histsum // 2, hp))
    assert abs(u0 - u1) <= 1.0 / hp.resolution + 1e-6


def test_android_whole_step_against_jax():
    """3 frames, each side with its own flow (the JAX engine in interpret
    mode, as the TPU runs it), from the port's initial tables (converted to
    JAX, the same bits) at i = ANDROID_OVERLAY_WARMUP - 1 with a live
    accumulator: the red overlay's IoU and the overlays' equal-pixel share
    (measured: IoU 1.0 over 814 red pixels, overlays equal, accumulators
    99.96% equal)."""
    tinit, tstep = android.make_android(ModeConfig(xdim=W, ydim=H),
                                        device="cpu")
    i0 = ANDROID_OVERLAY_WARMUP - 1
    tstate = tinit(FRAMES[0])._replace(
        accumulator=T(_live_accumulator(i0)),
        i=torch.tensor(i0, dtype=torch.int32))
    jstate = _jax_init()._replace(
        fstream=jandroid.FlowStream(tuple(
            _jax_table(t) for t in tstate.fstream.exp)),
        accumulator=J(_live_accumulator(i0)), i=jnp.array(i0, jnp.int32))
    mp = pytest.MonkeyPatch()
    mp.setattr(jfb, "_pallas_ok",
               functools.lru_cache(maxsize=1)(lambda: True))
    try:
        with pltpu.force_tpu_interpret_mode():
            _, jstep = jandroid.make_android(JaxModeConfig(xdim=W, ydim=H))
            jstep = jax.jit(jstep)
            for raw in FRAMES[1:]:
                jstate, jout = jstep(jstate, J(raw))
    finally:
        mp.undo()
    for raw in FRAMES[1:]:
        tstate, tout = tstep(tstate, raw)
    jout, tout = np.asarray(jout), tout.numpy()
    a, b = tout[..., 2] == 255, jout[..., 2] == 255
    iou = (a & b).sum() / max((a | b).sum(), 1)
    share = (tout == jout).all(-1).mean()
    assert b.sum() > 100 and iou >= ANDROID_IOU and share >= ANDROID_SHARE, \
        (iou, share, int(b.sum()))
    acc_equal = (tstate.accumulator.numpy() ==
                 np.asarray(jstate.accumulator)).mean()
    assert acc_equal >= ANDROID_SHARE, acc_equal


def test_rip_clip_and_oracle_are_copies():
    """The port's numpy rip clip equals tools/golden_detector_1080p's on 2
    frames, and its oracle mask is the JAX package's asset, byte for
    byte."""
    spec = importlib.util.spec_from_file_location(
        "golden_detector_1080p", REPO / "tools" / "golden_detector_1080p.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    np.testing.assert_array_equal(make_rip_clip(2), tool.make_rip_clip(2))
    name = "detector_oracle_1080p_48f_v2.npz"
    digest = [hashlib.sha256((REPO / pkg / "assets" / name).read_bytes())
              .hexdigest() for pkg in ("ripcurrents_tpu",
                                       "ripcurrents_tpu_torch")]
    assert digest[0] == digest[1]


@pytest.mark.slow
def test_android_rip_mask_iou_vs_jni_reference():
    """The port's android mode against the cv2 transcription of the jni
    loop (tests/test_android_golden.py), IoU > 0.75 as JAX's test holds
    its own (measured 0.7919; JAX's engine on a TPU: 0.7937)."""
    sys.path.insert(0, str(REPO / "tests"))
    golden = importlib.import_module("test_android_golden")
    frames = golden.make_clip()
    want = golden.reference_masks(frames)
    cfg = ModeConfig(xdim=golden.W, ydim=golden.H, total_frames=golden.T)
    out = None
    for out in runner.run_frames("android", frames, cfg, device="cpu"):
        pass
    score = golden.iou(out.numpy()[..., 2] == 255, want)
    assert score > 0.75, f"android rip-mask IoU {score:.3f}"
