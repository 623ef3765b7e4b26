"""The port's android mode, its stages and ``detector_mask_scan`` against
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

import functools
import hashlib
import importlib
import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.analysis import classify as jcls
from ripcurrents_tpu.config import FarnebackParams as JaxParams
from ripcurrents_tpu.config import HistogramParams as JaxHist
from ripcurrents_tpu.ops import hist as jhist
from ripcurrents_tpu.pipelines import android as jandroid
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu.pipelines.common import \
    detector_mask_scan as jax_detector_mask_scan
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.analysis import classify as cls
from ripcurrents_tpu_torch.config import (ANDROID_OVERLAY_WARMUP,
                                          FarnebackParams, HistogramParams)
from ripcurrents_tpu_torch.ops import hist
from ripcurrents_tpu_torch.pipelines import android
from ripcurrents_tpu_torch.pipelines import runner
from ripcurrents_tpu_torch.pipelines.common import (MODES, ModeConfig,
                                                    detector_mask_scan)
from ripcurrents_tpu_torch.synthetic import make_rip_clip

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


def _jax_table(t: torch.Tensor):
    """A port bf16 expansion table as a JAX array of the same bits."""
    return J(t.view(torch.int16).numpy().view(jnp.bfloat16))


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


def test_detector_mask_scan_matches_jax():
    """8 frames, warmup 2, legacy preset: the JAX scan as the TPU runs it
    (fused Pallas kernels in interpret mode) and the port's host loop;
    measured 99.97% of pixels equal, mask share 0.47."""
    grays = _detector_grays()
    mp = pytest.MonkeyPatch()
    mp.setattr(jfb, "_pallas_ok",
               functools.lru_cache(maxsize=1)(lambda: True))
    try:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_detector_mask_scan(
                J(grays), JaxParams.legacy(), warmup=2))
    finally:
        mp.undo()
    got = detector_mask_scan(grays, FarnebackParams.legacy(), warmup=2,
                             device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (H, W)
    got = got.numpy()
    assert 0.05 < (got > 0).mean() < 0.95
    assert (got == want).mean() >= DETECTOR_SHARE, (got == want).mean()


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


def test_new_modules_import_without_jax():
    """The modules this slice adds import with jax and the JAX package
    blocked (None in sys.modules makes their import raise), and register
    their modes."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ripcurrents_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import ripcurrents_tpu_torch.pipelines.android\n"
        "import ripcurrents_tpu_torch.analysis.motion\n"
        "import ripcurrents_tpu_torch.flow.phasecorr\n"
        "import ripcurrents_tpu_torch.ops.warp\n"
        "import ripcurrents_tpu_torch.synthetic\n"
        "from ripcurrents_tpu_torch.pipelines import runner\n"
        "print(' '.join(sorted(runner.MODES)))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert set(NEW_MODES) <= set(r.stdout.split())


def test_new_factories_default_to_the_card():
    """make_android and the five new factories take device="cuda" by
    default, which raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    for mode in NEW_MODES:
        with pytest.raises(RuntimeError):
            MODES[mode](ModeConfig(xdim=W, ydim=H))
    with pytest.raises(RuntimeError):
        android.make_android(ModeConfig(xdim=W, ydim=H))
    with pytest.raises(RuntimeError):
        detector_mask_scan(_detector_grays(2), FarnebackParams.legacy())
