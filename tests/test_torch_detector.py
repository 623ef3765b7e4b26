"""The port's detector chain against the JAX package, stage by stage, on
the same numpy inputs. Integer outputs must match exactly; float outputs
within 1e-5 (atan2 and sqrt may differ in the last bit between libraries:
angles near 360 deg carry an f32 ULP of 3e-5, so angles are compared with
a relative 1e-6 on top)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.analysis import classify as jcls
from ripcurrents_tpu.config import HistogramParams as JaxHist
from ripcurrents_tpu.dynamics import advect as jadv
from ripcurrents_tpu.ops import color as jcolor
from ripcurrents_tpu.ops import colormap as jcmap
from ripcurrents_tpu.ops import hist as jhist
from ripcurrents_tpu.ops import morphology as jmorph
from ripcurrents_tpu.ops import polar as jpolar
from ripcurrents_tpu.pipelines import modes as jmodes
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu.viz import color as jvcolor
from ripcurrents_tpu.viz import draw as jdraw
from ripcurrents_tpu_torch.analysis import classify as tcls
from ripcurrents_tpu_torch.config import HistogramParams
from ripcurrents_tpu_torch.dynamics import advect as tadv
from ripcurrents_tpu_torch.ops import color as tcolor
from ripcurrents_tpu_torch.ops import colormap as tcmap
from ripcurrents_tpu_torch.ops import hist as thist
from ripcurrents_tpu_torch.ops import morphology as tmorph
from ripcurrents_tpu_torch.ops import polar as tpolar
from ripcurrents_tpu_torch.pipelines import modes as tmodes
from ripcurrents_tpu_torch.pipelines.common import ModeConfig
from ripcurrents_tpu_torch.viz import color as tvcolor
from ripcurrents_tpu_torch.viz import draw as tdraw

torch.set_num_threads(1)

H, W = 48, 64
T = torch.from_numpy


def _flow(seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, scale, (H, W, 2)).astype(np.float32)
    f[:4, :4] = 0.0            # zero flow: atan2(0, 0) and empty bins
    return f


def _close(got, want, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_flow_to_polar():
    f = _flow()
    jm, ja = jpolar.flow_to_polar(jnp.asarray(f))
    tm, ta = tpolar.flow_to_polar(T(f))
    _close(tm, jm)
    _close(ta, ja, rtol=1e-6)


def _polar(seed=1):
    rng = np.random.default_rng(seed)
    mag = rng.exponential(0.6, (H, W)).astype(np.float32)
    ang = rng.uniform(0, 360, (H, W)).astype(np.float32)
    mag[0, :8] = 10.0          # past the last bin: not counted
    return mag, ang


def _hist_pair(seed):
    mag, ang = _polar(seed)
    j = jhist.bin_flow(jnp.asarray(mag), jnp.asarray(ang), JaxHist())
    t = thist.bin_flow(T(mag), T(ang), HistogramParams())
    return j, t


def test_histograms_and_thresholds_exact():
    j1, t1 = _hist_pair(1)
    j2, t2 = _hist_pair(2)
    for a, b in zip(t1, j1):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ja, ta = jhist.accumulate(j1, j2), thist.accumulate(t1, t2)
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for jh, th in ((ja, ta), (jhist.accumulate(j1, j1), thist.accumulate(
            t1, t1))):
        jt = jhist.thresholds(jh, JaxHist())
        tt = thist.thresholds(th, HistogramParams())
        for a, b in zip(tt, jt):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    empty = thist.empty_histogram(HistogramParams(), torch.device("cpu"))
    et = thist.thresholds(empty, HistogramParams())
    jt = jhist.thresholds(jhist.FlowHistogram(
        *(jnp.asarray(x.numpy()) for x in empty)), JaxHist())
    for a, b in zip(et, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_classify_and_duty_viz():
    mag, ang = _polar(3)
    upper2d = np.random.default_rng(4).uniform(0.05, 2, 36).astype(
        np.float32)
    jr = jcls.classify(jnp.asarray(ang), jnp.asarray(mag), 1.2, 0.5, 0.2,
                       jnp.asarray(upper2d))
    tr = tcls.classify(T(ang), T(mag), torch.tensor(1.2), 0.5, 0.2,
                       T(upper2d))
    for a, b in zip(tr, jr):
        _close(a, b, atol=0.0)
    acc = np.random.default_rng(5).integers(0, 12, (H, W)).astype(
        np.float32)
    for fc in (20, 31, 64):
        ja = jcls.accumulate_waves(jnp.asarray(acc), jr.fast_mask,
                                   jnp.int32(fc))
        ta = tcls.accumulate_waves(T(acc), tr.fast_mask,
                                   torch.tensor(fc, dtype=torch.int32))
        _close(ta, ja, atol=0.0)
        jv = jcls.duty_cycle_viz(ja, jnp.int32(fc))
        tv = tcls.duty_cycle_viz(ta, torch.tensor(fc, dtype=torch.int32))
        _close(tv.out, jv.out, atol=0.0)
        np.testing.assert_array_equal(tv.outmask.numpy(),
                                      np.asarray(jv.outmask))


def test_rip_edges_and_burn_exact():
    rng = np.random.default_rng(6)
    mask = np.where(rng.uniform(size=(H, W)) < 0.3, 255, 0).astype(np.uint8)
    mask[10:30, 20:50] = 255
    je = np.asarray(jmorph.rip_edges(jnp.asarray(mask)))
    te = tmorph.rip_edges(T(mask)).numpy()
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(tmorph.ellipse_kernel(5, 5),
                                  jmorph.ellipse_kernel(5, 5))
    frame = rng.integers(0, 256, (H, W, 3), np.uint8)
    np.testing.assert_array_equal(
        tcls.burn_mask_red(T(frame), T(te)).numpy(),
        np.asarray(jcls.burn_mask_red(jnp.asarray(frame), jnp.asarray(je))))


@pytest.mark.parametrize("name", ["jet", "rainbow"])
def test_colormap_exact(name):
    field = np.random.default_rng(7).exponential(2.0, (H, W)).astype(
        np.float32)
    ju = jcmap.normalize_to_u8(jnp.asarray(field))
    tu = tcmap.normalize_to_u8(T(field))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(
        tcmap.apply_colormap(tu, name).numpy(),
        np.asarray(jcmap.apply_colormap(ju, name)))


def test_hsv_to_bgr():
    rng = np.random.default_rng(8)
    hsv = np.stack([rng.uniform(0, 360, (H, W)), rng.uniform(0, 1, (H, W)),
                    rng.uniform(0, 1.5, (H, W))], -1).astype(np.float32)
    hsv[0, :6, 0] = [0, 60, 120, 180, 300, 359.99]
    _close(tcolor.hsv_to_bgr(T(hsv)), jcolor.hsv_to_bgr(jnp.asarray(hsv)))


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


def test_histogram_wheel_exact():
    rng = np.random.default_rng(14)
    upper2d = rng.uniform(0.01, 2.5, 36).astype(np.float32)
    prop = rng.uniform(0, 0.12, 36).astype(np.float32)
    want = np.asarray(jvcolor.histogram_wheel(jnp.asarray(upper2d),
                                              jnp.asarray(prop), JaxHist(),
                                              size=96))
    got = tvcolor.histogram_wheel(T(upper2d), T(prop), HistogramParams(),
                                  size=96).numpy()
    assert got.shape == (96, 96, 3)
    np.testing.assert_array_equal(got, want)
