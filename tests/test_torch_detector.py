"""The port's detector chain against the JAX package, stage by stage:
polar flow, histograms and thresholds, classification and the duty
view, rip edges and burn-in.

Inputs and tolerances: ``tests/_torch_detector.py``.
"""

import numpy as np
import torch

import jax.numpy as jnp

from ripcurrents_tpu.analysis import classify as jcls
from ripcurrents_tpu.config import HistogramParams as JaxHist
from ripcurrents_tpu.ops import hist as jhist
from ripcurrents_tpu.ops import morphology as jmorph
from ripcurrents_tpu.ops import polar as jpolar
from ripcurrents_tpu_torch.analysis import classify as tcls
from ripcurrents_tpu_torch.config import HistogramParams
from ripcurrents_tpu_torch.ops import hist as thist
from ripcurrents_tpu_torch.ops import morphology as tmorph
from ripcurrents_tpu_torch.ops import polar as tpolar

from _torch_detector import H, T, W, _close, _flow, _hist_pair, _polar


def test_flow_to_polar():
    f = _flow()
    jm, ja = jpolar.flow_to_polar(jnp.asarray(f))
    tm, ta = tpolar.flow_to_polar(T(f))
    _close(tm, jm)
    _close(ta, ja, rtol=1e-6)


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
