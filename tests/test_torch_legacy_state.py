"""The port's legacy step against the JAX legacy step: the last uint8
view, the rip mask's IoU and the new state.

Inputs and tolerances: ``tests/_torch_legacy.py``.
"""

import numpy as np
import pytest

from ripcurrents_tpu_torch import convert

from _torch_legacy import BOUNDS, DISP, MASK_IOU, runs, uint8_views


@pytest.mark.parametrize("field", list(BOUNDS)[8:])
def test_uint8_views(runs, field):
    uint8_views(runs, field)


def test_mask_iou(runs):
    (jo, _), (to, _) = runs
    a, b = to.mask.numpy() > 0, jo.mask > 0
    assert 0.05 < b.mean() < 0.95          # the duty mask is live
    iou = (a & b).sum() / (a | b).sum()
    assert iou >= MASK_IOU, iou


def test_state(runs):
    (_, js), (_, ts) = runs
    tn = convert.legacy_state_to_numpy(ts)
    d = np.sqrt(((tn["disp"] - js.field.disp) ** 2).sum(-1))
    assert d.mean() <= DISP[0] and np.percentile(d, 99) <= DISP[1], \
        (d.mean(), np.percentile(d, 99))
    assert tn["framecount"] == js.framecount == 38
    assert tn["upper"].shape == () and \
        abs(float(tn["upper"]) - float(js.upper)) <= 0.05
    for k, want in (("histsum", js.hist.histsum), ("hist", js.hist.hist)):
        assert tn[k].shape == np.shape(want)
    # the carried expansion tables: the new frame's prep [mean 9e-7]
    for i, e in enumerate(js.fstream.exp):
        e = np.asarray(e).astype(np.float32)
        assert tn[f"exp{i}"].shape == e.shape
        assert np.abs(tn[f"exp{i}"] - e).mean() < 1e-5
    assert tn["seeds"].shape == js.seeds.shape
    assert (tn["overlay"] != js.overlay).mean() <= BOUNDS["streamlines_bgr"]
