"""The tracker's pyramid depth, a two-stream batch and its status
(the min-eigenvalue gate).

Inputs and tolerances: ``tests/_torch_lk.py``.
"""

import numpy as np
import pytest
import torch

from ripcurrents_tpu.config import LKParams as JaxLKParams
from ripcurrents_tpu_torch.config import LKParams
from ripcurrents_tpu_torch.flow import lucas_kanade as tlk

from _torch_lk import W, _gather, _points, _port, pair


@pytest.mark.parametrize("hw,p,want", [
    ((480, 640), LKParams.particles(), 3),
    ((30, 40), LKParams.particles(), 0),
])
def test_pyramid_levels_shrink_to_the_window(hw, p, want):
    assert tlk.pyramid_levels(hw, p) == want
    assert tlk.pyramid_levels((160, 200), LKParams.particles()) == 1
    assert tlk.pyramid_levels((96, 128), LKParams.red_points()) == 2


def test_two_stream_batch_equals_two_single_calls(pair):
    p = LKParams((15, 15), 2, 10, 0.03, 1e-4)
    f = torch.from_numpy(np.stack(pair))
    prev, nxt = f, torch.flip(f, dims=(0,))
    pts = torch.from_numpy(np.stack([_points(30, 1), _points(30, 2)]))
    both = tlk.pyr_lk(prev, nxt, pts, p)
    assert both.points.shape == (2, 36, 2) and both.status.shape == (2, 36)
    for s in range(2):
        one = tlk.pyr_lk(prev[s], nxt[s], pts[s], p)
        for a, b in zip(both, one):
            assert torch.equal(a[s], b)


def test_status_includes_the_min_eigenvalue_gate(pair):
    """A textureless half: the gather path reports its points tracked,
    the port (like cv2 and the TPU kernel) does not."""
    f0, f1 = (f.copy() for f in pair)
    f0[:, :W // 2] = 90
    f1[:, :W // 2] = 90
    p = JaxLKParams.dense_grid()
    pts = _points(40, seed=9, margin=14.0)[:40]
    want = _gather(f0, f1, pts, p)
    got = _port(f0, f1, pts, p)
    gated = want.err < p.min_eig_threshold
    assert gated.sum() >= 5 and want.status[gated].all()
    assert not got.status.numpy()[gated].any()
    np.testing.assert_array_equal(got.status.numpy(), want.status & ~gated)
