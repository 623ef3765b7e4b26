"""The plain tracker against JAX's ``pyr_lk(impl="gather")``, and
1300 points in one call.

Inputs and tolerances: ``tests/_torch_lk.py``.
"""

import pytest

from ripcurrents_tpu.config import LKParams as JaxLKParams

from _torch_lk import _check_against_gather, _gather, _points, _port, pair


@pytest.mark.parametrize("preset", ["particles", "dense_grid"])
def test_plain_pyr_lk_matches_gather(pair, preset):
    """Interior, border and out-of-image points."""
    p = getattr(JaxLKParams, preset)()
    pts = _points(40, seed=3)
    _check_against_gather(_port(*pair, pts, p), _gather(*pair, pts, p), p)


def test_plain_pyr_lk_1300_points_in_one_call(pair):
    """More points than the TPU kernel's 384-point chunks hold."""
    p = JaxLKParams((15, 15), 2, 10, 0.03, 1e-4)
    pts = _points(1294, seed=5, margin=4.0)
    assert len(pts) == 1300
    _check_against_gather(_port(*pair, pts, p), _gather(*pair, pts, p), p)
