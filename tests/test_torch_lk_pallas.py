"""The plain tracker against the Pallas kernel in interpret mode on
interior points.

Inputs and tolerances: ``tests/_torch_lk.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ripcurrents_tpu.config import LKParams as JaxLKParams
from ripcurrents_tpu.flow.lk_pallas import pyr_lk_pallas

from _torch_lk import _points, _port, pair


@pytest.mark.parametrize("preset", ["particles", "dense_grid"])
def test_plain_pyr_lk_matches_pallas_interior(pair, preset):
    p = getattr(JaxLKParams, preset)()
    m = max(p.win) // 2 + 6
    pts = _points(24, seed=11, margin=float(m))[:24]
    want = pyr_lk_pallas(jnp.asarray(pair[0]), jnp.asarray(pair[1]),
                         jnp.asarray(pts), p, interpret=True)
    got = _port(*pair, pts, p)
    st = np.asarray(want.status)
    d = np.sqrt(((got.points.numpy() - np.asarray(want.points)) ** 2)
                .sum(-1))[st]
    assert np.median(d) < 0.05 and np.percentile(d, 90) < 0.5
    # interior points: the TPU kernel's status rule is the port's
    assert (got.status.numpy() == st).mean() > 0.85
