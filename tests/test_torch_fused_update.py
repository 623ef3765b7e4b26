"""The port's expansion tables (prepare_expansions) and the K1 / K2
wrappers' input checks against the JAX fused kernels.

Inputs and tolerances: ``tests/_torch_fused_update.py``.
"""

import numpy as np
import pytest
import torch

from ripcurrents_tpu_torch.flow import fused_update as tfu

from _torch_fused_update import H, W, _expansions, _preps

torch.set_num_threads(1)


@pytest.mark.parametrize("subcol", [128, 384])
def test_prepare_expansions_matches_jax(subcol):
    e0, e1 = _expansions(0)
    jp, tp = _preps(e0, e1, subcol)
    for k in ("p0", "p1"):
        np.testing.assert_array_equal(
            tp[k].to(torch.float32).numpy(),
            np.asarray(jp[k]).astype(np.float32))
    np.testing.assert_array_equal(tp["counts"].numpy(),
                                  np.asarray(jp["counts"]))
    assert (tp["hw"], tp["hpwp"], tp["th"], tp["sw"]) == \
        (tuple(jp["hw"]), tuple(jp["hpwp"]), jp["th"], jp["sw"])


def test_wrappers_reject_bad_inputs():
    e0, e1 = _expansions(6)
    _, tp = _preps(e0, e1, 128)
    hp, wp = tp["hpwp"]
    good = torch.zeros((2, hp, wp))
    with pytest.raises(ValueError):
        tfu.farneback_update(tp, good.double(), 2)             # dtype
    with pytest.raises(ValueError):
        tfu.farneback_update(tp, good[:, :, :-1], 2)           # shape
    with pytest.raises(ValueError):
        tfu.farneback_update(tp, torch.zeros((2, wp, hp)).transpose(1, 2),
                             2)                                # layout
    with pytest.raises(ValueError):
        tfu.farneback_update(tp, good, tfu.HALO_Y)             # bres
    m = torch.zeros((5, hp, wp), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfu.farneback_blur_solve(m.float(), (H, W), 3, False, True)
    with pytest.raises(ValueError):
        tfu.farneback_blur_solve(m, (H, W), 2 * tfu.MHALO_Y + 3, False,
                                 True)
    with pytest.raises(ValueError):                            # no kernel
        tfu.farneback_blur_solve(m.to("meta"), (H, W), 3, False, True)
    launches = (tfu.farneback_update.launches,
                tfu.farneback_blur_solve.launches)
    tfu.fused_level(tp, good, 3, False, 2, 2)
    # the plain versions on CPU tensors are not kernel launches
    assert (tfu.farneback_update.launches,
            tfu.farneback_blur_solve.launches) == launches
