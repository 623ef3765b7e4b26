"""The port's particle modes (timelines, streaklines, populationMap,
flowRedPoints) over three frames against the JAX modes.

Inputs and tolerances: ``tests/_torch_lk_modes.py``.
"""

import numpy as np
import pytest

import jax

from ripcurrents_tpu.pipelines.common import MODES as JAX_MODES
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.pipelines.common import MODES

from _torch_lk_modes import CARRY, FRAMES, KW, SMALL, VERTS, _cfg


@pytest.mark.parametrize("mode", sorted(CARRY))
def test_mode_matches_jax_over_three_frames(mode):
    jinit, jstep = JAX_MODES[mode](JaxModeConfig(lk=SMALL, **KW))
    jstep = jax.jit(jstep)
    jstate = jinit(FRAMES[0])
    _, tstep = MODES[mode](_cfg(), device="cpu")
    tstate = CARRY[mode](jax.tree.map(np.asarray, jstate))
    start = convert.state_to_numpy(tstate)[VERTS[mode]]
    for raw in FRAMES[1:]:
        jstate, jout = jstep(jstate, raw)
        tstate, tout = tstep(tstate, raw)
    want = jax.tree.map(np.asarray, jstate)
    got = convert.state_to_numpy(tstate)
    wv = want
    for name in (("timeline",) if mode == "timelines" else
                 ("pop",) if mode == "populationMap" else ()):
        wv = getattr(wv, name)
    wv = getattr(wv, VERTS[mode])
    gv = got[VERTS[mode]]
    assert gv.shape == wv.shape and np.isfinite(gv).all()
    assert np.abs(gv - wv).max() < 0.01, np.abs(gv - wv).max()
    assert np.abs(gv - start).max() > 0.5            # the points moved
    assert got["framecount"] == want.framecount == 3
    if mode == "streaklines":
        np.testing.assert_array_equal(got["count"], want.count)
    tout, jout = tout.numpy(), np.asarray(jout)
    assert tout.dtype == np.uint8 and tout.shape == jout.shape == (96, 128, 3)
    assert (tout != jout).any(-1).mean() <= 0.001
