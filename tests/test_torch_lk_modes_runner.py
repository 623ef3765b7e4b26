"""The particle modes through ``run_frames`` against stepping by hand.

Inputs and tolerances: ``tests/_torch_lk_modes.py``.
"""

import dataclasses

import pytest
import torch

from ripcurrents_tpu_torch.pipelines import runner
from ripcurrents_tpu_torch.pipelines.common import MODES

from _torch_lk_modes import FRAMES, _cfg


@pytest.mark.parametrize("mode", ["timelines", "streaklines",
                                  "populationMap", "flowRedPoints"])
def test_run_frames_equals_stepping_by_hand(mode):
    cfg = dataclasses.replace(_cfg(), total_frames=len(FRAMES))
    init, step = MODES[mode](cfg, device="cpu")
    state = init(FRAMES[0])
    want = []
    for raw in FRAMES[1:]:
        state, out = step(state, raw)
        want.append(out)
    stats = runner.RunStats()
    got = list(runner.run_frames(mode, FRAMES, _cfg(), device="cpu",
                                 stats=stats))
    assert len(got) == 3 and stats.frames == 3 and stats.seconds > 0
    assert stats.fps == pytest.approx(3 / stats.seconds)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
