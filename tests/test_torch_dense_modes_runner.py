"""The dense Farneback modes through ``run_frames`` against stepping
by hand, and the registry.

Inputs and tolerances: ``tests/_torch_dense_modes.py``.
"""

import dataclasses

import numpy as np
import torch

from ripcurrents_tpu.pipelines.common import GRAY_INPUT as JAX_GRAY_INPUT
from ripcurrents_tpu_torch.pipelines import runner
from ripcurrents_tpu_torch.pipelines.common import (GRAY_INPUT, MODES,
                                                    ModeConfig)

from _torch_dense_modes import FRAMES, KW, PRESET


def test_run_frames_equals_stepping_by_hand_and_registry():
    """run_frames over a dense mode (its own init: the port's tables, the
    port's engine) yields what stepping by hand yields; the registry holds
    the eighteen ported modes with the JAX package's gray-input flags."""
    cfg = dataclasses.replace(ModeConfig(**KW), total_frames=len(FRAMES))
    for mode in ("subtructAverageVectorWithWindow", "timelinesFarne"):
        init, step = MODES[mode](cfg, device="cpu")
        state = init(FRAMES[0])
        want = []
        for raw in FRAMES[1:]:
            state, out = step(state, raw)
            want.append(out)
        stats = runner.RunStats()
        got = list(runner.run_frames(mode, FRAMES, ModeConfig(**KW),
                                     device="cpu", stats=stats))
        assert len(got) == 3 and stats.frames == 3
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    dense = set(PRESET)
    assert set(MODES) == dense | {"legacy", "timelines", "streaklines",
                                  "populationMap", "flowRedPoints",
                                  "android", "averageHSV", "timex",
                                  "brightColor", "phaseCorrelate",
                                  "stabilizeTPU", "globalOrientation"}
    assert GRAY_INPUT == JAX_GRAY_INPUT & set(MODES) == \
        {"subtructAverageVector", "averageVector", "globalOrientation"}
    gray = [np.asarray(f)[..., 1] for f in FRAMES]    # 2-D gray frames
    out = list(runner.run_frames("averageVector", gray, ModeConfig(**KW),
                                 device="cpu"))
    assert len(out) == 3 and out[-1].shape == (96, 128, 3)
