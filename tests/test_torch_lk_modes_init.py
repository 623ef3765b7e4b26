"""The particle modes' init points, ``run_frames``' generators and
stats, its default device and the registry.

Inputs and tolerances: ``tests/_torch_lk_modes.py``.
"""

import numpy as np
import pytest
import torch

from ripcurrents_tpu.pipelines.common import MODES as JAX_MODES
from ripcurrents_tpu_torch.pipelines import runner
from ripcurrents_tpu_torch.pipelines.common import MODES, ModeConfig

from _torch_lk_modes import FRAMES, _cfg


def test_run_frames_init_draws_its_own_points():
    """The port's own init (torch generators) gives states of the shapes
    the reference prescribes, inside the frame."""
    cfg = ModeConfig()
    raw = np.zeros((48, 64, 3), np.uint8)
    tl = MODES["timelines"](cfg, device="cpu")[0](raw)
    assert tl.timeline.vertices.shape == (201, 2)
    sk = MODES["streaklines"](cfg, device="cpu")[0](raw)
    assert sk.verts.shape == (5, 256, 2) and sk.count.tolist() == [1] * 5
    assert (sk.gens >= 0).all() and (sk.gens[:, 0] < 640).all() and \
        (sk.gens[:, 1] < 480).all()
    pm = MODES["populationMap"](cfg, device="cpu")[0](raw)
    v = pm.pop.vertices
    assert v.shape == (50, 2) and (v[:, 0] >= 300).all() and \
        (v[:, 0] <= 350).all() and (v[:, 1] >= 200).all()   # rand()+1 bias
    rp = MODES["flowRedPoints"](cfg, device="cpu")[0](raw)
    assert rp.pts.shape == (192, 2) and rp.prev_gray.shape == (480, 640)


def test_run_frames_takes_generators_and_fills_stats_when_closed():
    stats = runner.RunStats()
    it = runner.run_frames("flowRedPoints", iter(FRAMES), _cfg(),
                           device="cpu", stats=stats)
    first, second = next(it), next(it)
    it.close()                                  # the consumer stops early
    assert stats.frames == 2 and stats.seconds > 0
    assert int(stats.state.framecount) == 2
    assert first.shape == second.shape == (96, 128, 3)
    assert list(runner.run_frames("timelines", [], _cfg(),
                                  device="cpu")) == []


def test_run_frames_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError):
        next(runner.run_frames("timelines", FRAMES, _cfg()))
    with pytest.raises(RuntimeError):
        MODES["streaklines"](_cfg())


def test_registry_holds_the_ported_modes():
    assert set(MODES) == {"legacy", "timelines", "streaklines",
                          "populationMap", "flowRedPoints", "streamlines",
                          "timelinesOnSubtractAverageVector",
                          "timelinesFarne", "subtructAverageVector",
                          "subtructAverageVectorWithWindow", "shearRate",
                          "averageVector", "android", "averageHSV", "timex",
                          "brightColor", "phaseCorrelate", "stabilizeTPU",
                          "globalOrientation"}
    assert set(MODES) == set(JAX_MODES)
    with pytest.raises(KeyError):
        next(runner.run_frames("stabilize", FRAMES, _cfg(),
                               device="cpu"))
