"""The chunk pipeline (``pipelines/runner.py: _run_chunks``) under
``run_video`` and ``run_videos`` keeps no stream's first state once it
has been stepped: a caller that held it would keep a second ring of
averageHSV's (1.1 GB at 640x480) alive through the run.

The check is exact: a weak reference to the first state's tensor is dead
when the second step starts (chunks of one frame, on the CPU).
"""

import weakref

import pytest
import torch

from ripcurrents_tpu_torch.pipelines import multirunner, runner
from ripcurrents_tpu_torch.pipelines.common import MODES, ModeConfig

from test_torch_space import _write_clip

torch.set_num_threads(1)


@pytest.mark.parametrize("entry", ["run_video", "run_videos"])
def test_first_state_is_freed_after_its_step(entry, tmp_path, monkeypatch):
    """Whether the first state's running sum is alive at each step's
    start: at the first step (its argument), and at no later one."""
    clip = str(tmp_path / "a.mp4")
    _write_clip(clip, 4, shift=1)
    first, alive = [], []
    real = MODES["timex"]

    def tracked(cfg, device="cuda"):
        init, step = real(cfg, device)

        def init_tracked(raw):
            state = init(raw)
            first.append(weakref.ref(state.sum_rgb))
            return state

        def step_tracked(state, raw):
            alive.append(first[0]() is not None)
            return step(state, raw)
        return init_tracked, step_tracked

    monkeypatch.setitem(MODES, "timex", tracked)
    cfg = ModeConfig(xdim=160, ydim=120)
    if entry == "run_video":
        runner.run_video("timex", clip, None, cfg, chunk=1, progress=False,
                         device="cpu")
    else:
        multirunner.run_videos("timex", [clip], None, cfg, chunk=1,
                               progress=False, device="cpu")
    assert alive == [True, False, False]
