"""A mode with ``warp_impl="tiled"`` through ``fb_preset``.

Inputs and tolerances: ``tests/_torch_tiled.py``.
"""

import dataclasses

import torch

from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb

from _torch_tiled import H, W


def test_tiled_mode_runs_through_fb_preset(monkeypatch):
    """ModeConfig(warp_impl="tiled") reaches the engine unchanged: a dense
    mode at 96x128 warps through K8's path 9 times a frame (3 levels x 3
    iterations of subtract_average) and equals the stream stepped by
    hand."""
    from ripcurrents_tpu_torch.pipelines import runner
    from ripcurrents_tpu_torch.pipelines.common import (ModeConfig,
                                                        fb_preset,
                                                        prep_frame)
    from ripcurrents_tpu_torch.synthetic import moving_frames
    cfg = ModeConfig(xdim=W, ydim=H, warp_impl="tiled")
    fb = fb_preset(FarnebackParams.subtract_average(), cfg)
    assert fb == dataclasses.replace(FarnebackParams.subtract_average(),
                                     warp_impl="tiled")
    calls = []
    real = tfb.warp_tiles
    monkeypatch.setattr(tfb, "warp_tiles",
                        lambda *a, **k: calls.append(a[3:5]) or real(*a, **k))
    raw = moving_frames(3, 144, 192, "cpu")
    stats = runner.RunStats()
    outs = list(runner.run_frames("subtructAverageVector", raw, cfg,
                                  device="cpu", stats=stats))
    assert len(outs) == 2 and outs[-1].shape == (H, W, 3)
    assert len(calls) == 18 and (24, 128) in calls and (8, 128) in calls
    grays = [prep_frame(raw[t], cfg, first=t == 0)[1] for t in range(3)]
    exp = tfb.farneback_precompute(grays[0], fb)
    for t in (1, 2):
        flow, exp = tfb.farneback_stream(exp, grays[t], fb)
    assert all(torch.equal(a, b)
               for a, b in zip(stats.state.fstream.exp, exp))
