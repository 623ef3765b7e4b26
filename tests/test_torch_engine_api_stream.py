"""The stream's ``init_flow`` and channels-first form, and the
multi-stream step.

Inputs and tolerances: ``tests/_torch_engine_api.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb

from _torch_engine_api import H, W, _frames, _init_flow


@pytest.mark.parametrize("warp_impl", ["fused", "tiled"])
def test_stream_init_flow_and_channels_first(warp_impl):
    """farneback_stream with init_flow equals farneback with it, and
    channels_first is the same flow as (2, h, w)."""
    f0, f1 = (torch.from_numpy(f) for f in _frames())
    init = torch.from_numpy(_init_flow())
    p = dataclasses.replace(FarnebackParams.legacy(), warp_impl=warp_impl)
    exp0 = tfb.farneback_precompute(f0, p)
    flow, exp1 = tfb.farneback_stream(exp0, f1, p, init)
    cf, _ = tfb.farneback_stream(exp0, f1, p, init, channels_first=True)
    assert flow.shape == (H, W, 2) and cf.shape == (2, H, W)
    assert torch.equal(torch.movedim(cf, 0, -1), flow)
    assert torch.equal(tfb.farneback(f0, f1, p, init), flow)
    assert all(torch.equal(a, b) for a, b in
               zip(exp1, tfb.farneback_precompute(f1, p)))


@pytest.mark.parametrize("consume", [False, True])
def test_stream_multi_equals_steps(consume):
    """2 streams x 2 frames: each stream stepped by hand. With consume, the
    per-frame reductions come back stacked (N, F) and no flow does."""
    p = dataclasses.replace(FarnebackParams.subtract_average(),
                            warp_impl="tiled")
    frames = torch.from_numpy(np.stack([np.stack(_frames(3, seed=s))
                                        for s in range(2)]))
    firsts = [tfb.farneback_precompute(frames[s, 0], p) for s in range(2)]
    exps = tuple(torch.stack(ts) for ts in zip(*firsts))

    def reduce(fl):
        return fl.mean(dim=(0, 1)), fl.norm(dim=-1).max()

    def flip(f):
        return torch.flip(f, dims=[1])

    out, new = tfb.farneback_stream_multi(
        exps, frames[:, 1:], p, consume=reduce if consume else None,
        frame_map=flip)
    assert len(new) == 3 and all(t.shape[0] == 2 for t in new)
    for s in range(2):
        exp = firsts[s]
        for t in range(2):
            step, exp = tfb.farneback_stream(exp, flip(frames[s, t + 1]), p)
            if consume:
                mean, peak = reduce(step)
                assert out[0].shape == (2, 2, 2) and out[1].shape == (2, 2)
                assert torch.equal(out[0][s, t], mean)
                assert torch.equal(out[1][s, t], peak)
            else:
                assert out.shape == (2, 2, H, W, 2)
                assert torch.equal(out[s, t], step)
        assert all(torch.equal(a[s], b) for a, b in zip(new, exp))
