"""Inputs, bounds and helpers shared by ``test_torch_lk_modes.py``,
``test_torch_lk_modes_runner.py``, ``test_torch_lk_modes_init.py``. The
tests are split into files of at most 4 collected tests, so that xdist's
``--dist loadfile`` starts each after ``tests/test_spatial.py``.

The port's particle modes (timelines, streaklines, populationMap,
flowRedPoints) against the JAX modes, and the frame runner.

Both sides start from the JAX ``init`` state (its random points come from
``jax.random``, which torch cannot reproduce), carried across with
``convert``, and step over the same 3 frames at 96x128 with a small
tracker (window 15, 2 levels). Bounds: tracked vertices within 0.01 px
(the trackers follow the same arithmetic and differ by float32 summation
order, and by the frame resize's matmul rounding, which can move a uint8
pixel by one level); the output frame equal on >= 99.9% of pixels.
Measured here: vertices at most 3.3e-4 px apart, every output pixel equal.
"""

import numpy as np
import torch


from ripcurrents_tpu.config import LKParams as JaxLKParams
from ripcurrents_tpu.pipelines import android as jandroid  # noqa: F401
from ripcurrents_tpu.pipelines import legacy as jlegacy  # noqa: F401
from ripcurrents_tpu.pipelines import modes as jmodes  # noqa: F401
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.pipelines.common import ModeConfig

torch.set_num_threads(1)

RH, RW = 144, 192          # raw frames; the modes work at 96x128
SMALL = JaxLKParams((15, 15), 2, 10, 0.03, 1e-4)
KW = dict(xdim=128, ydim=96, seed=3, timeline_start=(6.0, 30.0),
          timeline_end=(120.0, 80.0), timeline_vertices=24,
          max_streaklines=3, streakline_capacity=8,
          population_rect=(30, 20, 60, 45), population_vertices=12)
CARRY = {"timelines": convert.timelines_state_from_numpy,
         "streaklines": convert.streaklines_state_from_numpy,
         "populationMap": convert.population_state_from_numpy,
         "flowRedPoints": convert.red_points_state_from_numpy}
VERTS = {"timelines": "vertices", "streaklines": "verts",
         "populationMap": "vertices", "flowRedPoints": "pts"}


def _frames(n):
    rng = np.random.default_rng(0)
    yy = np.mgrid[0:RH, 0:RW][0].astype(np.float32)
    base = rng.uniform(0, 255, (RH, RW)).astype(np.float32)
    k = np.ones(7) / 7
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    out = []
    for t in range(n):
        wave = 50 * np.sin(2 * np.pi * (yy / 30.0 - t * 0.11)) * (yy / RH)
        g = np.clip(np.roll(base, 2 * t, axis=1) * 0.7 + wave + 50, 0, 255)
        out.append(np.stack([g * 0.9, g, np.clip(g * 1.1, 0, 255)],
                            -1).astype(np.uint8))
    return out


FRAMES = _frames(4)


def _cfg():
    return ModeConfig(lk=convert.lk_params(SMALL), **KW)
