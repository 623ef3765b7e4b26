"""Inputs, bounds and helpers shared by ``test_torch_particles.py``,
``test_torch_particles_draw.py``, ``test_torch_particles_tracked.py``.
The tests are split into files of at most 4 collected tests, so that
xdist's ``--dist loadfile`` starts each after ``tests/test_spatial.py``.

The port's particle systems and overlay drawing against the JAX package
on the same numpy inputs: state updates and rasterization exact (integer
pixels, float32 ops in the same order), LK-tracked steps within 1e-3 px
(float32 summation order inside the tracker).
"""

import numpy as np
import torch


from ripcurrents_tpu.config import LKParams as JaxLKParams

torch.set_num_threads(1)

T = torch.from_numpy
SMALL = JaxLKParams((15, 15), 2, 10, 0.03, 1e-4)


def _pair(h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h + 8, w + 8)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    return (base[4:h + 4, 4:w + 4].astype(np.uint8),
            base[3:h + 3, 2:w + 2].astype(np.uint8))


def _canvas(seed=0, h=60, w=80):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
