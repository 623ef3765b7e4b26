"""Inputs, bounds and helpers shared by ``test_torch_detector.py``,
``test_torch_detector_color.py``, ``test_torch_detector_draw.py``. The
tests are split into files of at most 4 collected tests, so that xdist's
``--dist loadfile`` starts each after ``tests/test_spatial.py``.

The port's detector chain against the JAX package, stage by stage, on
the same numpy inputs. Integer outputs must match exactly; float outputs
within 1e-5 (atan2 and sqrt may differ in the last bit between libraries:
angles near 360 deg carry an f32 ULP of 3e-5, so angles are compared with
a relative 1e-6 on top).
"""

import numpy as np
import torch

import jax.numpy as jnp

from ripcurrents_tpu.config import HistogramParams as JaxHist
from ripcurrents_tpu.ops import hist as jhist
from ripcurrents_tpu_torch.config import HistogramParams
from ripcurrents_tpu_torch.ops import hist as thist

torch.set_num_threads(1)

H, W = 48, 64
T = torch.from_numpy


def _flow(seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, scale, (H, W, 2)).astype(np.float32)
    f[:4, :4] = 0.0            # zero flow: atan2(0, 0) and empty bins
    return f


def _close(got, want, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _polar(seed=1):
    rng = np.random.default_rng(seed)
    mag = rng.exponential(0.6, (H, W)).astype(np.float32)
    ang = rng.uniform(0, 360, (H, W)).astype(np.float32)
    mag[0, :8] = 10.0          # past the last bin: not counted
    return mag, ang


def _hist_pair(seed):
    mag, ang = _polar(seed)
    j = jhist.bin_flow(jnp.asarray(mag), jnp.asarray(ang), JaxHist())
    t = thist.bin_flow(T(mag), T(ang), HistogramParams())
    return j, t
