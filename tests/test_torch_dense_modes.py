"""The port's dense Farneback modes against the JAX modes, on the CPU:
the flow stream of each of their three presets, and the exact
colourings.

Inputs and tolerances: ``tests/_torch_dense_modes.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.analysis import meanflow as jmeanflow
from ripcurrents_tpu.analysis.shear import shear_to_color as j_shear_to_color
from ripcurrents_tpu.dynamics import advect as jadvect
from ripcurrents_tpu.viz import color as jcolor
from ripcurrents_tpu_torch.analysis import meanflow
from ripcurrents_tpu_torch.analysis.shear import shear_to_color
from ripcurrents_tpu_torch.dynamics import advect
from ripcurrents_tpu_torch.viz import color as tcolor

from _torch_dense_modes import STREAM_BOUNDS, _flow, _streams


@pytest.mark.parametrize("preset", sorted(STREAM_BOUNDS))
def test_flow_stream_matches_jax(preset):
    """Measured at 96x128, worst of the 3 frames (median, mean, share
    above 0.05 px): streamlines (2.4e-7, 0.078, 0.059), subtract_average
    (4.7e-4, 8.0e-4, 0), windowed (3.7e-4, 1.6e-3, 4.9e-4). The winsize-3
    streamlines preset is chaotic where the texture is weak: a few pixels
    jump by tens of px there, as the legacy preset does."""
    want, got = _streams(preset)
    for w, g in zip(want, got):
        assert g.shape == w.shape == (96, 128, 2) and np.isfinite(g).all()
        d = np.sqrt(((g - w) ** 2).sum(-1))
        med, mean, share = np.median(d), d.mean(), (d > 0.05).mean()
        bounds = STREAM_BOUNDS[preset]
        assert med < bounds[0] and mean < bounds[1] and share < bounds[2], \
            (med, mean, share)


def test_colourings_exact():
    """vector_to_color, shear_to_color, average_vector and get_delta on
    the same inputs: the same uint8 images, the same carried floats and
    the same advected points."""
    flow = _flow()
    rng = np.random.default_rng(5)
    pts = rng.uniform(-5, 135, (64, 2)).astype(np.float32)
    for upper in (0.5, 45.0):
        np.testing.assert_array_equal(
            advect.get_delta(torch.from_numpy(pts), torch.from_numpy(flow),
                             2.0, upper).numpy(),
            np.asarray(jadvect.get_delta(jnp.asarray(pts), jnp.asarray(flow),
                                         2.0, upper)))
    for prev in (1e-6, 4.0):
        j = jcolor.vector_to_color(jnp.asarray(flow), jnp.float32(prev))
        t = tcolor.vector_to_color(torch.from_numpy(flow),
                                   torch.tensor(prev))
        np.testing.assert_array_equal(t.bgr_u8.numpy(), np.asarray(j.bgr_u8))
        assert float(t.max_displacement) == float(j.max_displacement)
        j = j_shear_to_color(jnp.asarray(flow), jnp.float32(prev))
        t = shear_to_color(torch.from_numpy(flow), torch.tensor(prev))
        np.testing.assert_array_equal(t.hsv_u8.numpy(), np.asarray(j.hsv_u8))
        assert float(t.max_frobenius) == float(j.max_frobenius)
    js = jmeanflow.average_vector_init(96, 128, capacity=3)
    ts = meanflow.average_vector_init(96, 128, capacity=3)
    for i in range(4):
        f = _flow(seed=i + 1, scale=1.5)
        jo = jmeanflow.average_vector(js, jnp.asarray(f), 45.0)
        to = meanflow.average_vector(ts, torch.from_numpy(f), 45.0)
        js, ts = jo.state, to.state
        np.testing.assert_array_equal(to.hsv_u8.numpy(),
                                      np.asarray(jo.hsv_u8))
        np.testing.assert_array_equal(to.counter_mask.numpy(),
                                      np.asarray(jo.counter_mask))
        np.testing.assert_allclose(to.grid_angle_deg.numpy(),
                                   np.asarray(jo.grid_angle_deg), atol=1e-3)
        assert abs(float(to.global_angle_rad) -
                   float(jo.global_angle_rad)) <= 1e-5
    np.testing.assert_allclose(ts.ring.mean.numpy(),
                               np.asarray(js.ring.mean), atol=1e-6)
