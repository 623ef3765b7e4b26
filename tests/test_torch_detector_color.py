"""The detector's colour maps, HSV to BGR and the histogram wheel
against the JAX package.

Inputs and tolerances: ``tests/_torch_detector.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ripcurrents_tpu.config import HistogramParams as JaxHist
from ripcurrents_tpu.ops import color as jcolor
from ripcurrents_tpu.ops import colormap as jcmap
from ripcurrents_tpu.viz import color as jvcolor
from ripcurrents_tpu_torch.config import HistogramParams
from ripcurrents_tpu_torch.ops import color as tcolor
from ripcurrents_tpu_torch.ops import colormap as tcmap
from ripcurrents_tpu_torch.viz import color as tvcolor

from _torch_detector import H, T, W, _close


@pytest.mark.parametrize("name", ["jet", "rainbow"])
def test_colormap_exact(name):
    field = np.random.default_rng(7).exponential(2.0, (H, W)).astype(
        np.float32)
    ju = jcmap.normalize_to_u8(jnp.asarray(field))
    tu = tcmap.normalize_to_u8(T(field))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(
        tcmap.apply_colormap(tu, name).numpy(),
        np.asarray(jcmap.apply_colormap(ju, name)))


def test_hsv_to_bgr():
    rng = np.random.default_rng(8)
    hsv = np.stack([rng.uniform(0, 360, (H, W)), rng.uniform(0, 1, (H, W)),
                    rng.uniform(0, 1.5, (H, W))], -1).astype(np.float32)
    hsv[0, :6, 0] = [0, 60, 120, 180, 300, 359.99]
    _close(tcolor.hsv_to_bgr(T(hsv)), jcolor.hsv_to_bgr(jnp.asarray(hsv)))


def test_histogram_wheel_exact():
    rng = np.random.default_rng(14)
    upper2d = rng.uniform(0.01, 2.5, 36).astype(np.float32)
    prop = rng.uniform(0, 0.12, 36).astype(np.float32)
    want = np.asarray(jvcolor.histogram_wheel(jnp.asarray(upper2d),
                                              jnp.asarray(prop), JaxHist(),
                                              size=96))
    got = tvcolor.histogram_wheel(T(upper2d), T(prop), HistogramParams(),
                                  size=96).numpy()
    assert got.shape == (96, 96, 3)
    np.testing.assert_array_equal(got, want)
