"""The other three dense Farneback modes over three frames against the
JAX modes, and the legends and drawing helpers, exact.

Inputs and tolerances: ``tests/_torch_dense_modes.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.viz import color as jcolor
from ripcurrents_tpu.viz import draw as jdraw
from ripcurrents_tpu_torch.viz import color as tcolor
from ripcurrents_tpu_torch.viz import draw as tdraw

from _torch_dense_modes import CARRY, mode_matches_jax_over_three_frames


@pytest.mark.parametrize("mode", sorted(CARRY)[4:])
def test_mode_matches_jax_over_three_frames(mode, monkeypatch):
    mode_matches_jax_over_three_frames(mode, monkeypatch)


def test_legends_and_drawing_exact():
    """color_wheel, shear_color_chart, polar_to_hsv_bgr, draw_frame_count,
    draw_arrows and paste on the same inputs: the same uint8 images."""
    rng = np.random.default_rng(4)
    ang = rng.uniform(0, 360, (16, 24)).astype(np.float32)
    val = rng.uniform(-0.2, 1.2, (16, 24)).astype(np.float32)
    sat = rng.uniform(0, 1, (16, 24)).astype(np.float32)
    for s in (None, sat):
        np.testing.assert_array_equal(
            tcolor.polar_to_hsv_bgr(
                torch.from_numpy(ang), torch.from_numpy(val),
                None if s is None else torch.from_numpy(s)).numpy(),
            np.asarray(jcolor.polar_to_hsv_bgr(
                jnp.asarray(ang), jnp.asarray(val),
                None if s is None else jnp.asarray(s))))
    np.testing.assert_array_equal(tcolor.color_wheel(60).numpy(),
                                  np.asarray(jcolor.color_wheel(60)))
    np.testing.assert_array_equal(tcolor.shear_color_chart(8, 32).numpy(),
                                  np.asarray(jcolor.shear_color_chart(8, 32)))
    img = rng.integers(0, 255, (96, 128, 3)).astype(np.uint8)
    for fc in (7, 38, 12345):
        np.testing.assert_array_equal(
            tdraw.draw_frame_count(torch.from_numpy(img),
                                   torch.tensor(fc, dtype=torch.int32)).numpy(),
            np.asarray(jdraw.draw_frame_count(jnp.asarray(img), fc)))
    starts = rng.uniform(-10, 140, (12, 2)).astype(np.float32)
    ends = starts + rng.uniform(-20, 20, (12, 2)).astype(np.float32)
    valid = rng.uniform(size=12) < 0.7
    for thickness, frac in ((1, 0.4), (2, 0.2)):
        np.testing.assert_array_equal(
            tdraw.draw_arrows(torch.from_numpy(img), torch.from_numpy(starts),
                              torch.from_numpy(ends), torch.from_numpy(valid),
                              (0, 255, 0), thickness, frac).numpy(),
            np.asarray(jdraw.draw_arrows(
                jnp.asarray(img), jnp.asarray(starts), jnp.asarray(ends),
                jnp.asarray(valid), (0, 255, 0), thickness, frac)))
    patch = rng.integers(0, 255, (12, 20, 3)).astype(np.uint8)
    for y, x in ((0, 108), (5, 7), (90, 120)):     # the last one is clamped
        np.testing.assert_array_equal(
            tdraw.paste(torch.from_numpy(img), torch.from_numpy(patch), y,
                        x).numpy(),
            np.asarray(jdraw.paste(jnp.asarray(img), jnp.asarray(patch), y,
                                   x)))
