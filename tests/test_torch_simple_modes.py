"""The simple modes' functions against the JAX package: HSV
conversions, ``bright_color_reduce``, ``timex_update`` and
``average_hsv_update``, and brightColor replayed from a held state.

Inputs and tolerances: ``tests/_torch_simple_modes.py``.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ripcurrents_tpu.analysis import meanflow as jmeanflow
from ripcurrents_tpu.ops import color as jcolor
from ripcurrents_tpu.pipelines.common import MODES as JAX_MODES
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.analysis import meanflow
from ripcurrents_tpu_torch.ops import color
from ripcurrents_tpu_torch.pipelines.common import MODES, ModeConfig

from _torch_simple_modes import FRAMES, J, KW, T, _image


def test_hsv_conversions_exact():
    """bgr_to_hsv / rgb_to_hsv (uint8 and float) and hsv_to_bgr /
    hsv_to_rgb equal the JAX functions, at the sector edges included."""
    img = _image()
    for name in ("bgr_to_hsv", "rgb_to_hsv"):
        for x in (img, img.astype(np.float32) / 255.0):
            want = np.asarray(getattr(jcolor, name)(J(x)))
            got = getattr(color, name)(T(x)).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(1)
    hsv_f = np.stack([rng.uniform(0, 360, (96, 128)),
                      rng.uniform(0, 1, (96, 128)),
                      rng.uniform(0, 1, (96, 128))], -1).astype(np.float32)
    hsv_f[:4, :, 0] = np.arange(4)[:, None] * 60.0      # sector edges
    hsv_u8 = np.asarray(jcolor.bgr_to_hsv(J(img)))
    for name in ("hsv_to_bgr", "hsv_to_rgb"):
        for x in (hsv_u8, hsv_f):
            np.testing.assert_array_equal(
                getattr(color, name)(T(x)).numpy(),
                np.asarray(getattr(jcolor, name)(J(x))))


def test_bright_color_reduce_with_ties():
    """Options 0 (mean), 1 (pixel of max V), 2 (pixel of min V) equal JAX
    on a buffer whose V takes 4 values, so most pixels tie; on a tie both
    take the first frame."""
    rng = np.random.default_rng(2)
    buf = rng.integers(0, 256, (5, 96, 128, 3)).astype(np.uint8)
    buf[..., 2] = buf[..., 2] // 64 * 64
    for option in (0, 1, 2):
        got = meanflow.bright_color_reduce(T(buf), option).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jmeanflow.bright_color_reduce(J(buf), option)))
    v = buf[..., 2].astype(np.int32)
    first = np.argmax(v == v.max(0), axis=0)
    np.testing.assert_array_equal(
        meanflow.bright_color_reduce(T(buf), 1).numpy(),
        np.take_along_axis(buf, first[None, ..., None], 0)[0])
    assert (v == v.max(0)).sum(0).max() > 1             # ties present


def test_timex_and_average_hsv_updates():
    """timex_update and average_hsv_update over 4 frames into a 3-slot
    ring (it wraps) equal JAX."""
    jsum = jnp.zeros((96, 128, 3), jnp.float32)
    tsum = torch.zeros((96, 128, 3))
    jring = jmeanflow.ring_init(3, (96, 128, 3))
    tring = meanflow.ring_init(3, (96, 128, 3))
    for seed in range(4):
        img = _image(seed)
        jsum = jmeanflow.timex_update(jsum, J(img))
        tsum = meanflow.timex_update(tsum, T(img))
        jring = jmeanflow.average_hsv_update(jring, J(img))
        tring = meanflow.average_hsv_update(tring, T(img))
    np.testing.assert_array_equal(tsum.numpy(), np.asarray(jsum))
    for got, want in zip(tring, jring):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bright_color_replays_from_a_held_state():
    """brightColor stepped twice from the same held state gives the same
    frame and state both times, as JAX does; the held buffer is not
    written."""
    cfg = dict(KW, bright_option=1)
    jinit, jstep = JAX_MODES["brightColor"](JaxModeConfig(**cfg))
    jheld = jinit(J(FRAMES[0]))
    jheld, _ = jstep(jheld, J(FRAMES[1]))
    _, tstep = MODES["brightColor"](ModeConfig(**cfg), device="cpu")
    held = convert.bright_color_state_from_numpy(
        jax.tree.map(np.asarray, jheld))
    before = held.buffer.clone()
    first = tstep(held, FRAMES[2])
    again = tstep(held, FRAMES[2])
    assert torch.equal(held.buffer, before)
    jfirst = jstep(jheld, J(FRAMES[2]))
    for (s, out) in (first, again):
        np.testing.assert_array_equal(out.numpy(), np.asarray(jfirst[1]))
        np.testing.assert_array_equal(s.buffer.numpy(),
                                      np.asarray(jfirst[0].buffer))
        assert int(s.idx) == int(jfirst[0].idx) == 2
