"""K4's plain version against the JAX package (1e-5), its zero pads and
folded scale, and its two-tap tables.

Inputs and tolerances: ``tests/_torch_resize_padded.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.ops import image as jimg
from ripcurrents_tpu_torch.ops import image as timg

from _torch_resize_padded import GEOMETRIES, _flow

torch.set_num_threads(1)


@pytest.mark.parametrize("geom", GEOMETRIES[2:])
def test_plain_matches_jax(geom):
    src_true, dst_true, src_pad, dst_pad, scale = geom
    x = _flow((2,) + src_pad, seed=1)
    want = np.asarray(jimg.resize_bilinear_cf_padded(
        jnp.asarray(x), src_true, dst_true, dst_pad, scale))
    got = timg.resize_bilinear_cf_padded(torch.from_numpy(x), src_true,
                                         dst_true, dst_pad, scale).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pads_are_zero_and_the_scale_folds():
    src_true, dst_true, src_pad, dst_pad, _ = GEOMETRIES[2]
    x = _flow((2,) + src_pad, seed=2)
    one = timg.resize_bilinear_cf_padded(torch.from_numpy(x), src_true,
                                         dst_true, dst_pad, 1.0)
    two = timg.resize_bilinear_cf_padded(torch.from_numpy(x), src_true,
                                         dst_true, dst_pad, 2.0)
    dh, dw = dst_true
    assert float(one[:, dh:, :].abs().max()) == 0.0
    assert float(one[:, :, dw:].abs().max()) == 0.0
    assert torch.equal(two, one * 2.0)          # a power-of-two fold is exact
    # source pads meet zero weights
    y = x.copy()
    y[:, src_true[0]:, :] = 7.0
    y[:, :, src_true[1]:] = -7.0
    again = timg.resize_bilinear_cf_padded(torch.from_numpy(y), src_true,
                                           dst_true, dst_pad, 1.0)
    assert torch.equal(again, one)
    # the true region is cv2's INTER_LINEAR resize of the true source
    ref = timg.resize_bilinear(torch.from_numpy(
        x[0, :src_true[0], :src_true[1]].copy()), dst_true)
    np.testing.assert_allclose(one[0, :dh, :dw].numpy(), ref.numpy(),
                               atol=1e-5)


def test_two_taps_rebuild_the_matrices():
    key = GEOMETRIES[3][:4] + (GEOMETRIES[3][4],)
    my_p, mx_p = timg._resize_matrices_padded(*key)
    for m in (my_p.T, mx_p.T):
        idx, w = timg._two_taps(m)
        back = np.zeros_like(m)
        for t in range(2):
            np.add.at(back, (np.arange(len(idx)), idx[:, t]), w[:, t])
        np.testing.assert_array_equal(back, m)
        assert (idx[:, 0] <= idx[:, 1]).all()
    with pytest.raises(ValueError):
        timg._two_taps(np.ones((2, 3), np.float32))
