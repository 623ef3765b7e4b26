"""K4's plain version (the padded channels-first flow upsample between
Farneback levels, which is what runs on CPU tensors) against the dense
two-matmul form it replaces and against the JAX package.

The plain version sums each output's two taps as fmaf(w1, v1, w0 * v0) in
ascending source index. That is the rounding of the dense float32 product
out[c] = MyT @ img[c] @ Mx where the product accumulates with FMAs along
the source axis in one pass, as the CPU's does at these sizes: max |d|
0.0 is required. Against the JAX function (other matmul rounding):
1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ripcurrents_tpu.ops import image as jimg
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb
from ripcurrents_tpu_torch.ops import image as timg

torch.set_num_threads(1)

# (src_true, dst_true, src_pad, dst_pad, scale)
GEOMETRIES = [
    ((120, 160), (240, 320), (120, 256), (240, 384), 2.0),   # legacy L2->L1
    ((240, 320), (480, 640), (240, 384), (480, 640), 2.0),   # legacy L1->L0
    ((37, 53), (75, 107), (40, 128), (80, 128), 2.0),        # odd sizes
    ((30, 41), (75, 107), (32, 128), (80, 128), 2.5),        # pyr_scale 0.4
]


def _flow(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 3
            ).astype(np.float32)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_plain_equals_dense_bit_for_bit(geom):
    src_true, dst_true, src_pad, dst_pad, scale = geom
    img = torch.from_numpy(_flow((2,) + src_pad))
    got = timg.resize_bilinear_cf_padded(img, src_true, dst_true, dst_pad,
                                         scale)
    key = timg.resize_key(img, src_true, dst_true, dst_pad, scale)
    want = timg.resize_cf_padded_dense(img, key)
    assert got.shape == (2,) + dst_pad and got.dtype == torch.float32
    assert float((got - want).abs().max()) == 0.0
    assert timg.resize_bilinear_cf_padded.launches == 0   # no kernel on CPU


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


def test_wrapper_rejects_what_the_kernel_does_not_take():
    src_true, dst_true, src_pad, dst_pad, scale = GEOMETRIES[2]
    x = torch.from_numpy(_flow((2,) + src_pad))
    with pytest.raises(ValueError):
        timg.resize_bilinear_cf_padded(x.double(), src_true, dst_true,
                                       dst_pad, scale)
    with pytest.raises(ValueError):
        timg.resize_bilinear_cf_padded(x.transpose(1, 2), src_true[::-1],
                                       dst_true[::-1], dst_pad[::-1], scale)
    with pytest.raises(ValueError):
        timg.resize_bilinear_cf_padded(x[0], src_true, dst_true, dst_pad,
                                       scale)


def test_farneback_flow_is_unchanged_by_the_two_tap_upsample(monkeypatch):
    """The engine's flow with the two-tap upsample equals its flow with
    the dense two-matmul upsample bit for bit."""
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 255, (104, 136)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    f0 = torch.from_numpy(base[4:100, 4:132].astype(np.uint8))
    f1 = torch.from_numpy(base[3:99, 2:130].astype(np.uint8))
    p = FarnebackParams.legacy()
    exp = tfb.farneback_precompute(f0, p)
    got, _ = tfb.farneback_stream(exp, f1, p)

    def dense(img, src_true, dst_true, dst_pad, scale=1.0):
        return timg.resize_cf_padded_dense(
            img, timg.resize_key(img, src_true, dst_true, dst_pad, scale))

    monkeypatch.setattr(tfb, "resize_bilinear_cf_padded", dense)
    want, _ = tfb.farneback_stream(exp, f1, p)
    assert got.shape == (96, 128, 2)
    assert float(got.abs().max()) > 0.5
    assert float((got - want).abs().max()) == 0.0
