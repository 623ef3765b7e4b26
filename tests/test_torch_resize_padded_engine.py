"""K4's wrapper checks, and the Farneback engine's flow with the two-tap
upsample against the dense one, bit for bit.

Inputs and tolerances: ``tests/_torch_resize_padded.py``.
"""

import numpy as np
import pytest
import torch

from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import farneback as tfb
from ripcurrents_tpu_torch.ops import image as timg

from _torch_resize_padded import GEOMETRIES, _flow

torch.set_num_threads(1)


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
