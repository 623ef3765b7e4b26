"""Inputs shared by the ``test_torch_resize_padded*.py`` files: K4's
plain version (the padded channels-first flow upsample between
Farneback levels, which is what runs on CPU tensors) against the dense
two-matmul form it replaces and against the JAX package.

The plain version sums each output's two taps as fmaf(w1, v1, w0 * v0) in
ascending source index. That is the rounding of the dense float32 product
out[c] = MyT @ img[c] @ Mx where the product accumulates with FMAs along
the source axis in one pass, as the CPU's does at these sizes: max |d|
0.0 is required. Against the JAX function (other matmul rounding):
1e-5.
"""

import numpy as np

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
