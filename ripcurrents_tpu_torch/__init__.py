"""PyTorch and CUDA port of the rip-current flow engine.

The JAX package ``ripcurrents_tpu`` is the reference; this package mirrors
its module layout (ops/, flow/, analysis/, dynamics/, viz/, pipelines/)
and keeps its layouts at public functions. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; the hand-written Hopper
kernels live in ``csrc/`` and are built at first use (``kernels.py``).
"""

import torch

# The resize and expansion-prep matmuls (ops/image.py, flow/farneback.py)
# are float32 on the reference (XLA f32 dots). TF32 keeps ~3 decimal
# digits, so it is switched off explicitly rather than left to defaults.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """The torch.device an entry point runs on. A CUDA device without a
    usable card raises: nothing drops to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev
