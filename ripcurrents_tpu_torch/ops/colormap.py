"""cv2.applyColorMap equivalents (JET, RAINBOW) as LUT gathers (port of
``ripcurrents_tpu/ops/colormap.py``; the LUTs are this package's own
copies in ``assets/``)."""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

_ASSETS = pathlib.Path(__file__).resolve().parent.parent / "assets"


@functools.lru_cache(maxsize=8)
def _lut(name: str, device: torch.device) -> torch.Tensor:
    lut = np.load(_ASSETS / f"colormap_{name}.npy")
    return torch.from_numpy(lut).to(device)


def apply_colormap(img_u8: torch.Tensor, name: str) -> torch.Tensor:
    """(H, W) uint8 -> (H, W, 3) uint8 BGR via the named LUT ('jet'|'rainbow')."""
    return _lut(name, img_u8.device)[img_u8.long()]


def normalize_to_u8(field: torch.Tensor, max_val=None) -> torch.Tensor:
    """convertTo(CV_8UC1, 255/max): scale by the field max, round,
    saturate (ripcurrents_module.cpp:13-40)."""
    if max_val is None:
        max_val = torch.max(field)
    scale = 255.0 / torch.clamp(max_val, min=1e-12)
    return torch.clamp(torch.round(field * scale), 0, 255).to(torch.uint8)
