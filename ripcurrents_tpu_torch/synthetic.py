"""Synthetic beach-like frames made from a seed, for runs on the card
(chip_smoke.py, trace_legacy.py): a smooth random texture drifting 2 px
per frame under wave bands that move down the frame."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def moving_frames(n: int, h: int, w: int, device, seed: int = 0,
                  color: bool = True) -> torch.Tensor:
    """n uint8 frames: (n, h, w, 3) BGR, or (n, h, w) gray."""
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((1, 1, h, w), generator=g) * 255
    base = F.avg_pool2d(F.pad(base, (3, 3, 3, 3), mode="replicate"), 7,
                        stride=1)[0, 0].to(device)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    out = []
    for t in range(n):
        wave = 50 * torch.sin(2 * math.pi * (yy / 30.0 - t * 0.11)) * (yy / h)
        f = torch.clamp(torch.roll(base, 2 * t, dims=1) * 0.7 + wave + 50,
                        0, 255)
        if color:
            f = torch.stack([f * 0.9, f, torch.clamp(f * 1.1, 0, 255)], -1)
        out.append(f.to(torch.uint8))
    return torch.stack(out)
