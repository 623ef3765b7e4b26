"""Synthetic frames made from a seed, for runs on the card
(chip_smoke.py, trace_legacy.py): beach-like moving texture, and the
1080p rip clip of the detector golden."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def moving_frames(n: int, h: int, w: int, device, seed: int = 0,
                  color: bool = True) -> torch.Tensor:
    """n uint8 frames of a smooth random texture drifting 2 px per frame
    under wave bands that move down the frame: (n, h, w, 3) BGR, or
    (n, h, w) gray."""
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


RIP_H, RIP_W = 1080, 1920


def make_rip_clip(t_frames: int) -> np.ndarray:
    """The 1080p detector golden's clip (numpy only; a copy of
    ``tools/golden_detector_1080p.py: make_rip_clip``): shoreward wave
    bands (~4.3 px/frame phase speed) with an x-shear, damped inside a
    vertical rip channel, over smoothed random texture from seed 42.
    -> (t_frames, 1080, 1920, 3) uint8, gray in all three channels. The
    committed oracle mask ``assets/detector_oracle_1080p_48f_v2.npz`` is
    the cv2 detector's on its first 48 frames."""
    h, w = RIP_H, RIP_W
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = rng.uniform(0, 255, (h, w)).astype(np.float32)
    k = np.ones(9) / 9
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)
    damp = np.ones((h, w), np.float32)
    damp[:, int(w * 0.55):int(w * 0.64)] = 0.06
    shear = 0.35 * np.sin(2 * np.pi * xx / 640.0)   # locally varying phase
    frames = []
    for t in range(t_frames):
        wave = 70 * np.sin(2 * np.pi * (yy / 36.0 - t * 0.12) + shear)
        g = np.clip(base * 0.5 + wave * damp + 80, 0, 255)
        frames.append(np.stack([g, g, g], -1).astype(np.uint8))
    return np.stack(frames)
