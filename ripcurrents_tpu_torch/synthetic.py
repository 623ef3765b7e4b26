"""Synthetic frames made from a seed, for runs on the card
(chip_smoke.py, trace_legacy.py): beach-like moving texture, the 1080p
rip clip of the detector golden, and a jittered clip for the
stabilization mode."""

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


def _gaussian_blur_reflect101(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), sigma) on float32 (kernel size
    round(8 sigma + 1) | 1, reflect-101 border), separable, in numpy."""
    ksize = int(np.floor(sigma * 8 + 1 + 0.5)) | 1
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k /= k.sum()
    r = ksize // 2
    out = img.astype(np.float64)
    for ax in (0, 1):
        pad = [(0, 0), (0, 0)]
        pad[ax] = (r, r)
        p = np.pad(out, pad, mode="reflect")
        n = out.shape[ax]
        out = sum(k[i] * np.take(p, np.arange(i, i + n), axis=ax)
                  for i in range(ksize))
    return out.astype(np.float32)


def make_jittered_clip(rng: np.random.Generator, h: int = 240,
                       w: int = 320, t: int = 8, blobs: int = 150):
    """A textured scene translated by known per-frame jitter (+-4 px;
    frame 0 unjittered): a numpy-only copy of
    ``tests/test_stabilize_vs_akaze.py: make_jittered_clip``. Blurred
    uniform noise (sigma 1.2) on an (h + 64, w + 64) canvas with `blobs`
    filled discs (radius 2-4) so AKAZE finds keypoints; frame k samples
    it bilinearly at (x - 32 - jx, y - 32 - jy), 0 outside, as
    cv2.warpAffine with the translation (32 + jx, 32 + jy) does.
    -> ((t, h, w, 3) uint8, gray in all three channels; jitter (t, 2)
    float32, (dx, dy))."""
    big = rng.uniform(0, 255, (h + 64, w + 64)).astype(np.float32)
    big = _gaussian_blur_reflect101(big, 1.2)
    yy, xx = np.mgrid[0:h + 64, 0:w + 64]
    for _ in range(blobs):
        cy = int(rng.uniform(8, h + 56))
        cx = int(rng.uniform(8, w + 56))
        r = int(rng.uniform(2, 5))
        big[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = \
            float(rng.uniform(0, 255))
    jit = rng.uniform(-4, 4, (t, 2)).astype(np.float32)
    jit[0] = 0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for k in range(t):
        sx = xs - (32 + jit[k, 0])
        sy = ys - (32 + jit[k, 1])
        x0 = np.floor(sx).astype(np.int64)
        y0 = np.floor(sy).astype(np.int64)
        fx, fy = sx - x0, sy - y0

        def tap(yi, xi):
            ok = (yi >= 0) & (yi < h + 64) & (xi >= 0) & (xi < w + 64)
            return np.where(ok, big[np.clip(yi, 0, h + 63),
                                    np.clip(xi, 0, w + 63)], 0.0)
        g = ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1)) +
             fy * ((1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)))
        g = np.clip(np.round(g), 0, 255).astype(np.uint8)
        frames.append(np.stack([g, g, g], -1))
    return np.stack(frames), jit
