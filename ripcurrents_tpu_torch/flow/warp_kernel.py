"""The standalone warp of the portable Farneback engine: kernel K7, its
wrapper and its plain PyTorch version.

Port of ``ripcurrents_tpu/flow/warp_pallas.py: warp5_shift_pallas``, the
``warp_impl="pallas"`` branch of ``update_matrices``. It computes the
shift decomposition of the bilinear warp of the second frame's expansion
r1 (H, W, 5) by the flow (H, W, 2),

    out(p) = sum_sy hat(dy - sy) * sum_sx hat(dx - sx) * r1(p + (sx, sy)),

over the shifts s in [-budget, budget + 1]^2, with hat(t) = clamp(1 - |t|,
0, 1) in float32 and r1 zero outside the frame. Only the two shifts that
bracket each displacement (floor(d) and floor(d) + 1) can carry weight,
and a sum that starts at zero is not changed by adding zero terms, so K7
evaluates just those (each where it lies inside the shift range), rows in
ascending sx, then the sum over sy: the TPU's (2*budget + 2)^2-term sum,
value for value. Exact for |flow| <= budget; the caller masks the other
pixels with ``_warp5_shift_mask``.

On CUDA tensors ``warp5_shift`` launches K7 once (counted in
``warp5_shift.launches``); on CPU tensors it runs ``warp5_shift_plain``.
"""

from __future__ import annotations

import torch

from ripcurrents_tpu_torch import kernels


def _hat(d: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(d - s), 0.0, 1.0)


def warp5_shift_plain(r1: torch.Tensor, flow: torch.Tensor,
                      budget: int) -> torch.Tensor:
    """Plain PyTorch version of K7: r1 (H, W, 5) f32 warped by flow
    (H, W, 2) f32 -> (H, W, 5) f32, the same roundings and order."""
    h, w = r1.shape[0], r1.shape[1]
    dev = r1.device
    dx, dy = flow[..., 0], flow[..., 1]
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    fx, fy = torch.floor(dx), torch.floor(dy)
    lo, hi = -float(budget), float(budget + 1)

    def taps(f, d):
        out = []
        for s in (f, f + 1.0):
            use = (s >= lo) & (s <= hi)
            out.append((torch.where(use, _hat(d, s), 0.0),
                        torch.where(use, s, 0.0).long()))
        return out

    tx, ty = taps(fx, dx), taps(fy, dy)
    acc = torch.zeros_like(r1)
    for wy, sy in ty:
        row = torch.zeros_like(r1)
        yy = ys + sy
        for wx, sx in tx:
            xx = xs + sx
            inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            v = r1[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
            row = row + wx[..., None] * torch.where(inb[..., None], v, 0.0)
        acc = acc + wy[..., None] * row
    return acc


def warp5_shift(r1: torch.Tensor, flow: torch.Tensor,
                budget: int) -> torch.Tensor:
    """K7: the warp of r1 (H, W, 5) f32 by flow (H, W, 2) f32 within
    +-budget -> (H, W, 5) f32. Values where |flow| > budget are not the
    bilinear sample (callers mask them)."""
    h, w = r1.shape[0], r1.shape[1]
    for t, name, c in ((r1, "r1", 5), (flow, "flow", 2)):
        if t.dtype != torch.float32 or tuple(t.shape) != (h, w, c) or \
                not t.is_contiguous() or t.device != r1.device:
            raise ValueError(f"{name}: expected contiguous float32 "
                             f"{(h, w, c)} on {r1.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if budget < 0:
        raise ValueError(f"budget must be >= 0, got {budget}")
    if not kernels.launches_on(r1.device):
        return warp5_shift_plain(r1, flow, budget)
    out = torch.empty_like(r1)
    err = kernels.entry("warp5_shift")(
        r1.data_ptr(), flow.data_ptr(), out.data_ptr(), h, w, budget,
        torch.cuda.current_stream(r1.device).cuda_stream)
    kernels.check(err, "warp5_shift")
    warp5_shift.launches += 1
    return out


warp5_shift.launches = 0
