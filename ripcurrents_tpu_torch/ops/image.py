"""Image preparation ops: resize and grayscale, with OpenCV-matching semantics.

Port of ``ripcurrents_tpu/ops/image.py``. Frame resizes are two dense
matmuls against the same host-built (src, dst) weight matrices as the
reference, in float32 (the package switches TF32 off). The padded flow
upsample between Farneback levels is kernel K4 (``csrc/
resize_cf_padded.cu``) with its plain version beside it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ripcurrents_tpu_torch import kernels


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """uint8 BGR (H, W, 3) -> gray (H, W), matching
    cv2.cvtColor(COLOR_BGR2GRAY)'s fixed-point arithmetic exactly:
    gray = (B*1868 + G*9617 + R*4899 + (1<<13)) >> 14."""
    if img.dtype != torch.uint8:
        raise ValueError(f"bgr_to_gray takes uint8 frames, got {img.dtype}")
    i = img.to(torch.int32)
    acc = i[..., 0] * 1868 + i[..., 1] * 9617 + i[..., 2] * 4899
    return ((acc + (1 << 13)) >> 14).to(torch.uint8)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """RGB variant of :func:`bgr_to_gray`."""
    return bgr_to_gray(img.flip(-1))


@functools.lru_cache(maxsize=64)
def _linear_weights(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-pixel source indices + bilinear weights for one axis
    (half-pixel centers, edge-replicating clamp, as OpenCV).
    Returns (idx (dst, 2) int32, w (dst, 2) float32)."""
    scale = src / dst
    x = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    x0 = np.floor(x).astype(np.int64)
    frac = x - x0
    frac = np.where(x0 < 0, 0.0, frac)
    x0c = np.clip(x0, 0, src - 1)
    x1c = np.clip(x0 + 1, 0, src - 1)
    idx = np.stack([x0c, x1c], axis=-1).astype(np.int32)
    w = np.stack([1.0 - frac, frac], axis=-1).astype(np.float32)
    return idx, w


@functools.lru_cache(maxsize=64)
def _area_weights(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """INTER_AREA (downscale) indices/weights for one axis: each output
    averages [x*scale, (x+1)*scale) with end cells weighted by coverage.
    Returns (idx (dst, K), w (dst, K)), zero-padded to the max tap count."""
    scale = src / dst
    if scale < 1.0:
        return _linear_weights(src, dst)
    rows_idx, rows_w = [], []
    for x in range(dst):
        a, b = x * scale, (x + 1) * scale
        i0, i1 = int(np.floor(a)), int(np.ceil(b))
        idx, w = [], []
        for i in range(i0, min(i1, src)):
            cover = min(b, i + 1) - max(a, i)
            if cover > 1e-9:
                idx.append(i)
                w.append(cover / scale)
        rows_idx.append(idx)
        rows_w.append(w)
    k = max(len(r) for r in rows_idx)
    idx = np.zeros((dst, k), np.int32)
    w = np.zeros((dst, k), np.float32)
    for x, (ri, rw) in enumerate(zip(rows_idx, rows_w)):
        idx[x, : len(ri)] = ri
        w[x, : len(rw)] = rw
    return idx, w


@functools.lru_cache(maxsize=128)
def _resize_matrix(src: int, dst: int, idx_b: bytes, w_b: bytes,
                   taps: int) -> np.ndarray:
    """(src, dst) resize matrix from per-output-pixel (idx, w) taps."""
    idx = np.frombuffer(idx_b, np.int32).reshape(dst, taps)
    w = np.frombuffer(w_b, np.float32).reshape(dst, taps)
    m = np.zeros((src, dst), np.float32)
    for t in range(taps):
        np.add.at(m, (idx[:, t], np.arange(dst)), w[:, t])
    return m


@functools.lru_cache(maxsize=128)
def _axis_matrix(src: int, dst: int, kind: str,
                 device: torch.device) -> torch.Tensor:
    """The (src, dst) resize matrix of one axis as a device tensor."""
    fn = _linear_weights if kind == "linear" else _area_weights
    idx, w = fn(src, dst)
    m = _resize_matrix(src, dst, idx.tobytes(), w.tobytes(), idx.shape[1])
    return torch.from_numpy(m).to(device)


@functools.lru_cache(maxsize=64)
def band_source_rows(src: int, dst: int, rows: tuple[int, int],
                     kind: str = "linear") -> tuple[int, int]:
    """The source rows [a, b) that output rows [i0, i1) of a src -> dst
    resize read (the taps with nonzero weight; bilinear reaches one row
    past the band's last centre)."""
    fn = _linear_weights if kind == "linear" else _area_weights
    idx, w = fn(src, dst)
    i0, i1 = rows
    used = idx[i0:i1][w[i0:i1] != 0]
    if used.size == 0:
        used = idx[i0:i1].reshape(-1)
    return int(used.min()), int(used.max()) + 1


def _resize(img: torch.Tensor, out_hw: tuple[int, int], kind: str,
            rows: "tuple[int, int] | None" = None,
            src: "tuple[int, int] | None" = None) -> torch.Tensor:
    """Resize to out_hw, or only output rows [i0, i1) of it (`rows`) from
    img holding source rows [a0, a0 + img.shape[0]) of a frame of
    src_h rows (`src` = (a0, src_h); default the whole frame): the y pass
    multiplies the rows it needs by the same matrix's rows and columns
    for the band, so where the taps' products and sums are exact in
    float32 (weights of few bits, as 720 -> 480 and 1280 -> 640 have)
    the band equals those rows of the whole resize bit for bit."""
    h, w = out_hw
    a0, src_h = (0, img.shape[0]) if src is None else src
    my = _axis_matrix(src_h, h, kind, img.device)
    if rows is not None:
        a, b = band_source_rows(src_h, h, tuple(rows), kind)
        if a < a0 or b > a0 + img.shape[0]:
            raise ValueError(f"output rows {rows} need source rows "
                             f"[{a}, {b}), given [{a0}, "
                             f"{a0 + img.shape[0]})")
        img = img[a - a0:b - a0]
        my = my[a:b, rows[0]:rows[1]]
        h = rows[1] - rows[0]
    elif img.shape[0] != src_h:
        raise ValueError(f"{img.shape[0]} rows given for a {src_h}-row "
                         f"frame and no output rows")
    x = img.to(torch.float32)
    mx = _axis_matrix(img.shape[1], w, kind, img.device)
    rest = x.shape[2:]
    x = (my.T @ x.reshape(x.shape[0], -1)).reshape((h, x.shape[1]) + rest)
    x = torch.movedim(x, 1, 0)
    x = (mx.T @ x.reshape(x.shape[0], -1)).reshape((w, h) + rest)
    x = torch.movedim(x, 0, 1)
    if img.dtype == torch.uint8:
        # OpenCV rounds to nearest when storing back to uint8.
        return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
    return x.to(img.dtype)


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int],
                    rows: "tuple[int, int] | None" = None,
                    src: "tuple[int, int] | None" = None) -> torch.Tensor:
    """cv2.resize(..., INTER_LINEAR). img is (H, W) or (H, W, C). `rows`
    and `src` resize a row band only (``_resize``)."""
    return _resize(img, out_hw, "linear", rows, src)


def resize_area(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """cv2.resize(..., INTER_AREA): the reference's first-frame preload."""
    return _resize(img, out_hw, "area")


def resize_bilinear_cf(img: torch.Tensor,
                       out_hw: tuple[int, int]) -> torch.Tensor:
    """INTER_LINEAR resize of a channels-first (C, H, W) array as two
    matmuls, float32 out."""
    my = _axis_matrix(img.shape[1], out_hw[0], "linear", img.device)
    mx = _axis_matrix(img.shape[2], out_hw[1], "linear", img.device)
    t = torch.einsum("sd,csw->cdw", my, img.to(torch.float32))
    return torch.einsum("sw,cds->cdw", mx, t)


@functools.lru_cache(maxsize=64)
def _resize_matrices_padded(src_true, dst_true, src_pad, dst_pad, scale):
    sh_t, sw_t = src_true
    dh, dw = dst_true
    iy, wy = _linear_weights(sh_t, dh)
    ix, wx = _linear_weights(sw_t, dw)
    my = _resize_matrix(sh_t, dh, iy.tobytes(), wy.tobytes(), 2)
    mx = _resize_matrix(sw_t, dw, ix.tobytes(), wx.tobytes(), 2)
    my_p = np.zeros((src_pad[0], dst_pad[0]), np.float32)
    my_p[:sh_t, :dh] = my * scale
    mx_p = np.zeros((src_pad[1], dst_pad[1]), np.float32)
    mx_p[:sw_t, :dw] = mx
    return my_p, mx_p


@functools.lru_cache(maxsize=64)
def _padded_matrices_on(key, device: torch.device):
    my_p, mx_p = _resize_matrices_padded(*key)
    return (torch.from_numpy(np.ascontiguousarray(my_p.T)).to(device),
            torch.from_numpy(mx_p).to(device))


def _two_taps(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The (at most two) nonzeros of each row of m as (idx (n, 2) int32
    ascending, w (n, 2) float32); missing taps get weight 0."""
    n = m.shape[0]
    idx = np.zeros((n, 2), np.int32)
    w = np.zeros((n, 2), np.float32)
    for r in range(n):
        nz = np.flatnonzero(m[r])
        if len(nz) > 2:
            raise ValueError(f"row {r} has {len(nz)} nonzeros")
        idx[r, :len(nz)] = nz
        idx[r, len(nz):] = nz[-1] if len(nz) else 0
        w[r, :len(nz)] = m[r, nz]
    return idx, w


@functools.lru_cache(maxsize=64)
def _padded_taps_on(key, device: torch.device):
    """(yidx, yw, xidx, xw) of one geometry on `device`: the two source
    rows and weights of every output row of MyT, and the two source
    columns and weights of every output column of Mx. The scale fold and
    the zero pads come with the matrices."""
    my_p, mx_p = _resize_matrices_padded(*key)
    taps = _two_taps(my_p.T) + _two_taps(mx_p.T)
    return tuple(torch.from_numpy(t).to(device) for t in taps)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) on float32 tensors through float64: the product is
    exact there and the sum is rounded once to 53 bits before the
    rounding to float32, which differs from one rounding on about one
    value in 2**29."""
    return (a.double() * b.double() + c.double()).float()


def resize_cf_padded_plain(img: torch.Tensor, yidx, yw, xidx,
                           xw) -> torch.Tensor:
    """Plain PyTorch version of K4: the two-tap y pass, then the two-tap x
    pass, each sum as fmaf(w1, v1, w0 * v0) in ascending source index (the
    rounding of a float32 matrix product that accumulates with FMAs;
    the zero terms of the dense product change nothing)."""
    y0, y1 = yidx[:, 0].long(), yidx[:, 1].long()
    x0, x1 = xidx[:, 0].long(), xidx[:, 1].long()
    t = _fma(yw[:, 1, None], img[:, y1, :], yw[:, 0, None] * img[:, y0, :])
    return _fma(xw[:, 1], t[:, :, x1], xw[:, 0] * t[:, :, x0])


def resize_cf_padded_dense(img: torch.Tensor, key) -> torch.Tensor:
    """The dense two-matmul form out[c] = MyT @ img[c] @ Mx: the library
    yardstick of K4 (chip_smoke.py times it; the port calls it nowhere)."""
    myt, mx = _padded_matrices_on(key, img.device)
    return torch.matmul(torch.matmul(myt, img), mx)


# K4's block: RESIZE_WARPS warps of 32 threads, each thread 4 output
# columns of `rows` output rows; the launch bounds promise
# RESIZE_MIN_BLOCKS blocks an SM (``kernels.DEFINES``, with which the
# kernel is built). A thread takes at most RESIZE_MAX_ROWS rows: with more,
# too few threads keep loads in flight (on an H100, 4 rows a thread beat 8
# at 1080p).
RESIZE_WARPS = kernels.DEFINES["resize_cf_padded"]["RESIZE_WARPS"]
RESIZE_MIN_BLOCKS = kernels.DEFINES["resize_cf_padded"]["RESIZE_MIN_BLOCKS"]
RESIZE_MAX_ROWS = 4


def resize_plan(dph: int, dpw: int, sms: int = kernels.H100_SMS) -> dict:
    """K4's grid at an output of (dph, dpw), dpw % 4 == 0: a warp takes
    128 columns of `rows` output rows, a block RESIZE_WARPS such row
    groups; rows is the smallest power of two (at most RESIZE_MAX_ROWS)
    at which the grid fits sms * RESIZE_MIN_BLOCKS blocks, so that the
    launch is one wave of RESIZE_MIN_BLOCKS blocks an SM."""
    cols = -(-dpw // 128)
    rows = 1
    while cols * -(-dph // (RESIZE_WARPS * rows)) > sms * RESIZE_MIN_BLOCKS \
            and rows < RESIZE_MAX_ROWS:
        rows *= 2
    return {"rows": rows,
            "grid": (cols, -(-dph // (RESIZE_WARPS * rows)))}


def resize_bilinear_cf_padded(img: torch.Tensor, src_true: tuple[int, int],
                              dst_true: tuple[int, int],
                              dst_pad: tuple[int, int],
                              scale: float = 1.0) -> torch.Tensor:
    """K4: INTER_LINEAR resize of the true (sh, sw) region of a padded
    channels-first (C, SPh, SPw) float32 array into the true region of a
    (C, DPh, DPw) canvas whose pads come out exactly zero, with a scalar
    fold (the 1/pyr_scale flow rescale). The embedding, the zeros and the
    scale live in the taps: out[c] = MyT @ img[c] @ Mx. Source pad values
    meet zero weights, so they must be finite. On CUDA tensors one launch
    of the kernel over ``resize_plan``'s grid (DPw % 4 == 0); on CPU
    tensors the plain version."""
    if img.dtype != torch.float32 or img.dim() != 3 or \
            not img.is_contiguous():
        raise ValueError(f"img: expected contiguous float32 (C, SPh, SPw), "
                         f"got {img.dtype} {tuple(img.shape)}")
    c, sph, spw = img.shape
    key = resize_key(img, src_true, dst_true, dst_pad, scale)
    taps = _padded_taps_on(key, img.device)
    if not kernels.launches_on(img.device):
        return resize_cf_padded_plain(img, *taps)
    if dst_pad[1] % 4:
        raise ValueError(f"resize_bilinear_cf_padded: the padded width "
                         f"{dst_pad[1]} is not a multiple of 4 (16-byte "
                         f"stores)")
    out = torch.empty((c,) + tuple(dst_pad), dtype=torch.float32,
                      device=img.device)
    plan = resize_plan(*dst_pad, kernels.card_sms(img.device))
    err = kernels.entry("resize_cf_padded")(
        img.data_ptr(), *(t.data_ptr() for t in taps), out.data_ptr(), c,
        sph, spw, dst_pad[0], dst_pad[1], plan["rows"],
        torch.cuda.current_stream(img.device).cuda_stream)
    kernels.check(err, "resize_cf_padded")
    resize_bilinear_cf_padded.launches += 1
    return out


resize_bilinear_cf_padded.launches = 0


def resize_key(img: torch.Tensor, src_true, dst_true, dst_pad, scale):
    """The geometry key of the cached matrices and taps."""
    return (tuple(src_true), tuple(dst_true), (img.shape[1], img.shape[2]),
            tuple(dst_pad), float(scale))
