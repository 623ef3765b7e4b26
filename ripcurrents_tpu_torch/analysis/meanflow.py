"""Mean-flow subtraction, jitter stabilization and temporal averaging
(port of ``ripcurrents_tpu/analysis/meanflow.py``): subtructAverage
(ripcurrents_module.cpp:810-898), subtructMeanMagnitude (:900-1015),
stabilizer (:279-308), averageVector (:386-484), averageHSV (:365-376),
the sliding-window mean of compute_subtructAverageVectorWithWindow
(main.cpp:1143-1153) and the reductions of compute_timex and
compute_brightColor (main.cpp:1195-1382).

A ring buffer keeps the reference's incremental update, "average -=
old/N; average += new/N", so that its numbers drift as the reference's
do. ``ring_update`` is a function of its input state, as in the JAX
package: it writes the new entry into a new buffer and leaves the input
state's untouched, so a held state can be stepped again (a replay, a
resume from a snapshot) with the same result. For the averageVector ring
(300 full frames of flow, 737 MB at 640x480) that costs a second buffer
alive during the step and one copy of the ring per frame.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ripcurrents_tpu_torch.config import BUFFER_FRAME, GRID_COUNT
from ripcurrents_tpu_torch.dynamics.advect import delta_field


def subtract_average(flow: torch.Tensor) -> torch.Tensor:
    """Remove the global mean flow vector (subtructAverage)."""
    return flow - flow.reshape(-1, 2).mean(dim=0)


def subtract_mean_magnitude(flow: torch.Tensor) -> torch.Tensor:
    """Shrink each vector along its direction by the mean magnitude
    (subtructMeanMagnitude)."""
    mag = torch.sqrt(torch.sum(flow * flow, dim=-1, keepdim=True))
    unit = torch.where(mag > 0, flow / torch.clamp(mag, min=1e-20), 0.0)
    return unit * (mag - mag.mean())


def stabilize_flow(flow: torch.Tensor, strength: float = 0.2) -> torch.Tensor:
    """stabilizer: the camera jitter estimated from the flow of the
    bottom-right 10% block (assumed static beach), `strength` x that
    estimate subtracted from every nonzero component.

    The reference's quirk is kept: it divides the block's component sums
    by one dimension only (sum_x / n_cols, sum_y / n_rows,
    ripcurrents_module.cpp:295-296), not by the pixel count."""
    h, w = flow.shape[0], flow.shape[1]
    block = flow[int(h * 0.9):, int(w * 0.9):]
    n_rows, n_cols = block.shape[0], block.shape[1]
    s = block.reshape(-1, 2).sum(dim=0)
    mean = torch.stack([s[0] / n_cols, s[1] / n_rows])
    return torch.where(flow != 0, flow - mean * strength, flow)


class RingMean(NamedTuple):
    """Sliding-window mean over the last `capacity` frames."""
    buffer: torch.Tensor   # (capacity, ...) past entries
    mean: torch.Tensor     # (...) running mean
    index: torch.Tensor    # () int32 next slot


def ring_init(capacity: int, shape, device="cpu",
              dtype=torch.float32) -> RingMean:
    return RingMean(torch.zeros((capacity,) + tuple(shape), dtype=dtype,
                                device=device),
                    torch.zeros(tuple(shape), dtype=dtype, device=device),
                    torch.zeros((), dtype=torch.int32, device=device))


def ring_update(state: RingMean, value: torch.Tensor) -> RingMean:
    """mean -= buf[i]/N; buf[i] = value; mean += value/N; i = (i+1) % N,
    into a new buffer (state's is not written)."""
    n = state.buffer.shape[0]
    at = state.index.reshape(1).long()
    old = state.buffer.index_select(0, at)[0]
    mean = state.mean - old / n + value / n
    buf = state.buffer.index_copy(0, at, value[None].to(state.buffer.dtype))
    return RingMean(buf, mean, (state.index + 1) % n)


class AverageVectorState(NamedTuple):
    ring: RingMean                  # of per-pixel advection deltas
    max_displacement: torch.Tensor  # () running max magnitude (prev frame)


def average_vector_init(h: int, w: int, capacity: int = BUFFER_FRAME,
                        device="cpu") -> AverageVectorState:
    return AverageVectorState(ring_init(capacity, (h, w, 2), device),
                              torch.tensor(1e-6, dtype=torch.float32,
                                           device=device))


class AverageVectorOut(NamedTuple):
    state: AverageVectorState
    hsv_u8: torch.Tensor            # (H, W, 3) uint8 HSV of the mean field
    global_angle_rad: torch.Tensor
    grid_angle_deg: torch.Tensor    # (GRID_COUNT, GRID_COUNT) mean angle
    counter_mask: torch.Tensor      # (GRID_COUNT, GRID_COUNT) bool arrows


def average_vector(state: AverageVectorState, flow: torch.Tensor, upper,
                   dt: float = 2.0, grid_count: int = GRID_COUNT,
                   rows: "tuple[int, int] | None" = None,
                   gather=None) -> AverageVectorOut:
    """averageVector: the ring mean of advection deltas -> an HSV field and
    each grid cell's mean angle; cells whose angle is more than 0.7*pi from
    the global mean get counter-flow (rip) arrows.

    rows=(i0, i1): the state's ring holds those rows of the frame whose
    whole flow `flow` is, and gather(the ring's mean) gives the whole
    frame's mean (the bands of every rank). The global angle, the grid,
    the mask and the new max come from that whole mean, so they equal
    one process's bit for bit; hsv_u8 holds the rows' field only."""
    ring = ring_update(state.ring, delta_field(flow, dt, upper, rows))
    avg = ring.mean if rows is None else gather(ring.mean)

    theta = torch.atan2(avg[..., 1], avg[..., 0]) * (180.0 / math.pi)
    theta = torch.where(theta < 0, theta + 360.0, theta)
    mag = torch.sqrt(torch.sum(avg * avg, dim=-1))
    hue = theta / 2.0
    val = mag * 255.0 / state.max_displacement
    cut = slice(*(rows or (0, None)))
    hsv = torch.stack([torch.clamp(hue[cut], 0, 255),
                       torch.full_like(hue[cut], 255.0),
                       torch.clamp(val[cut], 0, 255)], dim=-1).to(torch.uint8)

    new_max = torch.clamp(torch.max(mag), min=1e-6)
    gtheta = torch.sum(hue * val)
    gmag = torch.sum(val)
    global_angle = (gtheta * 2.0 / torch.clamp(gmag, min=1e-6) * math.pi /
                    180.0)

    h, w = flow.shape[0], flow.shape[1]
    ch, cw = h // grid_count, w // grid_count
    cells = theta[:ch * grid_count, :cw * grid_count].reshape(
        grid_count, ch, grid_count, cw)
    grid_angle = cells.sum(dim=(1, 3)) / (ch * cw)

    diff = torch.abs(grid_angle * math.pi / 180.0 - global_angle)
    between = torch.minimum(diff, 2 * math.pi - diff)
    return AverageVectorOut(AverageVectorState(ring, new_max), hsv,
                            global_angle, grid_angle,
                            between > math.pi * 0.7)


def average_hsv_update(state: RingMean, frame_hsv: torch.Tensor) -> RingMean:
    """averageHSV: the ring mean of the last N frames."""
    return ring_update(state, frame_hsv.to(torch.float32))


def timex_update(sum_rgb: torch.Tensor,
                 frame_bgr_u8: torch.Tensor) -> torch.Tensor:
    """compute_timex: the running sum of the raw frames (the mode divides
    by the frame count)."""
    return sum_rgb + frame_bgr_u8.to(torch.float32)


def bright_color_reduce(buffer_hsv_u8: torch.Tensor,
                        option: int) -> torch.Tensor:
    """compute_brightColor over a (T, H, W, 3) uint8 HSV buffer: option 0
    = mean, 1 = the pixel of largest V, 2 = the pixel of smallest V (the
    first frame's on a tie, as argmax and argmin take it).

    Option 0 keeps the reference's uint8 Mat arithmetic
    (main.cpp:1313,1326): each buffer[i] / windowSize rounds half to even
    to uint8 before the sum, so the 'average' is a sum of rounded
    quotients; for nonnegative addends the per-step saturation equals one
    final clip."""
    if option == 0:
        n = buffer_hsv_u8.shape[0]
        q = torch.clamp(torch.round(buffer_hsv_u8.to(torch.float32) / n),
                        0, 255)
        return torch.clamp(q.sum(dim=0), 0, 255).to(torch.uint8)
    v = buffer_hsv_u8[..., 2].to(torch.int32)
    idx = torch.argmax(v, dim=0) if option == 1 else torch.argmin(v, dim=0)
    return torch.take_along_dim(buffer_hsv_u8, idx[None, ..., None],
                                dim=0)[0]
