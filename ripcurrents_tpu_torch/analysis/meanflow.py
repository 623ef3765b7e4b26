"""Mean-flow subtraction and temporal flow averaging (port of the
functions of ``ripcurrents_tpu/analysis/meanflow.py`` that the dense modes
need): subtructAverage (ripcurrents_module.cpp:810-898), averageVector
(:386-484) and the sliding-window mean of
compute_subtructAverageVectorWithWindow (main.cpp:1143-1153).

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
                   dt: float = 2.0,
                   grid_count: int = GRID_COUNT) -> AverageVectorOut:
    """averageVector: the ring mean of advection deltas -> an HSV field and
    each grid cell's mean angle; cells whose angle is more than 0.7*pi from
    the global mean get counter-flow (rip) arrows."""
    ring = ring_update(state.ring, delta_field(flow, dt, upper))
    avg = ring.mean

    theta = torch.atan2(avg[..., 1], avg[..., 0]) * (180.0 / math.pi)
    theta = torch.where(theta < 0, theta + 360.0, theta)
    mag = torch.sqrt(torch.sum(avg * avg, dim=-1))
    hue = theta / 2.0
    val = mag * 255.0 / state.max_displacement
    hsv = torch.stack([torch.clamp(hue, 0, 255),
                       torch.full_like(hue, 255.0),
                       torch.clamp(val, 0, 255)], dim=-1).to(torch.uint8)

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
