"""The ('stream', 'space') mesh over processes (port of
``ripcurrents_tpu/parallel/mesh.py``).

JAX lays the mesh over the devices of one controller and lets GSPMD
place the collectives. Here the mesh is over processes, one card each,
as with torchrun and NCCL (NCCL refuses two ranks on one card):

- one process with no process group is the world of size 1: all its
  streams on its one card;
- rank r of a world of n sits at (stream, space) = divmod(r, space) of
  the (n // space, space) grid; each row of the grid is a 'space' group
  (``dist.new_group``), on which ``parallel/spatial.py`` exchanges halos.

The 'space' group's backend is the caller's choice (``make_mesh``):
"nccl" for ranks on distinct cards, "gloo" where ranks share a card. A
gloo group takes CPU tensors only, so collectives on it stage device
tensors through host memory; the compute stays on the card. Nothing
picks another backend when one fails.

``multi_stream_step`` / ``multi_stream_init`` are the counterpart of
``jax.vmap``: a loop of the single-stream function over the leading
stream axis, its states and outputs stacked. On one card JAX also runs
streams one after another (``pipelines/multirunner.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ripcurrents_tpu_torch.flow.farneback import _stack


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (stream, space) grid of ranks. `rank` is this process's index in
    the grid (None when it is not in the grid); `group` is its row's
    'space' process group (None for a space axis of 1)."""

    stream: int
    space: int
    rank: Optional[int] = 0
    group: object = None

    @property
    def shape(self) -> dict:
        return {"stream": self.stream, "space": self.space}

    @property
    def coords(self) -> Optional[dict]:
        """This rank's {'stream': i, 'space': j}, or None outside the
        grid."""
        if self.rank is None:
            return None
        i, j = divmod(self.rank, self.space)
        return {"stream": i, "space": j}


def world() -> tuple[int, int]:
    """(world size, this rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_devices: int | None = None, space: int | None = None,
              backend: str | None = None) -> Mesh:
    """A ('stream', 'space') mesh over the first n ranks (one card each).

    `space` (rows-sharding factor) defaults to 2 when the count is even,
    else 1. A space axis of more than one rank needs the process group
    initialized and `backend` ("nccl" or "gloo") for its row groups; every
    rank of the world must call this, since each row group is made by
    all of them (``dist.new_group``)."""
    size, rank = world()
    if n_devices is None:
        n_devices = size
    if size < n_devices:
        raise RuntimeError(f"requested {n_devices} devices, have {size}")
    if space is None:
        space = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    if space < 1 or n_devices % space:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"space={space}")
    mine = rank if rank < n_devices else None
    group = None
    if space > 1:
        if backend is None:
            raise ValueError(f"a space axis of {space} ranks needs "
                             f"backend='nccl' (distinct cards) or 'gloo' "
                             f"(ranks sharing a card)")
        for row in range(n_devices // space):
            ranks = list(range(row * space, (row + 1) * space))
            g = dist.new_group(ranks, backend=backend)
            if mine is not None and mine // space == row:
                group = g
    return Mesh(n_devices // space, space, mine, group)


def shard_streams(mesh: Mesh, frames):
    """This rank's part of a (S, H, W, ...) frame batch (tensor or
    array): its streams of the 'stream' axis, its rows of the 'space'
    axis."""
    s, h = frames.shape[0], frames.shape[1]
    if s % mesh.stream:
        raise ValueError(f"{s} streams not divisible by "
                         f"stream={mesh.stream}")
    if h % mesh.space:
        raise ValueError(f"H={h} not divisible by space={mesh.space}")
    per, band = s // mesh.stream, h // mesh.space
    c = mesh.coords
    if c is None:
        raise ValueError("this rank is not in the mesh")
    return frames[c["stream"] * per:(c["stream"] + 1) * per,
                  c["space"] * band:(c["space"] + 1) * band]


def _take(tree, i: int):
    """Stream i of a tree of stacked tensors (tensors, None, tuples,
    named tuples, lists, dicts)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    parts = [_take(v, i) for v in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") \
        else type(tree)(parts)


def multi_stream_step(step_fn):
    """`step(state, frame)` over a leading stream axis: states and frames
    (S, ...) -> (states, outputs) stacked (S, ...). Each stream goes
    through the single-stream step, so stream i equals stepping it by
    hand."""
    def step(states, frames):
        news, outs = zip(*(step_fn(_take(states, i), frames[i])
                           for i in range(frames.shape[0])))
        return _stack(list(news)), _stack(list(outs))
    return step


def multi_stream_init(init_fn):
    """`init(frame)` over a leading stream axis, states stacked (S, ...)."""
    def init(frames):
        return _stack([init_fn(frames[i]) for i in range(frames.shape[0])])
    return init


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of `t` over the ranks of `group` (the default group for None),
    as a new tensor on `t`'s device. A gloo group takes CPU tensors, so a
    device tensor goes through host memory there."""
    staged = t.device.type != "cpu" and \
        dist.get_backend(group) == dist.Backend.GLOO
    buf = t.cpu() if staged else t.clone()
    dist.all_reduce(buf, group=group)
    return buf.to(t.device) if staged else buf


def global_flow_stats(flow: torch.Tensor) -> torch.Tensor:
    """Mean |flow| over every stream and shard of every rank: this rank's
    sum of magnitudes and pixel count are summed over the world, then
    divided. flow is (..., 2); returns a float32 scalar on its device."""
    mag = torch.sqrt((flow.float() * flow.float()).sum(-1))
    local = torch.stack([mag.double().sum(),
                         torch.tensor(float(mag.numel()), dtype=torch.float64,
                                      device=flow.device)])
    if world()[0] > 1:
        local = all_reduce_sum(local)
    return (local[0] / local[1]).float()
