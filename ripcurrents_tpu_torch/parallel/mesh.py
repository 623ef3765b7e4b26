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

The 'space' helpers (``space_all_reduce``, ``space_gather_rows``,
``parallel/spatial.py: exchange_rows``) stage device tensors through
host memory on a gloo group only, and add their host seconds and the
bytes this rank sends to the mesh's ``tally``. ``space_backend`` picks
the group's backend from where the ranks run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

from ripcurrents_tpu_torch.flow.farneback import _stack


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (stream, space) grid of ranks. `rank` is this process's index in
    the grid (None when it is not in the grid); `group` is its row's
    'space' process group (None for a space axis of 1), `host_group` a
    gloo group of the same ranks for host arrays (`group` itself when
    that is gloo). `tally` is what this rank's exchanges on the mesh
    cost (``exchanged``)."""

    stream: int
    space: int
    rank: Optional[int] = 0
    group: object = None
    host_group: object = None
    tally: dict = dataclasses.field(default_factory=lambda: {
        "step": new_tally(), "output": new_tally()}, compare=False,
        repr=False)

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
    group = host = None
    if space > 1:
        if backend is None:
            raise ValueError(f"a space axis of {space} ranks needs "
                             f"backend='nccl' (distinct cards) or 'gloo' "
                             f"(ranks sharing a card)")
        for row in range(n_devices // space):
            ranks = list(range(row * space, (row + 1) * space))
            g = dist.new_group(ranks, backend=backend)
            h = g if backend == "gloo" else dist.new_group(ranks,
                                                           backend="gloo")
            if mine is not None and mine // space == row:
                group, host = g, h
    return Mesh(n_devices // space, space, mine, group, host)


def space_backend(device: torch.device, space: int) -> str:
    """The 'space' groups' backend for this layout: "nccl" when every
    rank of each group of `space` consecutive ranks runs on a card of its
    own, "gloo" when two of them share one (NCCL refuses two ranks on
    one card). Every rank of the world must call this: it gathers each
    rank's (host, device) over the world's group."""
    where = (socket.gethostname(), device.type, device.index)
    size, _ = world()
    seen = [None] * size
    dist.all_gather_object(seen, where)
    if device.type != "cuda":
        return "gloo"
    for row in range(size // space):
        ranks = seen[row * space:(row + 1) * space]
        if len(set(ranks)) < len(ranks):
            return "gloo"
    return "nccl"


def new_tally() -> dict:
    """What a rank's exchanges cost: host seconds around each (the
    staging copies and the wait for the other ranks included, the wait
    for the card before a staged copy not), bytes this rank sent and the
    exchanges made, in all and by label ("by": label -> [seconds, bytes,
    calls])."""
    return {"seconds": 0.0, "bytes": 0, "calls": 0, "by": {}}


@contextlib.contextmanager
def exchanged(mesh: Mesh, x: torch.Tensor, group=None,
              nbytes: "int | None" = None, tally: str = "step",
              label: str = "other"):
    """Stage x for a collective on `group` (mesh.group by default):
    yields (x as the group takes it, back(t) that moves a received
    tensor to x's device). A gloo group takes CPU tensors, so a device
    tensor is copied to host memory (after the card has made it) and
    back; NCCL takes it as it is. Adds the time and the bytes sent
    (`nbytes`, default x's) to mesh.tally[`tally`] ("step": the steps'
    exchanges, "output": the output bands' gathers), in all and under
    `label`."""
    group = mesh.group if group is None else group
    staged = x.device.type != "cpu" and \
        dist.get_backend(group) == dist.Backend.GLOO
    if staged:
        torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    yield ((x.cpu() if staged else x),
           (lambda t: t.to(x.device)) if staged else (lambda t: t))
    tally = mesh.tally[tally]
    cost = [time.perf_counter() - t0,
            x.numel() * x.element_size() if nbytes is None else nbytes, 1]
    for key, v in zip(("seconds", "bytes", "calls"), cost):
        tally[key] += v
    by = tally["by"].setdefault(label, [0.0, 0, 0])
    for i, v in enumerate(cost):
        by[i] += v


def space_all_reduce(mesh: "Mesh | None", t: torch.Tensor,
                     op: str = "sum", label: str = "all-reduce"
                     ) -> torch.Tensor:
    """`t` reduced ("sum" or "max") over this rank's 'space' group, as a
    new tensor on t's device; t itself without a mesh or for a space
    axis of 1. `label` names the exchange in the mesh's tally."""
    if mesh is None or mesh.space == 1:
        return t
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    with exchanged(mesh, t, label=label) as (buf, back):
        buf = buf.clone() if buf is t else buf
        dist.all_reduce(buf, op=ops[op], group=mesh.group)
        return back(buf)


def space_gather_rows(mesh: Mesh, x: torch.Tensor,
                      label: str = "row bands") -> torch.Tensor:
    """The full frame from every rank's row band: x (band, ...) ->
    (space * band, ...) on x's device, the bands in 'space' order. Every
    rank of the group gets it; x itself for a space axis of 1. `label`
    names the exchange in the mesh's tally."""
    if mesh.space == 1:
        return x
    with exchanged(mesh, x.contiguous(), label=label) as (buf, back):
        parts = [torch.empty_like(buf) for _ in range(mesh.space)]
        dist.all_gather(parts, buf, group=mesh.group)
        return back(torch.cat(parts))


def gather_host_rows(mesh: Mesh, x: torch.Tensor):
    """Host bands (..., band, W, ...) gathered on the first rank of this
    rank's 'space' group over its gloo group: -> the full frames, rows
    concatenated along dim 1 ((T, space * band, ...) from (T, band,
    ...)), on the first rank; None on the others."""
    first = mesh.rank - mesh.coords["space"]
    with exchanged(mesh, x.contiguous(), mesh.host_group, tally="output",
                   label="output bands") as (buf, _):
        parts = ([torch.empty_like(buf) for _ in range(mesh.space)]
                 if mesh.rank == first else None)
        dist.gather(buf, parts, dst=first, group=mesh.host_group)
    return None if parts is None else torch.cat(parts, dim=1)


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
