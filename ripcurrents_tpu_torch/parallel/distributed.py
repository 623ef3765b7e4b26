"""Multi-host scale-out: stream farms over torch.distributed (port of
``ripcurrents_tpu/parallel/distributed.py``).

Every process runs the same command with its own videos on its own
card, and joins one process group with ``init_cluster``. Stream-parallel
work is embarrassingly parallel, so nothing crosses processes on the hot
path: each process decodes and steps its own streams
(``pipelines/multirunner.py``), and only host scalars such as the
farm-wide fps (``all_streams_fps``) travel, as JAX's
``process_allgather`` gathers host values. The farm's group is therefore
gloo, which also runs several processes on one card; there is no
auto-detection of a cluster, so the coordinator, the process count and
this process's id are given explicitly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ripcurrents_tpu_torch.parallel.mesh import (Mesh, all_reduce_sum,
                                                 make_mesh, world)


def init_cluster(coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None) -> None:
    """Join the farm's gloo process group at tcp://<coordinator_address>
    (HOST:PORT, served by process 0; an address with a scheme, such as
    file:///path, is taken as the init method itself). A no-op for one
    process with no coordinator. A rendezvous that fails raises."""
    if num_processes in (None, 1) and coordinator_address is None:
        return  # single-process run; nothing to initialize
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise ValueError("a stream farm needs --coordinator HOST:PORT, "
                         "--num-processes and --process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is outside "
                         f"0..{num_processes - 1}")
    init = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=init,
                            world_size=num_processes, rank=process_id)


def global_stream_mesh(space: int = 1, backend: str | None = None) -> Mesh:
    """('stream', 'space') mesh over ALL processes, one card each, in
    rank order (each process's streams live on its own card). `backend`
    is the 'space' groups' (``make_mesh``)."""
    n, _ = world()
    if n % space:
        raise ValueError(f"{n} devices not divisible by space={space}")
    return make_mesh(n, space, backend)


def local_stream_slice(mesh: Mesh) -> slice:
    """The rows of the global stream axis owned by this process: the
    rows of its 'space' group (a stream group of mesh.space processes)."""
    n, pid = world()
    per = mesh.shape["stream"] * mesh.space // n
    g = pid // mesh.space
    return slice(g * per, (g + 1) * per)


def all_streams_fps(local_fps: float) -> float:
    """Farm-wide aggregate throughput: this process's fps summed over
    every process of the farm (its gloo group)."""
    x = torch.tensor([local_fps], dtype=torch.float64)
    if world()[0] > 1:
        x = all_reduce_sum(x)
    return float(x[0])
