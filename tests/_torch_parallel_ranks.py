"""Rank entry points for tests/test_torch_parallel.py: each runs in a
process of its own (torch.multiprocessing spawn), joins a 2-rank gloo
group through a file:// store, runs the port's parallel/ layer on the
CPU and saves what it observed as .npy files in `out`. Imports torch and
the port only."""

import pathlib

import numpy as np
import torch

from ripcurrents_tpu_torch.parallel import distributed, mesh, spatial


def spatial_rank(rank: int, store: str, out: str, cases, p):
    """farneback_spatial of this rank's bands for each (frames, halo) of
    `cases` (frames: two (H, W) uint8 arrays): flow{halo}_{rank}.npy."""
    torch.set_num_threads(1)
    distributed.init_cluster(f"file://{store}", 2, rank)
    try:
        m = mesh.make_mesh(2, space=2, backend="gloo")
        for frames, halo in cases:
            a, b = (mesh.shard_streams(m, torch.from_numpy(f)[None])[0]
                    for f in frames)
            flow = spatial.farneback_spatial(a, b, p, m, halo=halo)
            np.save(pathlib.Path(out) / f"flow{halo}_{rank}.npy",
                    flow.numpy())
    finally:
        torch.distributed.destroy_process_group()


def cluster_rank(rank: int, store: str, out: str, flow, fps):
    """The farm helpers on 2 ranks: this rank's streams of `flow` (S, H,
    W, 2) and fps[rank] -> cluster_{rank}.npy holding [stream, space, slice
    start, slice stop, all_streams_fps, global_flow_stats]."""
    torch.set_num_threads(1)
    distributed.init_cluster(f"file://{store}", 2, rank)
    try:
        m = distributed.global_stream_mesh(1)
        sl = distributed.local_stream_slice(m)
        total = distributed.all_streams_fps(fps[rank])
        mine = mesh.shard_streams(m, torch.from_numpy(flow))
        stats = float(mesh.global_flow_stats(mine))
        np.save(pathlib.Path(out) / f"cluster_{rank}.npy",
                np.array([m.shape["stream"], m.shape["space"], sl.start,
                          sl.stop, total, stats], np.float64))
    finally:
        torch.distributed.destroy_process_group()
