"""Helpers of tests/test_torch_space_trails.py: the three trail modes and
the three exposure modes through the port's ``run_videos`` on the CPU as
a rank of a K-rank gloo group and with one process (``trails_rank``,
spawned; it joins through a file:// store), and the rows of one
process's state that a space rank holds. Imports torch and the port
only."""

import contextlib
import pathlib

import numpy as np
import torch

import _torch_space_dense as dense
import _torch_space_ranks as ranks
from ripcurrents_tpu_torch.io import video as io_video
from ripcurrents_tpu_torch.parallel import distributed
from ripcurrents_tpu_torch.pipelines import modes, multirunner
from ripcurrents_tpu_torch.pipelines.common import ModeConfig

TRAILS = ("streamlines", "timelinesOnSubtractAverageVector",
          "timelinesFarne")
EXPOSURE = ("averageHSV", "timex", "brightColor")
# 160x120 as JAX's space test; the rings (3 frames) wrap on the clips' 4
# steps, and the trails' shade (frame count x 255 / total_frames) reaches
# its clamp at 255 on the third
KW = dict(xdim=160, ydim=120, total_frames=3, average_buffer=3,
          bright_window=3)
CHUNK = 4
# The trail modes' seeds in every run (``_torch_space_ranks.seeded``):
# the modes' own lie outside a 160x120 frame or on one row, and torch
# cannot draw JAX's random ones. These cross every band boundary of 2
# and 3 bands.
SEEDS = np.floor(np.random.default_rng(7).uniform(
    (6.0, 4.0), (154.0, 116.0), (12, 2))).astype(np.float32)


def trail_run(mode: str, clips, shared: bool = False, space: int = 1):
    """run_videos(mode, clips) on the CPU (`space` ranks; the process
    group initialized for them), the trail modes from SEEDS, with
    ``_torch_space_dense.shared_flow`` and ``no_stream`` in place of the
    engine when `shared`. -> ({s<i>: the written frames}, every stream's
    last state, ``_torch_space_ranks.final_states``)."""
    kept = {}
    engine = {} if not shared else {"flow_stream_step": dense.shared_flow,
                                    "flow_stream_init": dense.no_stream}
    with contextlib.ExitStack() as stack:
        stack.enter_context(dense._patched(io_video, "VideoWriter",
                                           ranks.keeping_writer(kept)))
        for name, fn in engine.items():
            stack.enter_context(dense._patched(modes, name, fn))
        stack.enter_context(ranks.seeded(mode, SEEDS if mode in TRAILS
                                         else None))
        stats = multirunner.run_videos(
            mode, clips, "t", ModeConfig(**KW), chunk=CHUNK, space=space,
            progress=False, device="cpu")
    frames = {pathlib.Path(p).stem[2:]: np.stack(f) for p, f in kept.items()}
    return frames, ranks.final_states(stats.state)


def runs(clips):
    """The 2-rank runs: (mode, tag, clips, shared) for the trail modes on
    every clip with ``shared_flow`` (tag "shared") and on the first clip
    with the engine's flow (tag "flow"), and for the exposure modes on
    every clip (tag "plain")."""
    return [(m, "shared", clips, True) for m in TRAILS] + \
        [(m, "flow", clips[:1], False) for m in TRAILS] + \
        [(m, "plain", clips, False) for m in EXPOSURE]


def runs_k3(clips):
    """The 3-rank runs: one trail mode on the engine's flow and one
    exposure mode, on the first clip."""
    return [("timelinesOnSubtractAverageVector", "flow", clips[:1], False),
            ("brightColor", "plain", clips[:1], False)]


def trails_rank(rank: int, store: str, out: str, clips, world: int = 2):
    """As rank `rank` of `world`, each of ``runs`` (``runs_k3`` when world
    is 3) with space=world; saves the frames rank 0 writes
    (<mode>_<tag>_frames.npz) and every stream's last state
    (<mode>_<tag>_state_<rank>.npz). Then, the group left, every
    world-th run (from the rank's index) with one process, its frames
    and state as <mode>_<tag>_one_frames.npz / _one_state.npz."""
    torch.set_num_threads(1)
    out = pathlib.Path(out)
    todo = runs(clips) if world == 2 else runs_k3(clips)
    distributed.init_cluster(f"file://{store}", world, rank)
    try:
        for mode, tag, videos, shared in todo:
            frames, state = trail_run(mode, videos, shared, space=world)
            if rank == 0:
                np.savez(out / f"{mode}_{tag}_frames.npz", **frames)
            np.savez(out / f"{mode}_{tag}_state_{rank}.npz", **state)
    finally:
        torch.distributed.destroy_process_group()
    for mode, tag, videos, shared in todo[rank::world]:
        frames, state = trail_run(mode, videos, shared)
        np.savez(out / f"{mode}_{tag}_one_frames.npz", **frames)
        np.savez(out / f"{mode}_{tag}_one_state.npz", **state)


def band_state(state: dict, rows) -> dict:
    """The part of one process's last state (``final_states``) that a
    space rank holding frame rows `rows` keeps: the rows of its trail
    canvas, ring or running sum, every other field whole."""
    s0, s1 = rows
    cut = {"buffer": lambda v: v[:, s0:s1], "mean": lambda v: v[s0:s1],
           "overlay": lambda v: v[s0:s1], "sum_rgb": lambda v: v[s0:s1]}
    return {k: cut.get(k.split("_", 1)[1], lambda v: v)(v)
            for k, v in state.items()}
