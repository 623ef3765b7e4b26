"""Helpers of tests/test_torch_space_dense.py: the four dense Farneback
modes through the port's ``run_videos`` on the CPU as a rank of a 2-rank
gloo group and with one process (``dense_rank``, spawned; it joins
through a file:// store), and the rows of one process's state that a
space rank holds. Imports torch and the port only."""

import contextlib
import pathlib

import numpy as np
import torch

import _torch_space_ranks as ranks
from ripcurrents_tpu_torch.io import video as io_video
from ripcurrents_tpu_torch.parallel import distributed
from ripcurrents_tpu_torch.pipelines import common, modes, multirunner
from ripcurrents_tpu_torch.pipelines.common import ModeConfig

DENSE = ("subtructAverageVector", "subtructAverageVectorWithWindow",
         "shearRate", "averageVector")
# 160x120 as JAX's space test; every ring (3 frames) wraps on the clips'
# 4 steps
KW = dict(xdim=160, ydim=120, window_size=3, shear_window=3,
          average_buffer=3)
CHUNK = 4


# The modes whose engine flow the 2-rank runs also take (the first clip):
# one of each preset, the sliced ring and the gathered ring mean.
ENGINE = ("shearRate", "averageVector")


def shared_flow(fs, gray, fb):
    """The flow both the port and JAX step on when they are compared: a
    function of the gray frame (``tests/test_torch_multirunner.py``), so
    a gray that differs shows in the frames."""
    return torch.stack([gray / 64.0 - 2.0, 1.0 - gray / 128.0], -1), fs


def no_stream(gray, fb):
    """The flow stream's state beside ``shared_flow``: nothing, so no
    expansion is made."""
    return common.FlowStream(())


@contextlib.contextmanager
def _patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


def dense_run(mode: str, clips, shared: bool = False, space: int = 1):
    """run_videos(mode, clips) on the CPU (`space` ranks; the process
    group initialized for 2), with ``shared_flow`` and ``no_stream`` in
    place of the engine when `shared`. -> ({s<i>: the written frames},
    every stream's last state, ``_torch_space_ranks.final_states``)."""
    kept = {}
    engine = {} if not shared else {"flow_stream_step": shared_flow,
                                    "flow_stream_init": no_stream}
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(io_video, "VideoWriter",
                                     ranks.keeping_writer(kept)))
        for name, fn in engine.items():
            stack.enter_context(_patched(modes, name, fn))
        stats = multirunner.run_videos(
            mode, clips, "d", ModeConfig(**KW), chunk=CHUNK, space=space,
            progress=False, device="cpu")
    frames = {pathlib.Path(p).stem[2:]: np.stack(f) for p, f in kept.items()}
    return frames, ranks.final_states(stats.state)


def runs(clips):
    """The 2-rank runs: (mode, tag, clips, shared) for every mode of DENSE
    on every clip with ``shared_flow`` (tag "shared"), and for those of
    ENGINE on the first clip with the engine's flow (tag "flow")."""
    return [(m, "shared", clips, True) for m in DENSE] + \
        [(m, "flow", clips[:1], False) for m in ENGINE]


def dense_rank(rank: int, store: str, out: str, clips):
    """As rank `rank` of 2, each of ``runs`` with space=2; saves the
    frames rank 0 writes (<mode>_<tag>_frames.npz) and every stream's
    last state (<mode>_<tag>_state_<rank>.npz). Then, the group left,
    every second run (from the rank's index) with one process, its
    frames and state as <mode>_<tag>_one_frames.npz / _one_state.npz."""
    torch.set_num_threads(1)
    out = pathlib.Path(out)
    distributed.init_cluster(f"file://{store}", 2, rank)
    try:
        for mode, tag, videos, shared in runs(clips):
            frames, state = dense_run(mode, videos, shared, space=2)
            if rank == 0:
                np.savez(out / f"{mode}_{tag}_frames.npz", **frames)
            np.savez(out / f"{mode}_{tag}_state_{rank}.npz", **state)
    finally:
        torch.distributed.destroy_process_group()
    for mode, tag, videos, shared in runs(clips)[rank::2]:
        frames, state = dense_run(mode, videos, shared)
        np.savez(out / f"{mode}_{tag}_one_frames.npz", **frames)
        np.savez(out / f"{mode}_{tag}_one_state.npz", **state)


def band_state(state: dict, mode: str, rows, frame_h: int) -> dict:
    """The part of one process's last state (``final_states``) that a
    space rank holding frame rows `rows` keeps: its rings' rows (the band,
    or for shearRate ``modes.shear_rows``), every other field whole."""
    s0, s1 = modes.shear_rows(rows, frame_h) if mode == "shearRate" \
        else rows
    cut = {"buffer": lambda v: v[:, s0:s1], "mean": lambda v: v[s0:s1]}
    return {k: cut.get(k.split("_", 1)[1], lambda v: v)(v)
            for k, v in state.items()}
