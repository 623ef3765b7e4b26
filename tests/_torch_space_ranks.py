"""Rank entry points for tests/test_torch_space.py: each runs in a process
of its own (torch.multiprocessing spawn), joins a 2-rank gloo group
through a file:// store, runs the port's ``run_videos`` with its rows
split over the two ranks (``space=2``) on the CPU and saves what it
observed as .npy files in `out`. Imports torch and the port only."""

import json
import pathlib

import numpy as np
import torch

from ripcurrents_tpu_torch.io import video as io_video
from ripcurrents_tpu_torch.parallel import distributed, spatial
from ripcurrents_tpu_torch.pipelines import multirunner
from ripcurrents_tpu_torch.pipelines.common import ModeConfig


def keeping_writer(store: dict):
    """A VideoWriter stand-in that keeps each path's frames."""
    class Writer:
        def __init__(self, path, fps, size_hw, fourcc=None):
            self.frames = store.setdefault(str(path), [])

        def write_batch(self, frames):
            self.frames.extend(np.array(f) for f in frames)

        def close(self):
            pass
    return Writer


def videos_rank(rank: int, store: str, out: str, mode: str, clips,
                cfg_kw: dict, chunk: int, live=None):
    """run_videos(mode, clips, space=2) on the CPU as rank `rank` of 2,
    saving the written frames (rank 0: sp_s<i>.npy) and the metrics (rank
    0: sp.json). With `live` = (frames, accumulator, framecount) it then
    steps make_legacy's space form from a live state (the first frame's,
    its duty accumulator and frame count replaced; the later frames fed
    as the source rows of this rank's band) and saves each step's band
    flow (flows_<rank>.npy), rip mask and overlay rows and the last
    thresholds and histogram (live_<rank>.npz)."""
    torch.set_num_threads(1)
    out = pathlib.Path(out)
    distributed.init_cluster(f"file://{store}", 2, rank)
    try:
        kept = {}
        io_video.VideoWriter = keeping_writer(kept)
        stats = multirunner.run_videos(
            mode, clips, str(out / "sp"), ModeConfig(**cfg_kw), chunk=chunk,
            space=2, progress=False, device="cpu",
            metrics_json=str(out / "sp.json"))
        for path, frames in kept.items():
            np.save(out / f"{pathlib.Path(path).stem}.npy",
                    np.stack(frames))
        (out / f"frames_{rank}.json").write_text(json.dumps(stats.frames))
        if live is not None:
            np.savez(out / f"live_{rank}.npz", **live_legacy(
                ModeConfig(**cfg_kw), *live))
    finally:
        torch.distributed.destroy_process_group()


def live_legacy(cfg: ModeConfig, frames, accumulator, framecount,
                mesh=None) -> dict:
    """make_legacy's steps over frames[1:] from frames[0]'s state with the
    duty accumulator and frame count replaced: the space form on a
    2-rank 'space' mesh (the process group initialized), or one process
    with mesh=None. -> {flows, masks, overlays, upper, hist}: every
    step's flow, rip mask and overlay (this rank's band) and the last
    thresholds."""
    from ripcurrents_tpu_torch.parallel import mesh as pmesh
    from ripcurrents_tpu_torch.pipelines import common, legacy
    from ripcurrents_tpu_torch.ops.image import band_source_rows
    if mesh is None and torch.distributed.is_initialized():
        mesh = pmesh.make_mesh(2, space=2, backend="gloo")
    rows = common.space_rows(cfg, mesh)
    cut = slice(*(rows or (0, cfg.ydim)))
    init, step = legacy.make_legacy(cfg, "cpu", mesh)
    state = init(frames[0])
    state = state._replace(
        accumulator=torch.from_numpy(accumulator[cut]).clone(),
        framecount=torch.tensor(framecount, dtype=torch.int32))
    flows, record = [], (spatial if rows else legacy)
    name = "spatial_stream_step" if rows else "flow_stream_step"
    inner = getattr(record, name)

    def recording(*args, **kw):
        flow, fs = inner(*args, **kw)
        flows.append(flow.numpy().copy())
        return flow, fs
    setattr(record, name, recording)
    masks, overlays = [], []
    try:
        for f in frames[1:]:
            if rows:
                a, b = band_source_rows(f.shape[0], cfg.ydim, rows)
                state, outs = step(state, f[a:b], (a, f.shape[0]))
            else:
                state, outs = step(state, f)
            masks.append(outs.mask.numpy())
            overlays.append(outs.overlay_bgr.numpy())
    finally:
        setattr(record, name, inner)
    return {"flows": np.stack(flows), "masks": np.stack(masks),
            "overlays": np.stack(overlays), "upper": state.upper.numpy(),
            "hist": state.hist.hist2d.numpy()}
