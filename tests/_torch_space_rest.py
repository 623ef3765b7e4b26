"""Helpers of tests/test_torch_space_rest.py: android, phaseCorrelate,
globalOrientation and stabilizeTPU through the port's ``run_videos`` on
the CPU as a rank of a K-rank gloo group and with one process
(``rest_rank``, spawned; it joins through a file:// store), android
from a live state, stabilizeTPU with given RANSAC noise, and the rows
of one process's state that a space rank holds. Imports torch and the
port only."""

import contextlib
import pathlib

import numpy as np
import torch

import _torch_space_dense as dense
import _torch_space_ranks as ranks
from ripcurrents_tpu_torch.flow import feature_stab
from ripcurrents_tpu_torch.io import video as io_video
from ripcurrents_tpu_torch.ops.image import resize_area
from ripcurrents_tpu_torch.parallel import distributed
from ripcurrents_tpu_torch.pipelines import android, common, modes
from ripcurrents_tpu_torch.pipelines import multirunner
from ripcurrents_tpu_torch.pipelines.common import MODES, ModeConfig

REST = ("android", "phaseCorrelate", "globalOrientation", "stabilizeTPU")
# 160x120 as JAX's space test; android's local windows are anchored at
# rows 0, 20, 40 and 60, so windows straddle the boundaries of 2 bands
# (60) and of 3 (40, 80)
KW = dict(xdim=160, ydim=120)
CHUNK = 4
# android's live state: the frame count just below the overlay warmup
# (90), so the clips' 4 steps draw the overlay from the third on, and an
# accumulator whose columns 20-139 mix low-duty counts (1-3, below 5% of
# i) and mid-duty ones (6-15, 5-20% of i) in every row, so that windows
# on both sides of every band boundary vote; rows 100-119 stay 0
I0 = 89
ACC = np.zeros((120, 160), np.float32)
_rng = np.random.default_rng(11)
ACC[:100, 20:140] = np.where(_rng.uniform(size=(100, 120)) < 0.5,
                             _rng.integers(1, 4, (100, 120)),
                             _rng.integers(6, 16, (100, 120)))


def big_clip(path, n: int = 5):
    """A 240x180 clip of noise moving 1 px right and 2 px down a frame,
    which the runs resize to 160x120 (1.5 : 1, as 720 -> 480): with the
    frame pump (its band where the band's rows resize exactly; the whole
    frame for android and phaseCorrelate) or on the device (android and
    phaseCorrelate resize the whole frame with INTER_AREA). The ROI's
    vertical shift at 160x120 is 1.33 px a frame."""
    import cv2
    rng = np.random.default_rng(6)
    base = rng.uniform(0, 255, (180, 240, 3)).astype(np.float32)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                        (240, 180))
    for t in range(n):
        w.write(np.clip(np.roll(base, (2 * t, t), axis=(0, 1)), 0, 255)
                .astype(np.uint8))
    w.release()


def area_frames(path) -> np.ndarray:
    """The clip's frames resized to KW's size with INTER_AREA (the port's
    ``resize_area``): what phaseCorrelate's steps translate."""
    import cv2
    cap, out = cv2.VideoCapture(str(path)), []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(resize_area(torch.from_numpy(f),
                               (KW["ydim"], KW["xdim"])).numpy())
    return np.stack(out)


@contextlib.contextmanager
def live_android():
    """MODES["android"] with its initial state's accumulator (this rank's
    ``modes.android_rows`` of ACC) and frame count (I0) replaced."""
    factory = MODES["android"]

    def make(cfg, device="cuda", mesh=None):
        init, step = factory(cfg, device, mesh=mesh)
        rows = common.space_rows(cfg, mesh)
        k0, k1 = modes.android_rows(rows, cfg.ydim) if rows \
            else (0, cfg.ydim)

        def init_live(first):
            state = init(first)
            return state._replace(
                accumulator=torch.from_numpy(ACC[k0:k1].copy()).to(
                    state.i.device),
                i=torch.tensor(I0, dtype=torch.int32,
                               device=state.i.device))
        return init_live, step

    MODES["android"] = make
    try:
        yield
    finally:
        MODES["android"] = factory


def _given_noise(noise):
    """stabilizeTPU's RANSAC noise: noise[framecount] (numpy, (steps, 64,
    256)) in place of the generator's draw."""
    return {(modes, "step_generator"): lambda seed, step, dev: step,
            (feature_stab, "gumbel_noise"): lambda g, trials, n, dev:
                torch.from_numpy(noise[g]).to(dev)}


def rest_run(mode: str, tag: str, clips, space: int = 1, noise=None):
    """run_videos(mode, clips) on the CPU (`space` ranks; the process
    group initialized for them): android from its live state, with
    ``_torch_space_dense.shared_flow`` in place of the engine when `tag`
    is "shared"; stabilizeTPU with `noise` (``_given_noise``) when `tag`
    is "jaxnoise"; without the frame pump when `tag` is "nopump". ->
    ({s<i>: the written frames}, every stream's last state,
    ``_torch_space_ranks.final_states``)."""
    kept = {}
    patches = {(io_video, "VideoWriter"): ranks.keeping_writer(kept)}
    if tag == "shared":
        patches[(android, "flow_stream_step")] = dense.shared_flow
        patches[(android, "flow_stream_init")] = dense.no_stream
    if tag == "jaxnoise":
        patches.update(_given_noise(noise))
    with contextlib.ExitStack() as stack:
        for (obj, name), fn in patches.items():
            stack.enter_context(dense._patched(obj, name, fn))
        if mode == "android":
            stack.enter_context(live_android())
        stats = multirunner.run_videos(
            mode, clips, "r", ModeConfig(**KW), chunk=CHUNK, space=space,
            progress=False, host_prep=tag != "nopump", device="cpu")
    frames = {pathlib.Path(p).stem[2:]: np.stack(f) for p, f in kept.items()}
    return frames, ranks.final_states(stats.state)


def runs(clips, big):
    """The 2-rank runs: (mode, tag, clips): android on the engine's flow
    (the first clip) and on the shared flow (both); phaseCorrelate and
    globalOrientation on both clips; stabilizeTPU with its own draws
    (the first clip) and with JAX's (both); android and phaseCorrelate
    on the 240x180 clip with the pump and without it."""
    return [("android", "flow", clips[:1]), ("android", "shared", clips),
            ("phaseCorrelate", "plain", clips),
            ("globalOrientation", "plain", clips),
            ("stabilizeTPU", "plain", clips[:1]),
            ("stabilizeTPU", "jaxnoise", clips)] + \
        [(m, t, [big]) for m in ("android", "phaseCorrelate")
         for t in ("pump", "nopump")]


def runs_k3(clips, big):
    """The 3-rank runs (bands of 40 rows): android on the engine's flow,
    phaseCorrelate on the 240x180 clip resized on the device."""
    return [("android", "flow", clips[:1]),
            ("phaseCorrelate", "nopump", [big])]


def rest_rank(rank: int, store: str, out: str, clips, big, noise,
              world: int = 2):
    """As rank `rank` of `world`, each of ``runs`` (``runs_k3`` when world
    is 3) with space=world; saves the frames rank 0 writes
    (<mode>_<tag>_frames.npz) and every stream's last state
    (<mode>_<tag>_state_<rank>.npz). Then, the group left, every
    world-th run (from the rank's index) with one process, its frames
    and state as <mode>_<tag>_one_frames.npz / _one_state.npz."""
    torch.set_num_threads(1)
    out = pathlib.Path(out)
    todo = runs(clips, big) if world == 2 else runs_k3(clips, big)
    distributed.init_cluster(f"file://{store}", world, rank)
    try:
        for mode, tag, videos in todo:
            frames, state = rest_run(mode, tag, videos, world, noise)
            if rank == 0:
                np.savez(out / f"{mode}_{tag}_frames.npz", **frames)
            np.savez(out / f"{mode}_{tag}_state_{rank}.npz", **state)
    finally:
        torch.distributed.destroy_process_group()
    for mode, tag, videos in todo[rank::world]:
        frames, state = rest_run(mode, tag, videos, noise=noise)
        np.savez(out / f"{mode}_{tag}_one_frames.npz", **frames)
        np.savez(out / f"{mode}_{tag}_one_state.npz", **state)


def band_state(state: dict, mode: str, rows, frame_h: int) -> dict:
    """The part of one process's last state (``final_states``) that a
    space rank holding frame rows `rows` keeps: android's accumulator
    over ``modes.android_rows``, phaseCorrelate's previous frame over its
    ROI's rows (``modes.roi_rows``), every other field whole."""
    if mode == "android":
        k0, k1 = modes.android_rows(rows, frame_h)
        cut = {"accumulator": lambda v: v[k0:k1]}
    elif mode == "phaseCorrelate":
        r0, r1 = modes.roi_rows(ModeConfig(**KW))
        cut = {"prev_resized": lambda v: v[r0:r1]}
    else:
        cut = {}
    return {k: cut.get(k.split("_", 1)[1], lambda v: v)(v)
            for k, v in state.items()}
