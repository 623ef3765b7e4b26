"""The space form of ``run_videos`` (``--mesh-space 2``: each frame's rows
split over 2 gloo ranks, ``pipelines/multirunner.py``) on the CPU,
against the port's one-process run and the JAX package's runner.

The ranks are spawned from ``tests/_torch_space_ranks.py`` and meet
through a file:// store under tmp_path; each join has its own timeout,
so a stuck rendezvous fails instead of hanging. Written frames are taken
before encoding (the writer is swapped for one that keeps them).

Tolerances:
- legacy (240x320 from 480x640 clips, bands of 120 rows, halo 64, the
  replicate-padded slabs) against the one-process run: the rip masks
  and the overlays equal on at least 99% of pixels (JAX's own bound for
  a sharded step, ``tests/test_multirunner.py``), each frame's flow
  within ``tests/test_spatial.py``'s bounds (interior median < 1e-4 px,
  mean < 0.01, share above 0.1 px < 1%, the 64 outermost rows of each
  edge mean < 0.1), the thresholds and histograms equal on both ranks;
- timelines against the one-process run: bit for bit;
- timelines against JAX's ``run_videos(..., space=2)`` on the clips of
  JAX's ``test_streams_with_space_sharding`` (160x120, chunk 4, the 8
  virtual CPU devices of ``tests/conftest.py``): fewer than 1% of values
  differ.
"""

import json

import cv2
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_space_ranks as ranks
from ripcurrents_tpu.pipelines import multirunner as jmulti
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu_torch import cli
from ripcurrents_tpu_torch.io import video as io_video
from ripcurrents_tpu_torch.pipelines import legacy, multirunner
from ripcurrents_tpu_torch.pipelines.common import ModeConfig

torch.set_num_threads(1)

JOIN_S = 240
EDGE = 64


def _start(tmp_path, *args):
    """videos_rank(rank, store, out, *args) on 2 spawned ranks."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ranks.videos_rank,
                         args=(r, str(tmp_path / "store"), str(tmp_path),
                               *args)) for r in range(2)]
    for p in procs:
        p.start()
    return ctx, procs


def _spawn(tmp_path, *args):
    """_start, then _join."""
    _join(_start(tmp_path, *args)[1])


def _join(procs):
    """Raise unless every rank exits 0 within JOIN_S each; kill any
    left."""
    try:
        for p in procs:
            p.join(JOIN_S)
            assert not p.is_alive(), "a rank did not finish in time"
            assert p.exitcode == 0, f"a rank exited {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def _write_clip(path, n, shift, size=(160, 120), seed=0):
    """JAX's tests/test_multirunner.py clip: noise rolled `shift` px a
    frame."""
    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                        size)
    base = rng.uniform(0, 255, (size[1], size[0], 3)).astype(np.float32)
    for t in range(n):
        w.write(np.clip(np.roll(base, shift * t, axis=1), 0, 255)
                .astype(np.uint8))
    w.release()


def _wave_frame(t, h=480, w=640, seed=0):
    """Frame t of a moving-texture clip with wave bands: smoothed noise
    drifting 1 px a frame to the right, and bright bands travelling down
    over the top half (fast flow there, slow below)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    k = np.ones(7) / 7
    for ax in (0, 1):
        base = np.apply_along_axis(lambda m: np.convolve(m, k, "same"), ax,
                                   base)
    yy = np.mgrid[0:h, 0:w][0][..., None].astype(np.float32)
    wave = 50 * np.sin(2 * np.pi * (yy - 6 * t) / 40) * (yy < h / 2)
    return np.clip(np.roll(base, t, axis=1) * 0.8 + wave + 25, 0,
                   255).astype(np.uint8)


def _write_waves(path, n):
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                          (640, 480))
    for t in range(n):
        out.write(_wave_frame(t))
    out.release()


def legacy_pump() -> bool:
    """Whether the frame pump builds here (run_videos then makes the
    bands on it)."""
    from ripcurrents_tpu_torch.io import native
    return native.available()


def _one_process(monkeypatch, mode, clips, cfg, chunk):
    """The port's run_videos with one process: {stream: frames}."""
    got = {}
    monkeypatch.setattr(io_video, "VideoWriter", ranks.keeping_writer(got))
    multirunner.run_videos(mode, clips, "ns", cfg, chunk=chunk,
                           progress=False, device="cpu")
    return {p.replace("ns_", ""): np.stack(f) for p, f in got.items()}


def test_legacy_two_ranks_match_one_process(tmp_path, monkeypatch):
    """legacy over 2 ranks (240x320 from 480x640, bands of 120 rows, halo
    64) against one process: run_videos of a 4-frame clip (the pump's
    band), then 6 steps of in-memory frames, fed as each band's source
    rows, from a live state (a seeded duty accumulator at frame 35, so
    the rip mask and its edges are live): masks, overlays, every flow,
    the thresholds of both ranks, the metrics."""
    clip = str(tmp_path / "waves.mp4")
    _write_waves(clip, 4)
    kw = dict(xdim=320, ydim=240, total_frames=40)
    rng = np.random.default_rng(7)
    frames = np.stack([_wave_frame(t) for t in range(7)])
    live = (frames, rng.integers(0, 8, (240, 320)).astype(np.float32), 35)
    ctx, procs = _start(tmp_path, "legacy", [clip], kw, 4, live)
    want = ranks.live_legacy(ModeConfig(**kw), *live)
    ref = _one_process(monkeypatch, "legacy", [clip], ModeConfig(**kw), 4)
    _join(procs)
    got = np.load(tmp_path / "sp_s0.npy")
    assert got.shape == ref["s0.mp4"].shape == (3, 240, 320, 3)
    assert np.mean(got != ref["s0.mp4"]) < 0.01
    parts = [np.load(tmp_path / f"live_{r}.npz") for r in range(2)]
    assert parts[0]["upper"] == parts[1]["upper"]
    assert np.array_equal(parts[0]["hist"], parts[1]["hist"])
    for key in ("masks", "overlays"):
        both = np.concatenate([q[key] for q in parts], axis=1)
        assert both.shape == want[key].shape
        assert np.mean(both == want[key]) >= 0.99, key
    assert 0.05 < np.mean(want["masks"] == 255) < 0.95
    flows = np.concatenate([q["flows"] for q in parts], axis=1)
    assert flows.shape == want["flows"].shape == (6, 240, 320, 2)
    for g, w in zip(flows, want["flows"]):
        d = np.sqrt(((g - w) ** 2).sum(-1))
        di = d[EDGE:-EDGE]
        assert np.median(di) < 1e-4 and di.mean() < 0.01 and \
            (di > 0.1).mean() < 0.01, (np.median(di), di.mean())
        assert np.concatenate([d[:EDGE], d[-EDGE:]]).mean() < 0.1
    m = json.loads((tmp_path / "sp.json").read_text())
    assert m["mesh"] == {"stream": 1, "space": 2}
    assert m["space"]["backend"] == "gloo" and m["space"]["halo"] == 64
    assert m["native_host_prep"] == legacy_pump()
    assert m["space"]["band_rows"] == 120 and len(m["space"]["ranks"]) == 2
    assert all(r["exchange_bytes_per_frame"] > 0
               for r in m["space"]["ranks"])


@pytest.fixture(scope="module")
def timelines_two_ranks(tmp_path_factory):
    """JAX's space-test clips through the port's run_videos on 2 ranks."""
    tmp = tmp_path_factory.mktemp("tl")
    clips = [str(tmp / "a.mp4"), str(tmp / "b.mp4")]
    _write_clip(clips[0], 5, shift=1, seed=3)
    _write_clip(clips[1], 5, shift=2, seed=4)
    _spawn(tmp, "timelines", clips, dict(xdim=160, ydim=120), 4)
    return tmp, clips


def test_timelines_two_ranks_equal_one_process(timelines_two_ranks,
                                               monkeypatch):
    """Both streams' frames over 2 ranks equal the one-process run's bit
    for bit; the two streams share the ranks' one stream group."""
    tmp, clips = timelines_two_ranks
    want = _one_process(monkeypatch, "timelines", clips,
                        ModeConfig(xdim=160, ydim=120), 4)
    for i in (0, 1):
        got = np.load(tmp / f"sp_s{i}.npy")
        assert got.shape == (4, 120, 160, 3)
        assert np.array_equal(got, want[f"s{i}.mp4"]), i
    m = json.loads((tmp / "sp.json").read_text())
    assert m["streams"] == 2 and m["space"]["streams"] == ["s0", "s1"]
    assert m["space"]["backend"] == "gloo" and m["space"]["halo"] is None
    assert m["space"]["band_rows"] == 60 and m["frames_total"] == 8
    assert json.loads((tmp / "frames_1.json").read_text()) == 8


def test_timelines_two_ranks_match_jax(timelines_two_ranks, monkeypatch):
    """The port's 2-rank run against JAX's run_videos(space=2) of the same
    clips on the 8 virtual devices."""
    tmp, clips = timelines_two_ranks
    want = {}
    monkeypatch.setattr(jmulti, "VideoWriter", ranks.keeping_writer(want))
    jmulti.run_videos("timelines", clips, "jx", JaxModeConfig(xdim=160,
                                                              ydim=120),
                      chunk=4, space=2, progress=False)
    for i in (0, 1):
        got, jax_frames = np.load(tmp / f"sp_s{i}.npy"), \
            np.stack(want[f"jx_s{i}.mp4"])
        assert got.shape == jax_frames.shape
        assert np.mean(got != jax_frames) < 0.01, i


def test_mesh_space_refuses_modes_without_space_form(capsys):
    """Every registered mode has a space form: --mesh-space 2 with the
    farm's flags and --videos is refused for none of them. It still exits
    2 before any work without --videos, with a special mode, and with a K
    that does not divide the frame height."""
    farm = ["--coordinator", "127.0.0.1:1", "--num-processes", "2",
            "--process-id", "0", "--mesh-space", "2", "--device", "cpu"]
    parser = cli.build_parser()
    for mode in sorted(multirunner.MODES):
        assert cli._refuse(parser.parse_args(
            ["--videos", "a.mp4", "--mode", mode, *farm])) is None, mode
    assert len(multirunner.MODES) == 19
    assert cli.main(["a.mp4", "--mode", "legacy", *farm]) == 2
    assert "--mesh-space 2 needs --videos" in capsys.readouterr().err
    assert cli.main(["--videos", "a.mp4", "--mode", "stabilize",
                     *farm]) == 2
    assert "--videos cannot be combined with --mode stabilize" in \
        capsys.readouterr().err
    odd = [x if x != "2" or i != farm.index("--mesh-space") + 1 else "7"
           for i, x in enumerate(farm)]
    odd[farm.index("--num-processes") + 1] = "7"
    assert cli.main(["--videos", "a.mp4", "--mode", "android", *odd]) == 2
    assert "--mesh-space 7 does not divide the frame height 480" in \
        capsys.readouterr().err
