"""The port's CLI (``python -m ripcurrents_tpu_torch``, ``cli.py``) on the
CPU, against the JAX package's CLI.

Tolerances: the parser's flags, defaults and choices equal JAX's (plus
``--device``); ``_mode_config`` gives equal fields; ``circular_field``
equals JAX's; ``streamline`` over it (validate's 3500 Euler steps) within
STREAMLINE_PX of JAX's at every point: XLA rounds the bilinear sample's
sum differently from step 81 on, and the gap grows like a random walk of
float32 roundings (read: 3.4e-4 px at step 3500, 22 ULPs of a coordinate
near 200).
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripcurrents_tpu import cli as jcli
from ripcurrents_tpu.config import FarnebackParams as JaxFarnebackParams
from ripcurrents_tpu.dynamics import advect as jadvect
from ripcurrents_tpu.pipelines.common import fb_preset as jfb_preset
from ripcurrents_tpu_torch import cli
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.dynamics import advect
from ripcurrents_tpu_torch.pipelines.common import fb_preset

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
STREAMLINE_PX = 1e-3


@pytest.fixture()
def tiny_video(tmp_path, rng):
    path = str(tmp_path / "beach.mp4")
    h, w = 48, 64
    yy = np.mgrid[0:h, 0:w][0].astype(np.float32)
    base = rng.uniform(0, 255, (h, w)).astype(np.float32)
    wtr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    for t in range(6):
        wave = 60 * np.sin(2 * np.pi * (yy / 12.0 - t * 0.2))
        g = np.clip(base * 0.5 + wave + 60, 0, 255).astype(np.uint8)
        wtr.write(np.stack([g, g, g], -1))
    wtr.release()
    return path


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "ripcurrents_tpu_torch",
                           *args], capture_output=True, text=True,
                          timeout=600, cwd=cwd, env=env)


def test_cli_timelines_end_to_end(tiny_video, tmp_path, capsys):
    """`python -m ripcurrents_tpu_torch <clip> <out> --mode timelines
    --device cpu` writes the overlay video: 5 frames from 6 (the first
    seeds the state). Without --device on a machine with no card the CLI
    exits 2 with resolve_device's message and runs nothing."""
    out_stem = str(tmp_path / "out")
    r = _run([tiny_video, out_stem, "--mode", "timelines", "--xdim", "64",
              "--ydim", "48", "--chunk", "2", "--device", "cpu"], REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    cap = cv2.VideoCapture(out_stem + ".mp4")
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == 5
    if not torch.cuda.is_available():
        rc = cli.main([tiny_video, str(tmp_path / "nocard"), "--xdim", "64",
                       "--ydim", "48"])
        assert rc == 2
        assert "torch.cuda.is_available() is False" in capsys.readouterr().err
        assert not (tmp_path / "nocard.mp4").exists()


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs,
                     a.type, a.const)
            for a in parser._actions if a.dest != "help"}


def test_parser_and_mode_config_match_jax(capsys):
    """The port's parser has JAX's flags, names, defaults and choices, plus
    --device; _mode_config gives equal fields; --warp-residual clears
    warp_residual_hires in both fb_presets; --videos with a special mode,
    no input, and --mesh-space 2 on a world of one card all exit 2."""
    mine, theirs = _actions(cli.build_parser()), _actions(jcli.build_parser())
    assert mine.pop("device") == (("--device",), "cuda", ["cuda", "cpu"],
                                  None, None, None)
    assert mine == theirs
    for argv in ([], ["--lk-win", "21", "--lk-levels", "2", "--lk-iters",
                      "7", "--lk-eps", "0.5", "--thr-mid", "0.4"],
                 ["--xdim", "320", "--ydim", "240", "--warp-impl", "tiled",
                  "--warp-residual", "3", "--warp-subcol", "128",
                  "--stab-features", "akaze", "--hist-bins", "40"]):
        argv = ["in.mp4", *argv]
        a = dataclasses.asdict(cli._mode_config(
            cli.build_parser().parse_args(argv)))
        b = dataclasses.asdict(jcli._mode_config(
            jcli.build_parser().parse_args(argv)))
        assert a == b
        if "--warp-residual" in argv:
            cfg = cli._mode_config(cli.build_parser().parse_args(argv))
            jcfg = jcli._mode_config(jcli.build_parser().parse_args(argv))
            p = fb_preset(FarnebackParams.windowed(), cfg)
            jp = jfb_preset(JaxFarnebackParams.windowed(), jcfg)
            assert (p.warp_residual, p.warp_residual_hires,
                    p.warp_subcol, p.warp_impl) == (3, None, 128, "tiled")
            assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    for argv in (["in.mp4", "--videos", "a.mp4", "--mode", "validate"],
                 ["in.mp4", "--videos", "a.mp4", "b.mp4", "--mesh-space",
                  "2"], []):
        assert cli.main([*argv, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "--videos cannot be combined with --mode validate" in err
    assert "an input video is required" in err
    assert "--mesh-space 2 needs 1 <= K <= the 1 device(s)" in err


def test_validate_streamline_matches_jax(capsys):
    """streamline from (200, 200) through circular_field at 480x640, dt
    0.03, 3500 steps (validate_streamlines): every point within
    STREAMLINE_PX of JAX's, and `--mode validate` exits 0 with its drift
    line."""
    jflow = jadvect.circular_field(480, 640)
    flow = advect.circular_field(480, 640)
    np.testing.assert_array_equal(flow.numpy(), np.asarray(jflow))
    jres = jadvect.streamline(jnp.array([200.0, 200.0]), jflow, dt=0.03,
                              iterations=3500)
    res = advect.streamline(torch.tensor([200.0, 200.0]), flow, dt=0.03,
                            iterations=3500)
    assert res.points.shape == (3501, 2) and res.seg_valid.shape == (3500,)
    assert np.abs(res.points.numpy() - np.asarray(jres.points)).max() <= \
        STREAMLINE_PX
    np.testing.assert_array_equal(res.seg_valid.numpy(),
                                  np.asarray(jres.seg_valid))
    assert cli.main(["in.mp4", "--mode", "validate", "--device", "cpu"]) == 0
    assert "drift=" in capsys.readouterr().out


def test_cli_stabilize_dump_matches(tiny_video, tmp_path):
    """--mode stabilize --dump-matches writes the reference's per-frame
    keypoint-match debug images to match/ (main.cpp:1625-1637)."""
    r = _run([tiny_video, "--mode", "stabilize", "--xdim", "64", "--ydim",
              "48", "--max-frames", "3", "--dump-matches", "--no-output",
              "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "match").is_dir()
    for f in sorted((tmp_path / "match").glob("match_*.jpg")):
        img = cv2.imread(str(f))
        assert img is not None and img.size > 0
