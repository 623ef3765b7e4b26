"""Checkpoint/resume of the port (``utils/checkpoint.py`` and
``run_video``'s checkpoint_every / resume) on the CPU, and the import
guard of the host-rim modules.

Every comparison is exact: a restored state equals the saved one bit for
bit (bfloat16 tables through their 16-bit patterns), and stepping it
gives the frames of the uninterrupted run.
"""

import os
import pathlib
import subprocess
import sys
from typing import NamedTuple

import cv2
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from ripcurrents_tpu_torch.pipelines.common import MODES, ModeConfig
from ripcurrents_tpu_torch.pipelines import modes as _modes  # noqa: F401
from ripcurrents_tpu_torch.pipelines.runner import run_video
from ripcurrents_tpu_torch.utils.checkpoint import (load_meta, load_state,
                                                    save_state)

torch.set_num_threads(1)

CFG = ModeConfig(xdim=96, ydim=64, total_frames=8, window_size=3,
                 timeline_vertices=8)
REPO = pathlib.Path(__file__).resolve().parents[1]


class Mixed(NamedTuple):
    table: torch.Tensor
    canvas: "torch.Tensor | None"
    count: int
    scale: float
    live: bool
    levels: tuple


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _equal(a, b) -> bool:
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    if str(sa) != str(sb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype and
                    torch.equal(_bits(x), _bits(y))):
                return False
        elif type(x) is not type(y) or x != y:
            return False
    return True


def test_checkpoint_roundtrip_resumes_identically(tmp_path, beach_frames):
    """The fused-engine windowed mode's state (its expansion tables are
    bfloat16) after 3 steps, saved and restored into a fresh init's state:
    bit-equal leaves, and 4 more steps give equal frames. A state with
    None, Python numbers and a tuple of tables round-trips too."""
    init, step = MODES["subtructAverageVectorWithWindow"](CFG, device="cpu")
    state = init(beach_frames[0])
    assert any(getattr(x, "dtype", None) == torch.bfloat16
               for x in pytree.tree_leaves(state))
    for f in beach_frames[1:4]:
        state, _ = step(state, f)
    path = str(tmp_path / "ckpt.npz")
    save_state(path, state, meta={"frame": 3})
    restored = load_state(path, init(beach_frames[0]))
    assert load_meta(path) == {"frame": 3}
    assert _equal(restored, state)
    s1, s2 = state, restored
    for f in beach_frames[4:]:
        s1, o1 = step(s1, f)
        s2, o2 = step(s2, f)
        assert torch.equal(o1, o2)

    g = torch.Generator().manual_seed(0)
    mixed = Mixed(torch.randn((3, 5), generator=g).to(torch.bfloat16), None,
                  7, 0.25, True, (torch.arange(4, dtype=torch.int32),
                                  torch.ones((2, 2), dtype=torch.bool)))
    save_state(str(tmp_path / "mixed"), mixed)
    like = Mixed(torch.zeros((3, 5), dtype=torch.bfloat16), None, 0, 0.0,
                 False, (torch.zeros(4, dtype=torch.int32),
                         torch.zeros((2, 2), dtype=torch.bool)))
    assert _equal(load_state(str(tmp_path / "mixed.npz"), like), mixed)


def test_checkpoint_mismatch_rejected(tmp_path, beach_frames):
    """Another mode's state (structure), another frame size (shape) and a
    leaf of another dtype or kind are rejected with ValueError."""
    init1, _ = MODES["subtructAverageVectorWithWindow"](CFG, device="cpu")
    init2, _ = MODES["timex"](CFG, device="cpu")
    bigger, _ = MODES["subtructAverageVectorWithWindow"](
        ModeConfig(xdim=128, ydim=96, total_frames=8, window_size=3),
        device="cpu")
    s1 = init1(beach_frames[0])
    path = str(tmp_path / "ckpt.npz")
    save_state(path, s1)
    for like in (init2(beach_frames[0]), bigger(beach_frames[0]),
                 s1._replace(framecount=s1.framecount.to(torch.int64)),
                 s1._replace(framecount=3)):
        with pytest.raises(ValueError):
            load_state(path, like)


def test_run_video_kill_and_resume_bit_identical(tmp_path, beach_frames):
    """run_video with checkpoint_every / resume: a run cut at 4 frames and
    resumed from its checkpoint writes exactly the frames of the
    uninterrupted run (MJPG .avi: intra-only, so decoded frames compare)."""
    src = str(tmp_path / "clip.avi")
    wr = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 30, (160, 120))
    for f in beach_frames:
        wr.write(f)
    wr.release()
    kw = dict(chunk=2, progress=False, host_prep=False, device="cpu")
    mode = "subtructAverageVectorWithWindow"
    full = str(tmp_path / "full.avi")
    run_video(mode, src, full, CFG, **kw)
    ckpt = str(tmp_path / "state.ckpt")
    part1 = str(tmp_path / "part1.avi")
    run_video(mode, src, part1, CFG, max_frames=4, checkpoint_every=2,
              checkpoint_path=ckpt, **kw)
    assert load_meta(ckpt + ".npz") == {"processed": 4, "mode": mode}
    part2 = str(tmp_path / "part2.avi")
    run_video(mode, src, part2, CFG, resume=ckpt + ".npz", **kw)

    def decode(p):
        cap = cv2.VideoCapture(p)
        out = []
        while True:
            ok, f = cap.read()
            if not ok:
                return np.stack(out)
            out.append(f)

    want = decode(full)
    got = np.concatenate([decode(part1), decode(part2)])
    assert len(want) == 7
    np.testing.assert_array_equal(want, got)


def test_host_rim_imports_without_cv2_or_jax():
    """The runner, video I/O, pump binding, checkpoint, profiling, advect
    and CLI modules import with jax, the JAX package and cv2 blocked (as
    on the card's machine, which has no OpenCV); the reader raises there,
    and the CLI's validate mode runs."""
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'ripcurrents_tpu', 'cv2'):\n"
        "    sys.modules[name] = None\n"
        "for m in ('pipelines.runner', 'io.video', 'io.native', "
        "'utils.checkpoint', 'utils.profiling', 'dynamics.advect', 'cli', "
        "'__main__'):\n"
        "    importlib.import_module('ripcurrents_tpu_torch.' + m)\n"
        "from ripcurrents_tpu_torch.io import video\n"
        "try:\n"
        "    video.VideoReader('x.mp4')\n"
        "    raise SystemExit('VideoReader opened without cv2')\n"
        "except RuntimeError:\n"
        "    pass\n"
        "from ripcurrents_tpu_torch import cli\n"
        "raise SystemExit(cli.main(['x.mp4', '--mode', 'validate', "
        "'--device', 'cpu']))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "drift=" in r.stdout
