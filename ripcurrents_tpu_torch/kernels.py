"""Build and bind the hand-written Hopper kernels in ``csrc/``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``
(pointers from ``Tensor.data_ptr()``, the stream from
``torch.cuda.current_stream().cuda_stream``). A source that includes no
PyTorch header builds in seconds; ``torch.utils.cpp_extension.load`` would
recompile PyTorch's headers on every fresh machine, which takes minutes.

The build happens at first use, one ``nvcc`` per source, all started
together, into ``build/torch_kernels/`` beside the package (listed in
``.gitignore``). Libraries are named by a hash of their source and flags,
so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# source stem -> (C entry point, argtypes)
_ENTRIES = {
    "farneback_update": ("farneback_update_launch",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P]),
    "farneback_blur_solve": ("farneback_blur_solve_launch",
                             [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "lk_track": ("lk_track_launch",
                 [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                  _F, _F, _P]),
    "resize_cf_padded": ("resize_cf_padded_launch",
                         [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "prep_y": ("prep_y_launch", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "prep_x3": ("prep_x3_launch",
                [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I,
                 _P]),
    "warp5_shift": ("warp5_shift_launch", [_P, _P, _P, _I, _I, _I, _P]),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(stem: str) -> pathlib.Path:
    src = (CSRC / f"{stem}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{stem}-{digest[:16]}.so"


def build() -> dict[str, str]:
    """Compile every missing kernel library, all in parallel. Returns the
    compiler's report (ptxas registers, shared memory, spills) per source;
    raises with the compiler output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in _ENTRIES:
        out = _lib_path(stem)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[stem] = text
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (exit {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


@functools.lru_cache(maxsize=1)
def _libs() -> dict:
    build()
    fns = {}
    for stem, (name, argtypes) in _ENTRIES.items():
        lib = ctypes.CDLL(str(_lib_path(stem)))
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[stem] = (lib, fn)
    return fns


def entry(stem: str):
    """The loaded C launch function of one kernel (builds on first use)."""
    return _libs()[stem][1]


def launches_on(device: torch.device) -> bool:
    """True when a wrapper must launch its CUDA kernel on `device`, False
    for its plain version (CPU tensors only); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {device}")


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
