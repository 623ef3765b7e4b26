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

# Shared memory a Hopper block can take (with cudaFuncSetAttribute).
MAX_SHARED = 227 * 1024
# SMs of an H100 SXM (the host plans made off the card count these).
H100_SMS = 132
# Per-source -D defines: K2's block limit and x run, K4's block shape, and
# K5's and K6's tile sizes, which their host plans (flow/fused_update.py,
# ops/image.py, flow/prep_kernel.py) read from here.
DEFINES = {
    "farneback_blur_solve": {"BLUR_MAX_THREADS": 512, "BLUR_RUN": 4},
    "resize_cf_padded": {"RESIZE_WARPS": 4, "RESIZE_MIN_BLOCKS": 4},
    "prep_y": {"PREP_Y_WARPS": 8},
    "prep_x3": {"PREP_X_ROWS": 32, "PREP_X_WARPS": 8, "PREP_X_ZERO_ROWS": 4},
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# entry -> (source stem, C entry point, argtypes)
_ENTRIES = {
    "farneback_update": ("farneback_update", "farneback_update_launch",
                         [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _P]),
    "farneback_block_sums": ("farneback_update",
                             "farneback_block_sums_launch",
                             [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "farneback_update_active_clusters": ("farneback_update",
                                         "farneback_update_active_clusters",
                                         [_I]),
    "farneback_blur_solve": ("farneback_blur_solve",
                             "farneback_blur_solve_launch",
                             [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _P]),
    "lk_track": ("lk_track", "lk_track_launch",
                 [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                  _F, _F, _P]),
    "resize_cf_padded": ("resize_cf_padded", "resize_cf_padded_launch",
                         [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P]),
    "prep_y": ("prep_y", "prep_y_launch",
               [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                _P]),
    "prep_x3": ("prep_x3", "prep_x3_launch",
                [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                 _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _P]),
    "warp5_shift": ("warp5_shift", "warp5_shift_launch",
                    [_P, _P, _P, _I, _I, _I, _P]),
    "warp_tiles_halo": ("warp_tiles", "warp_tiles_halo_launch",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "warp_tiles_halo_nobase": ("warp_tiles", "warp_tiles_halo_nobase_launch",
                               [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _P]),
    "warp_tiles_frame": ("warp_tiles", "warp_tiles_frame_launch",
                         [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P]),
    "warp_tiles_active_clusters": ("warp_tiles",
                                   "warp_tiles_active_clusters", [_I, _I]),
}
_STEMS = tuple(dict.fromkeys(stem for stem, _, _ in _ENTRIES.values()))


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


def _flags(stem: str) -> list[str]:
    return [*NVCC_FLAGS,
            *(f"-D{k}={v}" for k, v in DEFINES.get(stem, {}).items())]


def _lib_path(stem: str) -> pathlib.Path:
    src = (CSRC / f"{stem}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(stem)).encode()).hexdigest()
    return BUILD_DIR / f"{stem}-{digest[:16]}.so"


def build() -> dict[str, str]:
    """Compile every missing kernel library, all in parallel. Returns the
    compiler's report (ptxas registers, shared memory, spills) per source;
    raises with the compiler output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in _STEMS:
        out = _lib_path(stem)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(stem), "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
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
    libs = {stem: ctypes.CDLL(str(_lib_path(stem))) for stem in _STEMS}
    fns = {}
    for key, (stem, name, argtypes) in _ENTRIES.items():
        fn = getattr(libs[stem], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[key] = (libs[stem], fn)
    return fns


def entry(name: str):
    """The loaded C launch function `name` of ``_ENTRIES`` (builds every
    kernel on first use)."""
    return _libs()[name][1]


def card_sms(device: torch.device) -> int:
    """The SMs of the card `device` lies on; H100_SMS for the CPU."""
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def active_clusters(name: str, largest: int, *args) -> dict:
    """{S: clusters of S CTAs the card holds at once} for S = 1, 2, 4,
    ..., `largest`, from the occupancy query `name` of ``_ENTRIES``
    (cudaOccupancyMaxActiveClusters; `args` follow S); raises when the
    query fails."""
    query = entry(name)
    out = {}
    for k in range(largest.bit_length()):
        got = query(1 << k, *args)
        if got < 0:
            raise RuntimeError(f"{name}: cluster occupancy query failed "
                               f"with CUDA error {-got}")
        out[1 << k] = got
    return out


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
