"""ctypes binding of the native frame pump (``native/framepump.cpp``).

The pump runs OpenCV-compatible fixed-point resize + grayscale on N host
threads with ordered delivery, replacing the reference's serial per-frame
prep (main.cpp:142-144) on the decode path. It needs no OpenCV.

The library is built from the source in the checkout with ``g++`` at
first use (``available()`` or ``FramePump``), with the flags of
``native/Makefile``, into ``build/framepump/`` beside the package, named
by a hash of the source, the flags and the host's CPU, so an edited
source is rebuilt and a library built for another CPU (``-march=native``)
is never loaded. It is loaded with ``ctypes.CDLL``, which releases the
GIL during each call: the pump's blocking push and pop overlap the
Python that dispatches the steps.
Without a C++ compiler there is no pump and the runner leaves the resize
to the mode's device prep.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "framepump.cpp"
BUILD_DIR = _ROOT / "build" / "framepump"
# native/Makefile's CXXFLAGS, plus -shared as its rule adds.
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
            "-Wall", "-shared")

_build_lock = threading.Lock()


def _cpu() -> bytes:
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        text = pathlib.Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.processor().encode()
    keep = [ln for ln in text.splitlines()
            if ln.startswith(("model name", "flags"))]
    return "\n".join(sorted(set(keep))).encode()


def lib_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()
                            + _cpu()).hexdigest()
    return BUILD_DIR / f"libframepump-{digest[:16]}.so"


def build() -> Optional[pathlib.Path]:
    """Compile the pump if its library is missing. Returns its path, or
    None where there is no source or no ``g++``; raises with the
    compiler's output when the compile fails."""
    cxx = shutil.which("g++")
    if not SOURCE.exists() or cxx is None:
        return None
    out = lib_path()
    with _build_lock:
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {SOURCE.name} failed (exit "
                                   f"{r.returncode}):\n{r.stderr}")
            os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def load_library() -> Optional[ctypes.CDLL]:
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.fp_create.restype = ctypes.c_void_p
    lib.fp_create.argtypes = [ctypes.c_int] * 6
    lib.fp_push.restype = ctypes.c_int
    lib.fp_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.fp_pop_batch.restype = ctypes.c_int
    lib.fp_pop_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int]
    lib.fp_close.restype = None
    lib.fp_close.argtypes = [ctypes.c_void_p]
    lib.fp_destroy.restype = None
    lib.fp_destroy.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """Build the pump on first call; whether its library loaded."""
    return load_library() is not None


class FramePump:
    """Ordered multithreaded resize+gray prep. push() raw frames, then
    pop_batch() prepared (resized BGR, gray) stacks."""

    def __init__(self, src_hw: tuple[int, int], dst_hw: tuple[int, int],
                 threads: int = 4, capacity: int = 32):
        lib = load_library()
        if lib is None:
            raise RuntimeError("the frame pump needs native/framepump.cpp "
                               "and a C++ compiler (g++)")
        self._lib = lib
        self.src_hw = tuple(src_hw)
        self.dst_hw = tuple(dst_hw)
        self._h = lib.fp_create(threads, src_hw[0], src_hw[1],
                                dst_hw[0], dst_hw[1], capacity)
        if not self._h:
            # a NULL handle passed back into fp_push would crash the
            # process instead of raising
            raise RuntimeError("fp_create failed (threads/allocation)")

    def push(self, frame_bgr_u8: np.ndarray):
        f = np.ascontiguousarray(frame_bgr_u8, dtype=np.uint8)
        if f.shape != (*self.src_hw, 3):
            raise ValueError(f"frame pump expects {(*self.src_hw, 3)} "
                             f"frames, got {f.shape}")
        if not self._lib.fp_push(self._h, f.ctypes.data):
            raise RuntimeError("frame pump closed")

    def pop_batch(self, batch: int):
        """Up to `batch` prepared frames in push order: (resized (n, H, W,
        3), gray (n, H, W)) uint8; n < batch only after close()."""
        dh, dw = self.dst_hw
        resized = np.empty((batch, dh, dw, 3), np.uint8)
        gray = np.empty((batch, dh, dw), np.uint8)
        n = self._lib.fp_pop_batch(self._h, resized.ctypes.data,
                                   gray.ctypes.data, batch)
        return resized[:n], gray[:n]

    def close(self):
        if self._h:
            self._lib.fp_close(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fp_destroy(self._h)
            self._h = None
