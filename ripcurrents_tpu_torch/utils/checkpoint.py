"""Checkpoint/resume for streaming pipelines.

The reference loses all temporal state on exit (accumulators, ring
buffers, advected particles live in process memory; SURVEY.md section 5).
Here every mode's state is an explicit tree of NamedTuples, tuples and
tensors, so a long stream run is resumable: the state is flattened with
``torch.utils._pytree`` to named numpy arrays and written with
``np.savez`` (inspectable with numpy alone; never pickled).

Layout (as the JAX package's): ``leaf_i`` per leaf, ``__treedef__`` (the
tree's structure as text) and ``__meta__`` (JSON), plus ``__leaves__``
(JSON: each leaf's kind and dtype). A bfloat16 tensor, which numpy cannot
hold, is stored as its raw 16-bit pattern, so a restore is bit-exact.
Leaves that are not tensors (Python numbers, None) are stored as 0-d
arrays and come back as the same Python type; any other leaf raises.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

_SCALARS = {"int": int, "float": float, "bool": bool}


def _kind(leaf) -> dict:
    if isinstance(leaf, torch.Tensor):
        return {"kind": "tensor",
                "dtype": str(leaf.dtype).removeprefix("torch.")}
    if leaf is None:
        return {"kind": "none"}
    for kind, typ in _SCALARS.items():
        if type(leaf) is typ:
            return {"kind": kind}
    raise TypeError(f"cannot checkpoint a state leaf of type "
                    f"{type(leaf).__name__}")


def _array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    return np.zeros((), np.uint8) if leaf is None else np.asarray(leaf)


def _path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state: Any, meta: dict | None = None) -> None:
    """Serialize a pipeline state tree to an .npz file.

    Written to a temp file and atomically renamed, so a run killed
    mid-checkpoint never leaves a truncated file for --resume."""
    leaves, spec = pytree.tree_flatten(state)
    specs = [_kind(leaf) for leaf in leaves]
    arrays = {f"leaf_{i}": _array(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(str(spec).encode(), dtype=np.uint8)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                       dtype=np.uint8)
    arrays["__leaves__"] = np.frombuffer(json.dumps(specs).encode(),
                                         dtype=np.uint8)
    final = _path(path)
    tmp = final + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, final)


def load_state(path: str, like: Any):
    """Restore a state tree saved by save_state. `like` (an example state
    from the mode's init) gives the structure, and each leaf's kind,
    dtype, shape and device; any mismatch raises ValueError. Tensors come
    back on the device of `like`'s leaf."""
    leaves, spec = pytree.tree_flatten(like)
    with np.load(_path(path), allow_pickle=False) as data:
        stored = bytes(data["__treedef__"]).decode()
        if stored != str(spec):
            raise ValueError("checkpoint structure mismatch:\n"
                             f"  checkpoint: {stored}\n  expected:   {spec}")
        specs = json.loads(bytes(data["__leaves__"]).decode())
        out = []
        for i, (leaf, s) in enumerate(zip(leaves, specs)):
            arr = data[f"leaf_{i}"]
            want = _kind(leaf)
            shape = tuple(leaf.shape) if want["kind"] == "tensor" else ()
            if s != want or arr.shape != shape:
                raise ValueError(
                    f"checkpoint leaf {i} mismatch: stored {s} "
                    f"{arr.shape}, expected {want} {shape}")
            if s["kind"] == "tensor":
                t = torch.from_numpy(arr)
                if s["dtype"] == "bfloat16":
                    t = t.view(torch.bfloat16)
                out.append(t.to(leaf.device))
            elif s["kind"] == "none":
                out.append(None)
            else:
                out.append(_SCALARS[s["kind"]](arr.item()))
    return pytree.tree_unflatten(out, spec)


def load_meta(path: str) -> dict:
    with np.load(_path(path), allow_pickle=False) as data:
        return json.loads(bytes(data["__meta__"]).decode())
