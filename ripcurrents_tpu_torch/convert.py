"""Carry state across from the JAX package, given as numpy arrays.

``convert`` takes numpy arrays only (it imports neither jax nor the JAX
package): a JAX state is turned into numpy on the caller's side with
``jax.tree.map(np.asarray, state)``. bfloat16 arrays (``ml_dtypes``) are
reinterpreted bit for bit, since ``torch.from_numpy`` does not take them.
With it a test starts both implementations from the same state, whatever
their random generators do.
"""

from __future__ import annotations

import numpy as np
import torch

from ripcurrents_tpu_torch.dynamics.advect import FieldState
from ripcurrents_tpu_torch.ops.hist import FlowHistogram
from ripcurrents_tpu_torch.pipelines.common import FlowStream
from ripcurrents_tpu_torch.pipelines.legacy import LegacyState


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A numpy array (bfloat16 included) -> tensor of the same dtype and
    shape (0-d included), copied."""
    a = np.array(a)                  # writable, C-contiguous, keeps 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def expansions_from_numpy(tables, device="cpu") -> tuple[torch.Tensor, ...]:
    """The JAX ``FlowStream.exp`` tables (numpy float or bfloat16 arrays)
    -> the port's bf16 tables."""
    return tuple(tensor_from_numpy(t, device).to(torch.bfloat16)
                 for t in tables)


def legacy_state_from_numpy(state, device="cpu") -> LegacyState:
    """A JAX ``LegacyState`` mapped to numpy -> the port's LegacyState."""
    t = lambda a: tensor_from_numpy(a, device)  # noqa: E731
    return LegacyState(
        FlowStream(expansions_from_numpy(state.fstream.exp, device)),
        FieldState(t(state.field.disp), t(state.field.dist)),
        t(state.seeds),
        t(state.overlay),
        FlowHistogram(*(t(a) for a in state.hist)),
        t(state.upper),
        t(state.accumulator),
        t(state.framecount))


def legacy_state_to_numpy(state: LegacyState) -> dict:
    """The port's LegacyState -> a flat dict of numpy arrays (bf16 tables
    as float32), for comparison with the JAX state."""
    out = {f"exp{i}": e.to(torch.float32).cpu().numpy()
           for i, e in enumerate(state.fstream.exp)}
    out.update(disp=state.field.disp, dist=state.field.dist,
               seeds=state.seeds, overlay=state.overlay,
               hist=state.hist.hist, histsum=state.hist.histsum,
               hist2d=state.hist.hist2d, histsum2d=state.hist.histsum2d,
               upper=state.upper, accumulator=state.accumulator,
               framecount=state.framecount)
    return {k: v if isinstance(v, np.ndarray) else v.cpu().numpy()
            for k, v in out.items()}
