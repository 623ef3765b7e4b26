"""Carry state across from the JAX package, given as numpy arrays.

``convert`` takes numpy arrays only (it imports neither jax nor the JAX
package): a JAX state is turned into numpy on the caller's side with
``jax.tree.map(np.asarray, state)``. bfloat16 arrays (``ml_dtypes``) are
reinterpreted bit for bit, since ``torch.from_numpy`` does not take them.
With it a test starts both implementations from the same state, whatever
their random generators do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ripcurrents_tpu_torch.analysis.meanflow import (AverageVectorState,
                                                     RingMean)
from ripcurrents_tpu_torch.config import LKParams
from ripcurrents_tpu_torch.dynamics.advect import FieldState
from ripcurrents_tpu_torch.dynamics.particles import (PopulationState,
                                                      TimelineState)
from ripcurrents_tpu_torch.ops.hist import FlowHistogram
from ripcurrents_tpu_torch.pipelines.android import AndroidState
from ripcurrents_tpu_torch.pipelines.common import FlowStream
from ripcurrents_tpu_torch.pipelines.legacy import LegacyState
from ripcurrents_tpu_torch.pipelines.modes import (AverageVectorModeState,
                                                   BrightColorState,
                                                   GlobalOrientationState,
                                                   PhaseCorrelateState,
                                                   PopulationMapState,
                                                   RedPointsState,
                                                   ShearState,
                                                   StabilizeState,
                                                   StreaklinesState,
                                                   SubtractAverageState,
                                                   TimelinesState,
                                                   TimexState,
                                                   TrailsState,
                                                   WindowedState)


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A numpy array (bfloat16 included) -> tensor of the same dtype and
    shape (0-d included), copied."""
    a = np.array(a)                  # writable, C-contiguous, keeps 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def expansions_from_numpy(tables, device="cpu") -> tuple[torch.Tensor, ...]:
    """The JAX ``FlowStream.exp`` tables -> the port's tables, dtype kept:
    the fused engine's bf16 (5, Hp', Wp') tables, the portable engine's
    float32 (lh, lw, 5) ones."""
    return tuple(tensor_from_numpy(t, device) for t in tables)


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


def lk_params(p) -> LKParams:
    """Any LK parameter dataclass with the port's field names (the JAX
    package's ``LKParams``) -> the port's LKParams."""
    return LKParams(**{f.name: getattr(p, f.name)
                       for f in dataclasses.fields(LKParams)})


def timelines_state_from_numpy(state, device="cpu") -> TimelinesState:
    """A JAX ``timelines`` state mapped to numpy -> the port's state."""
    t = lambda a: tensor_from_numpy(a, device)  # noqa: E731
    return TimelinesState(t(state.prev_gray),
                          TimelineState(t(state.timeline.vertices)),
                          t(state.framecount))


def streaklines_state_from_numpy(state, device="cpu") -> StreaklinesState:
    """A JAX ``streaklines`` state mapped to numpy -> the port's state."""
    return StreaklinesState(*(tensor_from_numpy(a, device) for a in state))


def population_state_from_numpy(state, device="cpu") -> PopulationMapState:
    """A JAX ``populationMap`` state mapped to numpy -> the port's state."""
    t = lambda a: tensor_from_numpy(a, device)  # noqa: E731
    return PopulationMapState(t(state.prev_gray),
                              PopulationState(t(state.pop.vertices)),
                              t(state.framecount))


def red_points_state_from_numpy(state, device="cpu") -> RedPointsState:
    """A JAX ``flowRedPoints`` state mapped to numpy -> the port's state."""
    return RedPointsState(*(tensor_from_numpy(a, device) for a in state))


def _fstream(fs, device) -> FlowStream:
    return FlowStream(expansions_from_numpy(fs.exp, device))


def _ring(r, device) -> RingMean:
    return RingMean(*(tensor_from_numpy(a, device) for a in r))


def trails_state_from_numpy(state, device="cpu") -> TrailsState:
    """A JAX ``streamlines``, ``timelinesOnSubtractAverageVector`` or
    ``timelinesFarne`` state mapped to numpy -> the port's state."""
    t = lambda a: tensor_from_numpy(a, device)  # noqa: E731
    return TrailsState(_fstream(state.fstream, device), t(state.seeds),
                       t(state.overlay), t(state.framecount))


def subtract_average_state_from_numpy(state,
                                      device="cpu") -> SubtractAverageState:
    """A JAX ``subtructAverageVector`` state mapped to numpy -> the port's
    state."""
    t = lambda a: tensor_from_numpy(a, device)  # noqa: E731
    return SubtractAverageState(_fstream(state.fstream, device),
                                t(state.max_disp), t(state.framecount))


def windowed_state_from_numpy(state, device="cpu") -> WindowedState:
    """A JAX ``subtructAverageVectorWithWindow`` state mapped to numpy ->
    the port's state."""
    t = lambda a: tensor_from_numpy(a, device)  # noqa: E731
    return WindowedState(_fstream(state.fstream, device),
                         _ring(state.ring, device), t(state.max_disp),
                         t(state.framecount))


def shear_state_from_numpy(state, device="cpu") -> ShearState:
    """A JAX ``shearRate`` state mapped to numpy -> the port's state."""
    t = lambda a: tensor_from_numpy(a, device)  # noqa: E731
    return ShearState(_fstream(state.fstream, device),
                      _ring(state.ring, device), t(state.max_frob),
                      t(state.framecount))


def average_vector_state_from_numpy(state,
                                    device="cpu") -> AverageVectorModeState:
    """A JAX ``averageVector`` state mapped to numpy -> the port's
    state."""
    t = lambda a: tensor_from_numpy(a, device)  # noqa: E731
    return AverageVectorModeState(
        _fstream(state.fstream, device),
        AverageVectorState(_ring(state.av.ring, device),
                           t(state.av.max_displacement)),
        t(state.framecount))


def android_state_from_numpy(state, device="cpu") -> AndroidState:
    """A JAX ``AndroidState`` mapped to numpy -> the port's state."""
    t = lambda a: tensor_from_numpy(a, device)  # noqa: E731
    return AndroidState(_fstream(state.fstream, device), t(state.stable),
                        t(state.accumulator), t(state.hist),
                        t(state.histsum), t(state.i))


def average_hsv_state_from_numpy(state, device="cpu") -> RingMean:
    """A JAX ``averageHSV`` state (a ``RingMean``) mapped to numpy -> the
    port's state."""
    return _ring(state, device)


def timex_state_from_numpy(state, device="cpu") -> TimexState:
    """A JAX ``timex`` state mapped to numpy -> the port's state."""
    return TimexState(*(tensor_from_numpy(a, device) for a in state))


def bright_color_state_from_numpy(state, device="cpu") -> BrightColorState:
    """A JAX ``brightColor`` state mapped to numpy -> the port's state."""
    return BrightColorState(*(tensor_from_numpy(a, device) for a in state))


def phase_correlate_state_from_numpy(state,
                                     device="cpu") -> PhaseCorrelateState:
    """A JAX ``phaseCorrelate`` state mapped to numpy -> the port's
    state."""
    return PhaseCorrelateState(*(tensor_from_numpy(a, device)
                                 for a in state))


def global_orientation_state_from_numpy(
        state, device="cpu") -> GlobalOrientationState:
    """A JAX ``globalOrientation`` state mapped to numpy -> the port's
    state."""
    return GlobalOrientationState(*(tensor_from_numpy(a, device)
                                    for a in state))


def stabilize_state_from_numpy(state, device="cpu") -> StabilizeState:
    """A JAX ``stabilizeTPU`` state mapped to numpy -> the port's state:
    ``prev_gray`` and ``framecount``. JAX's PRNG key has no counterpart:
    the port's step seeds its generator from (cfg.seed, framecount)."""
    return StabilizeState(tensor_from_numpy(state.prev_gray, device),
                          tensor_from_numpy(state.framecount, device))


def state_to_numpy(state) -> dict:
    """The state of any ported mode (nested NamedTuples of tensors) -> a
    flat dict of numpy arrays keyed by field name (expansion tables as
    ``exp0``, ``exp1``, ... in float32), for comparison with the JAX
    state."""
    out = {}
    for name, v in zip(state._fields, state):
        if torch.is_tensor(v):
            out[name] = v.cpu().numpy()
        elif hasattr(v, "_fields"):
            out.update(state_to_numpy(v))
        else:
            out.update({f"{name}{i}": e.to(torch.float32).cpu().numpy()
                        for i, e in enumerate(v)})
    return out
