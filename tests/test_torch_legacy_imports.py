"""``make_legacy`` on the card by default, and every port module
importing without jax.

Inputs and tolerances: ``tests/_torch_legacy.py``.
"""

import pathlib
import subprocess
import sys

import pytest
import torch

from ripcurrents_tpu_torch.pipelines.common import ModeConfig
from ripcurrents_tpu_torch.pipelines.legacy import make_legacy


def test_make_legacy_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError):
        make_legacy(ModeConfig())


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports with jax and
    the JAX package blocked (None in sys.modules makes their import
    raise)."""
    code = (
        "import sys, pkgutil, importlib, importlib.util\n"
        "for name in ('jax', 'jaxlib', 'ripcurrents_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import ripcurrents_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'ripcurrents_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(' '.join(mods))\n")
    repo = pathlib.Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=repo)
    assert r.returncode == 0, r.stderr
    mods = set(r.stdout.split())
    assert len(mods) >= 35
    assert {f"ripcurrents_tpu_torch.{m}" for m in (
        "flow.prep_kernel", "flow.warp_kernel", "analysis.meanflow",
        "analysis.shear", "viz.color", "viz.draw", "pipelines.modes",
        "convert", "trace_legacy", "bench_warp", "parallel.mesh",
        "parallel.spatial", "parallel.distributed",
        "pipelines.multirunner", "flow.fused_update", "flow.farneback",
        "kernels", "ops.image", "ops.hist", "ops.morphology",
        "dynamics.advect", "pipelines.common", "pipelines.legacy",
        "pipelines.runner", "cli")} <= mods


def test_chip_smoke_detail_calls_bind():
    """Every call of chip_smoke.py's ``say`` and ``summary`` binds to
    their signatures (a stray ``flush=`` would raise TypeError in a
    profiler fallback, on the card only), and ``say`` writes a
    fallback's text to the details file while ``main()`` runs."""
    import ast
    import importlib.util
    import inspect
    import io

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_calls", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sigs = {f: inspect.signature(getattr(smoke, f))
            for f in ("say", "summary")}
    calls = [n for n in ast.walk(ast.parse(path.read_text()))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
             and n.func.id in sigs]
    assert len(calls) > 50
    for n in calls:
        sigs[n.func.id].bind(*[None] * len(n.args),
                             **{k.arg: None for k in n.keywords})
    details = io.StringIO()
    smoke._DETAILS.append(details)
    try:
        smoke.say("    torch.profiler recorded no device time in 3 "
                  "sessions; timed by CUDA events around the calls instead")
    finally:
        smoke._DETAILS.clear()
    assert "timed by CUDA events" in details.getvalue()
