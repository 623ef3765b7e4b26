"""The port's parallel/ layer (mesh.py, spatial.py, distributed.py) on the
CPU, against the JAX package's.

The multi-rank tests spawn 2 gloo ranks (``tests/_torch_parallel_ranks.py``)
that meet through a file:// store under tmp_path (no TCP port to race
for under xdist); each join has its own timeout, so a stuck rendezvous
fails instead of hanging.

JAX's reference for ``farneback_spatial`` is JAX's own slab exchange
(``spatial._clamped_slab`` / ``_exchange_halo`` in a shard_map over
``make_mesh(2, space=2)`` of the 8 virtual devices) followed by JAX's
``farneback`` on each slab and the crop, which is what JAX's
``farneback_spatial`` runs per shard. Calling JAX's ``farneback_spatial``
whole compiles the engine inside shard_map, 150-290 s a call on this CPU.
JAX's engine runs on the TPU's blocked bf16 prep (``_pallas_ok`` True,
as ``tests/test_torch_tiled.py`` runs it), which the port implements.

Tolerances: the port's spatial flow against JAX's, the port's tiled
engine against JAX's (``tests/test_torch_tiled.py``): median <= 1e-3 px,
>= 99% of pixels within 0.05 px. Against the port's single-process
``farneback``: ``tests/test_spatial.py``'s bounds (interior median < 1e-4
px, mean < 0.01, share above 0.1 px < 1%, border mean < 0.1).
``global_flow_stats`` rtol 1e-6 (``tests/test_ops_misc.py``); the farm's
fps sum exact (values exact in float32).
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

import _torch_parallel_ranks as ranks
from ripcurrents_tpu.config import FarnebackParams as JaxFarnebackParams
from ripcurrents_tpu.parallel import distributed as jdist
from ripcurrents_tpu.parallel import mesh as jmesh
from ripcurrents_tpu.parallel import spatial as jspatial
from ripcurrents_tpu.pipelines.common import ModeConfig as JaxModeConfig
from ripcurrents_tpu.pipelines.legacy import make_legacy as jmake_legacy
from ripcurrents_tpu_torch import convert
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow.farneback import _stack, farneback
from ripcurrents_tpu_torch.parallel import distributed, mesh, spatial
from ripcurrents_tpu_torch.pipelines.common import ModeConfig
from ripcurrents_tpu_torch.pipelines.legacy import make_legacy

jfb = importlib.import_module("ripcurrents_tpu.flow.farneback")

torch.set_num_threads(1)

JOIN_S = 120
H, W = 256, 128
PRESET = dict(levels=1, warp_impl="tiled")     # windowed(), tiled engine
# halo -> (frame rows, clamped slab). Both cases give 256-row slabs
# (band + 2 * halo), so JAX's per-slab farneback compiles once: halo 64
# on 256 rows takes the clamped slab (2 * halo <= band), halo 80 on the
# top 192 rows the replicate-padded one.
HALOS = {64: (256, True), 80: (192, False)}


def _spawn(target, tmp_path, *args):
    """Run target(rank, store, out, *args) on 2 spawned ranks; raise
    unless both exit 0 within JOIN_S each."""
    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=target,
                         args=(r, store, str(tmp_path), *args))
             for r in range(2)]
    for p in procs:
        p.start()
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


def _frames(rng, h, w):
    """tests/test_spatial.py's clip: smoothed texture drifting 1 px with
    a vertical wave."""
    yy = np.mgrid[0:h, 0:w][0].astype(np.float32)
    base = rng.uniform(0, 255, (h, w)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (0, 1):
        base = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), ax, base)

    def make(t):
        wave = 60 * np.sin(2 * np.pi * (yy / 24.0 - t * 0.11)) * (yy / h)
        return np.clip(np.roll(base, t, axis=1) * 0.7 + wave + 60,
                       0, 255).astype(np.uint8)
    return make(0), make(1)


def _jax_flow(monkeypatch):
    """JAX's farneback at PRESET on its TPU prep path, jitted once."""
    p = dataclasses.replace(JaxFarnebackParams.windowed(), **PRESET)
    monkeypatch.setattr(jfb, "_pallas_ok",
                        functools.lru_cache(maxsize=1)(lambda: True))
    return jax.jit(lambda a, b: jfb.farneback(a, b, p))


def _jax_spatial(f0, f1, halo, clamped, flow):
    """JAX's farneback_spatial on make_mesh(2, space=2), per shard: its
    slab exchange in a shard_map, then `flow` (_jax_flow) on each slab."""
    m = jmesh.make_mesh(2, space=2)
    band = f0.shape[0] // 2

    @functools.partial(jax.shard_map, mesh=m, in_specs=P("space"),
                       out_specs=(P("space"), P("space")), check_vma=False)
    def slabs(x):
        x = x.astype(jnp.float32)
        if clamped:
            s, keep0 = jspatial._clamped_slab(x, halo, "space")
        else:
            s, keep0 = jspatial._exchange_halo(x, halo, "space"), halo
        return s, jnp.reshape(keep0, (1,))

    (sa, keep), (sb, _) = slabs(jnp.asarray(f0)), slabs(jnp.asarray(f1))
    n = sa.shape[0] // 2
    return np.concatenate([
        np.asarray(flow(sa[i * n:(i + 1) * n], sb[i * n:(i + 1) * n]))[
            int(keep[i]):int(keep[i]) + band] for i in range(2)])


def _within(got, want, median, share_px=None, share=None):
    d = np.sqrt(((got - want) ** 2).sum(-1))
    return d, np.median(d) <= median and (
        share_px is None or (d <= share_px).mean() >= share)


def test_spatial_two_ranks_match_jax_and_single(tmp_path, rng,
                                                monkeypatch):
    """farneback_spatial on 2 gloo ranks (windowed() at levels=1 on the
    tiled engine): halo 64 on 256x128 frames takes the clamped slabs,
    halo 80 on their top 192 rows the replicate-padded ones. Each against
    JAX's; the clamped one also against the port's single-process
    farneback."""
    f0, f1 = _frames(rng, H, W)
    cases = [((f0[:h], f1[:h]), halo) for halo, (h, _) in HALOS.items()]
    p = dataclasses.replace(FarnebackParams.windowed(), **PRESET)
    _spawn(ranks.spatial_rank, tmp_path, cases, p)
    flow = _jax_flow(monkeypatch)
    for halo, (h, clamped) in HALOS.items():
        got = np.concatenate([np.load(tmp_path / f"flow{halo}_{r}.npy")
                              for r in range(2)])
        assert got.shape == (h, W, 2) and np.isfinite(got).all()
        d, ok = _within(got, _jax_spatial(f0[:h], f1[:h], halo, clamped,
                                          flow), 1e-3, 0.05, 0.99)
        assert ok, (halo, np.median(d), (d <= 0.05).mean())
    got = np.concatenate([np.load(tmp_path / f"flow64_{r}.npy")
                          for r in range(2)])
    want = farneback(torch.from_numpy(f0), torch.from_numpy(f1), p).numpy()
    d = np.sqrt(((got - want) ** 2).sum(-1))
    di = d[64:-64]
    assert np.median(di) < 1e-4, np.median(di)
    assert di.mean() < 0.01, di.mean()
    assert (di > 0.1).mean() < 0.01, (di > 0.1).mean()
    assert np.concatenate([d[:64], d[-64:]]).mean() < 0.1


def test_cluster_two_ranks_match_jax(tmp_path, rng):
    """init_cluster, global_stream_mesh, local_stream_slice,
    all_streams_fps and global_flow_stats on 2 ranks: the ranks' slices
    tile the stream axis as JAX's one process's slice tiles its own, the
    fps sum equals JAX's all_streams_fps of the sum, and the global mean
    |flow| of the two halves equals JAX's global_flow_stats of the
    whole."""
    flow = rng.normal(size=(4, 8, 10, 2)).astype(np.float32)
    fps = (31.25, 17.5)
    _spawn(ranks.cluster_rank, tmp_path, flow, fps)
    got = [np.load(tmp_path / f"cluster_{r}.npy") for r in range(2)]
    jm = jdist.global_stream_mesh(1)
    js = jdist.local_stream_slice(jm)
    assert (js.start, js.stop) == (0, jm.shape["stream"])
    want_stats = float(jmesh.global_flow_stats(jnp.asarray(flow)))
    want_fps = jdist.all_streams_fps(sum(fps))
    for r, g in enumerate(got):
        stream, space, start, stop, total, stats = g
        assert (stream, space) == (2, 1)
        assert (start, stop) == (r, r + 1)
        assert total == want_fps == sum(fps)
        np.testing.assert_allclose(stats, want_stats, rtol=1e-6)


def test_multi_stream_step_and_spatial_guards(rng, monkeypatch):
    """In one process: multi_stream_init / multi_stream_step of the legacy
    step (4 streams of 80x120 at 96x64, tests/test_parallel.py's shapes,
    tiled engine in both packages) against JAX's on the 8-device mesh,
    from JAX's init states past the warmup with a live accumulator;
    identical streams give identical outputs; the world of 1 (no process
    group); farneback_spatial on a space axis of 1 equals farneback; the
    halo, divisibility and backend errors."""
    kw = dict(xdim=96, ydim=64, total_frames=8, legacy_seeds=8,
              warp_impl="tiled")
    monkeypatch.setattr(jfb, "_pallas_ok",
                        functools.lru_cache(maxsize=1)(lambda: True))
    jinit, jstep = jmake_legacy(JaxModeConfig(**kw))
    init, step = make_legacy(ModeConfig(**kw), device="cpu")
    jm = jmesh.make_mesh(8)
    n = jm.shape["stream"]
    raw = rng.integers(0, 255, (n, 80, 120, 3), np.uint8)
    frames = rng.integers(0, 255, (n, 80, 120, 3), np.uint8)
    acc = rng.integers(0, 9, (n, 64, 96)).astype(np.float32)
    js = jax.tree.map(np.asarray, jmesh.multi_stream_init(jinit)(
        jnp.asarray(raw)))
    js = js._replace(accumulator=acc,
                     framecount=np.full((n,), 35, np.int32))
    with jm:
        _, jo = jax.jit(jmesh.multi_stream_step(jstep))(
            jax.tree.map(jnp.asarray, js), jmesh.shard_streams(
                jm, jnp.asarray(frames)))
        jo = jax.tree.map(np.asarray, jo)
    states = [convert.legacy_state_from_numpy(
        jax.tree.map(lambda a, i=i: a[i], js)) for i in range(n)]
    news, outs = mesh.multi_stream_step(step)(_stack(states),
                                              torch.from_numpy(frames))
    assert outs.overlay_bgr.shape == (n, 64, 96, 3)
    assert int(news.framecount[0]) == 36
    for i in range(n):
        _, one = step(states[i], torch.from_numpy(frames[i]))
        for field, a in one._asdict().items():
            assert torch.equal(getattr(outs, field)[i], a), field
        a, b = outs.mask[i].numpy() > 0, jo.mask[i] > 0
        assert (a | b).any() and (a & b).sum() / (a | b).sum() >= 0.995
        assert (outs.overlay_bgr[i].numpy() != jo.overlay_bgr[i]).any(
            -1).mean() <= 0.001

    same = torch.from_numpy(np.stack([raw[0]] * 2))
    st = mesh.multi_stream_init(init)(same)
    _, o = mesh.multi_stream_step(step)(st, same)
    assert torch.equal(o.overlay_bgr[0], o.overlay_bgr[1])

    assert distributed.init_cluster() is None
    assert mesh.world() == (1, 0)
    one = distributed.global_stream_mesh()
    assert one.shape == {"stream": 1, "space": 1}
    assert distributed.local_stream_slice(one) == slice(0, 1)
    assert distributed.all_streams_fps(12.5) == 12.5
    flow = rng.normal(size=(3, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(
        float(mesh.global_flow_stats(torch.from_numpy(flow))),
        float(jmesh.global_flow_stats(jnp.asarray(flow))), rtol=1e-6)

    f0, f1 = _frames(rng, 64, 96)
    p = dataclasses.replace(FarnebackParams.windowed(), levels=0)
    a, b = torch.from_numpy(f0), torch.from_numpy(f1)
    assert torch.equal(spatial.farneback_spatial(a, b, p, mesh.Mesh(1, 1),
                                                 halo=32),
                       farneback(a.float(), b.float(), p))
    two = mesh.Mesh(1, 2, rank=0)
    with pytest.raises(ValueError, match="halo"):
        spatial.farneback_spatial(a[:32], b[:32], p, two, halo=64)
    with pytest.raises(ValueError, match="not divisible by space=2"):
        mesh.shard_streams(two, a[None, :63])
    with pytest.raises(RuntimeError, match="requested 2 devices, have 1"):
        mesh.make_mesh(2)
    with pytest.raises(ValueError, match="farm needs"):
        distributed.init_cluster(num_processes=2)
