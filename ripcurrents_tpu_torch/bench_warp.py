"""The fused Farneback engine's warp stage alone at 1080p on the card: the
port's counterpart of ``tools/bench_warp_variants.py``.

Run from the repository root on a machine with a card:

    python -m ripcurrents_tpu_torch.bench_warp [bres=N] [sw=N] [variants...]

Variants (default: all four):

- ``A``: kernel K8 in its halo layout (``flow/warp_kernel.py:
  warp_tiles``), the tool's variant "A" (``_warp_subcols``): per (th x sw)
  block the rounded-mean integer base, each pixel's residual clamped to
  +-bres, the bilinear sample of the halo'd bf16 table -> (5, Hp, Wp) f32;
- ``Z``: K8's instance with no base and no base pass
  (``warp_tiles_nobase``), the tool's floor "Z": the taps and weights
  alone;
- ``K1``: the fused engine's update kernel (``farneback_update``) at the
  same geometry, table and flow: the warp plus the update tail;
- ``GS``: ``torch.nn.functional.grid_sample`` of the table upcast to f32
  at pixel + flow (the library call for a bilinear gather; no base, no
  clamp).

The tool's other variants (B-G, R, RD8, D32, YSL, MX, MXY, W9, BIL) are
TPU data-movement and weight-form alternatives of the same function
(lane rolls, dynamic slices, one-hot MXU shifts, bf16 VPU arithmetic,
other exact forms of the hat weights). They are not kernels of their own;
asking for one prints that it has no counterpart on this card.

Setup as the tool's: 1080x1920, th = _row_tile(1080) = 120, sw =
_subcol_width(1920) = 384 unless sw= is given, bres 2 unless bres= is
given; from numpy default_rng(0) a table ~N(0, 1) rounded to bf16, flows
~N(0, 3), real-pixel counts th * sw. Timing: CUDA events around 100
back-to-back launches on one stream (each waits for the one before), ms
per launch, median of 3. The checksum is the mean |output| of one launch.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ripcurrents_tpu_torch.flow import fused_update as fu
from ripcurrents_tpu_torch.flow import warp_kernel

H, W = 1080, 1920
BRES = 2
VARIANTS = ("A", "Z", "K1", "GS")
TPU_ONLY = ("B", "C", "D", "E", "F", "G", "R", "RD8", "D32", "YSL", "MX",
            "MXY", "W9", "BIL")


def geometry(sw: "int | None" = None) -> dict:
    """The tool's geometry at 1080x1920: th, sw, Hp, Wp and the grid."""
    th = fu._row_tile(H)
    hp, wp = -(-H // th) * th, -(-W // 128) * 128
    sw = fu._subcol_width(wp, sw)
    return {"th": th, "sw": sw, "hp": hp, "wp": wp,
            "grid": (hp // th, wp // sw)}


def inputs(device, sw: "int | None" = None, seed: int = 0) -> dict:
    """The tool's inputs on `device`: table (5, Hp + 2*HALO_Y,
    Wp + 2*HALO_X) bf16, flow (2, Hp, Wp) f32, counts, and the
    geometry."""
    g = geometry(sw)
    hp, wp, th, sw = g["hp"], g["wp"], g["th"], g["sw"]
    rng = np.random.default_rng(seed)
    tbl = rng.normal(0, 1, (5, hp + 2 * fu.HALO_Y, wp + 2 * fu.HALO_X))
    dx = rng.normal(0, 3, (hp, wp))
    dy = rng.normal(0, 3, (hp, wp))
    g["table"] = torch.from_numpy(tbl.astype(np.float32)).to(
        torch.bfloat16).to(device)
    g["flow"] = torch.from_numpy(np.stack([dx, dy]).astype(np.float32)).to(
        device)
    g["counts"] = torch.full((hp // th, wp // sw), float(th * sw),
                             dtype=torch.float32, device=device)
    return g


def variant_fn(variant: str, g: dict, bres: int):
    """A no-argument callable that runs one variant once on g's inputs."""
    table, flow, th, sw = g["table"], g["flow"], g["th"], g["sw"]
    if variant == "A":
        return lambda: warp_kernel.warp_tiles(table, flow, g["counts"], th,
                                              sw, bres)
    if variant == "Z":
        return lambda: warp_kernel.warp_tiles_nobase(table, flow, th, sw,
                                                     bres)
    if variant == "K1":
        prep = {"p0": table, "p1": table, "counts": g["counts"],
                "hw": (H, W), "hpwp": (g["hp"], g["wp"]), "th": th,
                "sw": sw}
        return lambda: fu.farneback_update(prep, flow, bres)
    if variant == "GS":
        tf = table.to(torch.float32)[None]
        ty, tx = tf.shape[2], tf.shape[3]
        ys = torch.arange(g["hp"], dtype=torch.float32,
                          device=flow.device)[:, None]
        xs = torch.arange(g["wp"], dtype=torch.float32,
                          device=flow.device)[None, :]
        grid = torch.stack(
            [(xs + fu.HALO_X + flow[0]) * (2.0 / (tx - 1)) - 1,
             (ys + fu.HALO_Y + flow[1]) * (2.0 / (ty - 1)) - 1],
            dim=-1)[None]
        return lambda: F.grid_sample(tf, grid, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=True)
    raise ValueError(f"unknown variant {variant!r}")


def time_ms(fn, reps: int = 100, rounds: int = 3) -> float:
    """Median over `rounds` of the ms per launch of `reps` back-to-back
    launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / reps)
    return sorted(per)[len(per) // 2]


def run(variant: str, bres: int = BRES, sw: "int | None" = None,
        reps: int = 100, g: "dict | None" = None) -> dict:
    """Time one variant; -> {"variant", "ms", "th", "sw", "grid", "bres",
    "checksum"}."""
    g = inputs(torch.device("cuda"), sw) if g is None else g
    fn = variant_fn(variant, g, bres)
    checksum = fn().float().abs().mean().item()
    return {"variant": variant, "ms": time_ms(fn, reps), "th": g["th"],
            "sw": g["sw"], "grid": g["grid"], "bres": bres,
            "checksum": checksum}


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv: list[str]) -> int:
    bres, sw = BRES, None
    while argv and "=" in argv[0]:
        k, v = argv[0].split("=", 1)
        if k == "bres":
            bres = int(v)
        elif k == "sw":
            sw = int(v)
        else:
            raise SystemExit(f"bench_warp: unknown option {k!r}")
        argv = argv[1:]
    if not torch.cuda.is_available():
        raise SystemExit("bench_warp: no CUDA device")
    print(f"card: {card()}")
    print(f"BRES={bres} SW={sw or 'default'}")
    g = inputs(torch.device("cuda"), sw)
    for v in argv or VARIANTS:
        if v in TPU_ONLY:
            print(f"variant {v}: no counterpart on this card (a TPU "
                  f"data-movement or weight form of variant A)")
            continue
        r = run(v, bres, sw, g=g)
        print(f"variant {v}: {r['ms']:7.4f} ms/warp  (th={r['th']} "
              f"sw={r['sw']} grid={r['grid'][0]}x{r['grid'][1]} "
              f"bres={bres}) checksum={r['checksum']:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
