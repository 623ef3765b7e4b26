"""The fused Farneback engine on a spatial slab placed in its frame, K1's
row offset and base sums, and the row-band forms of the step's other
operations (``prep_frame``, ``rip_edges``, the drawing), on the CPU.

A slab passes ``slab=Slab(origin, frame_h)`` to the engine, so each level's
row tile is the frame's and its tiles start at the frame's tile
boundaries (``flow/farneback.py``). Tolerances:
- the slab's flow against the whole frame's ``farneback``, interior rows
  (all but the 64 outermost of the frame's edges, ``chip_smoke.py``
  ``SPATIAL_BOUNDS``, ``tests/test_spatial.py``'s bounds): median < 1e-4
  px, mean < 0.01, share above 0.1 px < 1%; the 64 outermost rows of the
  frame's edges mean < 0.1;
- the plain K1 with a row offset against the same rows of the whole
  frame's call: equal, on rows whose blocks are whole and whose border
  ramp and frame test are the frame's;
- the bands of ``prep_frame``, ``rip_edges`` and the drawing against the
  same rows of the whole frame's: equal.
"""

import numpy as np
import pytest
import torch

from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.flow import fused_update as fu
from ripcurrents_tpu_torch.flow.farneback import Slab, farneback
from ripcurrents_tpu_torch.ops import morphology
from ripcurrents_tpu_torch.ops.image import band_source_rows
from ripcurrents_tpu_torch.parallel.spatial import stream_halo
from ripcurrents_tpu_torch.pipelines.common import ModeConfig, prep_frame
from ripcurrents_tpu_torch.synthetic import moving_frames
from ripcurrents_tpu_torch.viz import draw

torch.set_num_threads(1)
CPU = torch.device("cpu")
EDGE = 64


def test_fused_slab_matches_frame_interior():
    """The legacy preset on 480x320 gray frames, each clamped slab of 2
    ranks (368 rows at rows 0 and 112, halo 64 = stream_halo at 640x480)
    placed at its origin, against the whole frame's farneback: the bands'
    flow within the bounds."""
    p = FarnebackParams.legacy()
    assert stream_halo(p, (480, 640)) == 64
    a, b = (f.float() for f in moving_frames(2, 480, 320, CPU, seed=3,
                                             color=False))
    want = farneback(a, b, p)
    got = []
    for origin, keep in ((0, slice(0, 240)), (112, slice(128, 368))):
        rows = slice(origin, origin + 368)
        got.append(farneback(a[rows], b[rows], p,
                             slab=Slab(origin, 480))[keep])
    d = torch.sqrt(((torch.cat(got) - want) ** 2).sum(-1))
    di = d[EDGE:-EDGE]
    assert float(di.median()) < 1e-4 and float(di.mean()) < 0.01
    assert float((di > 0.1).float().mean()) < 0.01
    assert float(torch.cat([d[:EDGE], d[-EDGE:]]).mean()) < 0.1


def _level(h, w, th, seed):
    """K1's inputs at (h, w): bf16 tables (a slab's halo rows hold the
    frame's), a flow near a whole number on each block of the frame's
    (th, 128) grid (within 0.2 px) plus a ripple of 0.2 px, so any part
    of a block rounds to the block's base."""
    rng = np.random.default_rng(seed)
    hp, wp = -(-h // th) * th, -(-w // 128) * 128
    tables = [torch.from_numpy(rng.normal(
        size=(5, hp + 2 * fu.HALO_Y, wp + 2 * fu.HALO_X)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2)]
    ty, nsub = hp // th, wp // 128
    blocks = (rng.integers(-3, 4, (2, ty, nsub)) +
              rng.uniform(-0.2, 0.2, (2, ty, nsub))).astype(np.float32)
    flow = np.repeat(np.repeat(blocks, th, 1), 128, 2)
    flow = flow + rng.uniform(-0.2, 0.2, flow.shape).astype(np.float32)
    flow[:, h:] = 0
    flow[:, :, w:] = 0
    return tables, torch.from_numpy(flow.astype(np.float32))


@pytest.mark.parametrize("origin", [40, 136])
def test_k1_plain_row_offset_matches_frame_rows(origin):
    """The plain K1 on rows [origin, origin + 200) of a 360-row level
    (row tile 120, so the slab's first tile is partial) against the whole level's call: equal on the slab's rows
    at least 5 rows from its edges. The blocks' flow is constant up to a
    ripple smaller than half a pixel, so a partial block's own base is the
    whole block's; with the base sums given (the frame's blocks, as the
    ranks' block sums add up to them) it is equal too, and the windowed
    block sums of two row ranges add up to the whole."""
    h, w, th, hs = 360, 256, 120, 200
    (p0, p1), flow = _level(h, w, th, origin)
    prep = fu.prepare_expansions(p0, p1, th, hw=(h, w), subcol=128)
    want = fu.farneback_update(prep, flow, 4)
    roff = origin % th
    hp = fu.padded_rows(hs, th, roff)
    assert hp == 200 and roff == origin - 120 * (origin // 120) > 0
    rows = slice(origin, origin + hp + 2 * fu.HALO_Y)
    sp = fu.prepare_expansions(p0[:, rows].contiguous(),
                               p1[:, rows].contiguous(), th, hw=(hs, w),
                               subcol=128, roff=roff)
    sflow = flow[:, origin:origin + hp].contiguous()
    got = fu.farneback_update(sp, sflow, 4)
    inner = slice(5, hs - 5)
    assert torch.equal(got[:, inner], want[:, origin + 5:origin + hs - 5])
    sums = fu.farneback_block_sums(flow, th, 128, 0, (0, h))
    f0 = (origin - roff) // th
    n = fu.row_tiles(hp, th, roff)
    frame_sp = dict(sp, counts=prep["counts"][f0:f0 + n].contiguous())
    given = fu.farneback_update(frame_sp, sflow, 4,
                                sums[:, f0:f0 + n].contiguous())
    assert torch.equal(given[:, inner], want[:, origin + 5:origin + hs - 5])
    halves = [fu.farneback_block_sums(sflow, th, 128, roff, r)
              for r in ((0, 77), (77, hp))]
    assert torch.allclose(halves[0] + halves[1], fu.farneback_block_sums(
        sflow, th, 128, roff, (0, hp)), rtol=1e-12, atol=1e-9)


def test_band_ops_equal_frame_rows():
    """prep_frame's row bands (the step's source rows, src=(a0, src_h);
    1280x720 -> 640x480, 640x480 -> 320x240, and the first frame's
    INTER_AREA) equal those rows of the whole frame's, bit for bit;
    rip_edges of a band with EDGE_HALO rows of its neighbours, and
    polylines and circles drawn into a band with its row offset, equal the
    whole frame's rows."""
    for raw_hw, (ydim, xdim) in (((720, 1280), (480, 640)),
                                 ((480, 640), (240, 320))):
        raw = moving_frames(1, *raw_hw, CPU, seed=5)[0]
        cfg = ModeConfig(xdim=xdim, ydim=ydim)
        for first in (False, True):
            whole = prep_frame(raw, cfg, first=first)
            for i0, i1 in ((0, ydim // 2), (ydim // 2, ydim)):
                if first:
                    part = prep_frame(raw, cfg, True, rows=(i0, i1))
                else:
                    a, b = band_source_rows(raw_hw[0], ydim, (i0, i1))
                    part = prep_frame(raw[a:b], cfg, rows=(i0, i1),
                                      src=(a, raw_hw[0]))
                for x, y in zip(part, whole):
                    assert torch.equal(x, y[i0:i1]), (raw_hw, first, i0)
    rng = np.random.default_rng(2)
    mask = torch.from_numpy(np.where(rng.random((96, 80)) < 0.3, 255,
                                     0).astype(np.uint8))
    whole = morphology.rip_edges(mask)
    e = morphology.EDGE_HALO
    for i0, i1 in ((0, 32), (32, 64), (64, 96)):
        above = mask[i0 - e:i0] if i0 else None
        below = mask[i1:i1 + e] if i1 < 96 else None
        assert torch.equal(morphology.rip_edges(mask[i0:i1], above, below),
                           whole[i0:i1])
    pts = torch.from_numpy(rng.uniform(-10, 100, (30, 2)).astype(
        np.float32))
    canvas = torch.zeros((96, 80, 3), dtype=torch.uint8)
    whole = draw.draw_circles(draw.draw_polyline(
        canvas, pts, (0, 0, 100), thickness=2), pts, 4, (100, 0, 0))
    for i0, i1 in ((0, 48), (48, 96)):
        part = draw.draw_circles(draw.draw_polyline(
            canvas[i0:i1], pts, (0, 0, 100), thickness=2, band=(i0, 96)),
            pts, 4, (100, 0, 0), band=(i0, 96))
        assert torch.equal(part, whole[i0:i1])
