"""K8's host plan (``tiles_plan``) over every level of the tiled
engine's 640x480 pyramid, both bench_warp 1080p geometries and a
ragged 75x107 frame, on the CPU: every pixel covered by one CTA, S
within the card's cluster limits.

Inputs and what is held: ``tests/_torch_warp_tiles.py``.
"""

import pytest
import torch

from ripcurrents_tpu_torch.flow import warp_kernel as wk

from _torch_warp_tiles import GEOMETRIES, H100, NO16, _check_plan

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_plan_covers_every_pixel_once(name):
    for hw, tile in GEOMETRIES[name]:
        _check_plan(wk.tiles_plan(*hw, *tile, H100), hw, tile, H100)
    if name == "tiled 640x480":               # level 0: 24 tiles x 16 CTAs
        l0 = wk.tiles_plan(480, 640, 64, 256, H100)
        assert (l0["S"], l0["ctas"], l0["threads"]) == (16, 384, 128)


def test_plan_keeps_to_the_card_limit():
    """A card that holds no 16-CTA cluster caps S at 8; a card that holds
    no cluster gets S = 1 (plain CTAs, no wait on a cluster)."""
    for hw, tile in sum(GEOMETRIES.values(), []):
        s16 = wk.tiles_plan(*hw, *tile, H100)
        s8 = wk.tiles_plan(*hw, *tile, NO16)
        assert s8["S"] == min(s16["S"], 8)
        _check_plan(s8, hw, tile, NO16)
        zero = {t: {s: 0 for s in a} for t, a in H100.items()}
        assert wk.tiles_plan(*hw, *tile, zero)["S"] == 1
