"""The host plans of K2 (farneback_blur_solve) and K4 (resize_cf_padded)
at every level of the presets the port runs, on the CPU.

Inputs and what is held: ``tests/_torch_blur_geometry.py``.
"""

import pytest
import torch

from ripcurrents_tpu_torch import kernels
from ripcurrents_tpu_torch.flow import fused_update as fu
from ripcurrents_tpu_torch.ops import image as im

from _torch_blur_geometry import PYRAMIDS, _check_blur_plan, _levels

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(PYRAMIDS))
def test_tiles_cover_every_output_once_and_stage_their_windows(name):
    """K2 at every level and K4 at every level change: each output in one
    tile, every window in the tile's mid values, every block within the
    card's limits, and K4's grid one wave of RESIZE_MIN_BLOCKS blocks an
    SM unless its threads already take RESIZE_MAX_ROWS rows."""
    for hw0, preset in PYRAMIDS[name]:
        p, levels = _levels(hw0, preset)
        half = p.winsize // 2
        for hw, hpwp in levels:
            _check_blur_plan(fu.blur_plan(*hpwp, half, hw), hpwp, half)
        for _, (dph, dpw) in levels[1:]:
            plan = im.resize_plan(dph, dpw)
            gx, gy = plan["grid"]
            assert gx * 128 >= dpw > (gx - 1) * 128
            band = im.RESIZE_WARPS * plan["rows"]
            assert gy * band >= dph > (gy - 1) * band
            assert plan["rows"] <= im.RESIZE_MAX_ROWS
            assert gx * gy <= kernels.H100_SMS * im.RESIZE_MIN_BLOCKS or \
                plan["rows"] == im.RESIZE_MAX_ROWS


def test_plan_takes_short_chains_where_a_level_cannot_fill_the_card():
    """A level with fewer than BLUR_LATENCY_TAPS output taps takes
    BLUR_SMALL (1-row strips on 8x32 tiles), a larger one BLUR_LARGE; the
    legacy coarse levels are small, level 0 of 640x480 and of 1080p large
    and give every SM at least one tile."""
    for hw, half in (((120, 160), 1), ((240, 320), 1), ((120, 160), 5)):
        assert hw[0] * hw[1] * (2 * half + 1) < fu.BLUR_LATENCY_TAPS
        plan = fu.blur_plan(hw[0], -(-hw[1] // 128) * 128, half, hw)
        assert (plan["rows"], plan["cols"], plan["strip"]) == fu.BLUR_SMALL
    for hw, half in (((480, 640), 1), ((480, 640), 5), ((1080, 1920), 5)):
        plan = fu.blur_plan(*hw, half, hw)
        assert (plan["rows"], plan["cols"], plan["strip"]) == fu.BLUR_LARGE
        assert plan["grid"][0] * plan["grid"][1] >= kernels.H100_SMS
