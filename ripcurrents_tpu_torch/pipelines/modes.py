"""Discrete-streamline helpers of the modes (port of
``_advect_and_draw_trails`` and ``_composite_trails`` from
``ripcurrents_tpu/pipelines/modes.py``; get_streamlines,
ripcurrents_module.cpp:71-79)."""

from __future__ import annotations

import torch

from ripcurrents_tpu_torch.dynamics import advect
from ripcurrents_tpu_torch.ops.colormap import apply_colormap
from ripcurrents_tpu_torch.viz import draw


def _advect_and_draw_trails(seeds, overlay_u8, flow, framecount, cfg,
                            dt=0.1, iters=100, upper=45.0):
    """Advance seeds through `flow`, drawing their trails onto the
    persistent 8-bit canvas with intensity framecount*255/totalframes."""
    res = advect.streamlines(seeds, flow, dt, iters, upper)
    shade = framecount.to(torch.float32) * 255.0 / cfg.total_frames
    shade = torch.clamp(shade, 0, 255).to(torch.uint8)
    # Every seed's trail is a polyline whose first point is valid; all
    # trails share one shade, so they are drawn in one scatter.
    valid = torch.cat([torch.ones_like(res.seg_valid[:, :1]),
                       res.seg_valid], dim=1)
    overlay_u8 = draw.draw_segments(
        overlay_u8, res.points[:, :-1].reshape(-1, 2),
        res.points[:, 1:].reshape(-1, 2),
        (valid[:, :-1] & valid[:, 1:]).reshape(-1), shade)
    return res.final, overlay_u8


def _composite_trails(frame_u8, overlay_u8):
    """applyColorMap(RAINBOW) + masked saturated add (get_streamlines)."""
    colored = apply_colormap(overlay_u8, "rainbow")
    mask = (overlay_u8 > 0)[..., None]
    added = torch.clamp(frame_u8.to(torch.int32) + colored.to(torch.int32),
                        max=255).to(torch.uint8)
    return torch.where(mask, added, frame_u8)
