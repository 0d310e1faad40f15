"""Image-space (tile-slab) sharded rendering: each rank renders a
horizontal slab of the frame.

Port of instascene_tpu/parallel/render_sharded.py:27-76
(`build_sharded_render`). The slab's origin is folded into the
splat→pixel transform (rasterize's y_offset / full_height), so binning and
blend run unchanged on the slab's local rows and scale with its pairs;
preprocessing is replicated. The slabs are then gathered into the whole
frame on every rank. The port has no pair caps, so there is no
`n_dropped` to return.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.preprocess import TILE
from ..ops.rasterize import CameraMats, RasterizeConfig, rasterize
from .launch import all_gather_rows


@torch.no_grad()
def sharded_render(means3d, scales, rotations, opacities, cam: CameraMats,
                   bg, width: int, height: int, colors=None, shs=None,
                   sh_degree: int = 0, extras=None, alive=None,
                   viewer: bool = False, group=None):
    """rasterize's inputs (the same on every rank) → (color [H,W,3], alpha
    [H,W], extra [H,W,E], E = 0 without extras) of the whole frame on
    every rank; rank r renders rows [r·h, (r+1)·h), h = height / world,
    through K1 `full` (or `viewer`). height must be a multiple of world ·
    16, so that every slab is whole tile rows."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if height % (world * TILE):
        raise ValueError(f"height {height} must be a multiple of "
                         f"{world * TILE} (devices x tile)")
    h = height // world
    out = rasterize(means3d, scales, rotations, opacities, cam, bg,
                    RasterizeConfig(width, h, fwd_viewer=viewer),
                    colors=colors, shs=shs, sh_degree=sh_degree,
                    extras=extras, alive=alive, y_offset=rank * h,
                    full_height=height)
    b = out.blend
    extra = b.extra if extras is not None else b.color.new_zeros(
        (h, width, 0))
    full = all_gather_rows(torch.cat([b.color, b.alpha[..., None], extra],
                                     dim=-1), group)
    return full[..., :3], full[..., 3], full[..., 4:]
