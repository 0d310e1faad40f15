"""Forward-only render through the padded-layout blend (K7).

Port of instascene_tpu/ops/rasterize_pallas.py:57-83
(`rasterize_pallas_fwd`, the JAX package's forward-only entry "for
inference/benchmarks"): preprocess → binning → padded layout → pack → K7
→ maps. The padded layout's K follows the frame's largest tile
(ops/binning.padded_layout), so where the JAX entry's fixed tile_cap
(2048 by default) drops pairs, this one drops none: n_dropped is 0.
Preprocess keeps the port's opacity-aware rects (the JAX entry bins
opacity-blind rects), which changes the pair lists and so n_contrib's slot
numbers, not the maps.
"""

from __future__ import annotations

import torch

from .binning import bin_gaussians, padded_layout
from .blend_padded import blend_fwd_padded, pack_inputs
from .blend_visits import pack_flat_cols
from .preprocess import TILE, preprocess_gaussians
from .rasterize import CameraMats, maps_from_tiles


def rasterize_padded_fwd(means3d, scales, rotations, opacities,
                         cam: CameraMats, bg, width: int, height: int,
                         colors=None, shs=None, sh_degree: int = 0,
                         extras=None, alive=None):
    """Forward-only render of one camera through K7 → (maps, radii,
    visible, depth, n_dropped = 0). maps holds [H, W, ·] color (with bg
    composited), color_nobg, depth, normal, median_depth, distortion,
    final_T, extra, n_contrib and med_slot. Arguments as
    ops/rasterize.rasterize's; nothing carries a gradient. CUDA tensors
    launch K7, CPU tensors run its plain version."""
    with torch.no_grad():
        n = means3d.shape[0]
        opac = torch.reshape(opacities, (n,))
        pre = preprocess_gaussians(
            means3d, scales, rotations, cam.w2v, cam.full_proj, cam.campos,
            width, height, opac, color=colors, shs=shs, sh_degree=sh_degree,
            alive=alive)
        tile_indices, tile_count = padded_layout(
            bin_gaussians(pre, width, height))
        flat = pack_flat_cols(pre.T, pre.xy, pre.normal_view, opac,
                              pre.color, extras)
        E = extras.shape[1] if extras is not None else 0
        out, iout = blend_fwd_padded(pack_inputs(flat, tile_indices),
                                     tile_count, (width + TILE - 1) // TILE,
                                     E)
        maps = maps_from_tiles(out, iout, width, height, E)
        bg = torch.as_tensor(bg, dtype=torch.float32, device=means3d.device)
        maps["color"] = maps["color_nobg"] + maps["final_T"][..., None] * bg
    return (maps, pre.radius.to(torch.int32), pre.valid & (pre.radius > 0),
            pre.depth, 0)
