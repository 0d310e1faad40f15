"""Rasterize 2D gaussian surfels: preprocess → bin → pack → blend (K1).

Port of instascene_tpu/ops/rasterize.py:35-143 (`RasterizeConfig`, reduced
to what the port serves so far), :242-364 (`_rasterize_impl`, `rasterize`,
with the t_offset densification tap), :488-495 (`densify_screen_grad`) and
instascene_tpu/ops/rasterize_pallas.py:30-57 (`pallas_tiles_to_map`,
`maps_from_pallas`). Buffers follow the exact pair total, so the TPU's pair
and tile caps, their grow-and-retry loop, slab plans and gather tuning are
gone; `n_dropped` is always 0.

Differentiable: torch autograd runs through preprocess, SH and pack, and
the blend's gradient comes from K2 (ops/blend_visits.BlendFunction).

Flags that belong to later slices raise NotImplementedError rather than
being ignored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from .binning import bin_gaussians
from . import blend_visits as bv
from .blend_visits import pack_flat_cols
from .preprocess import TILE, preprocess_gaussians


class CameraMats(NamedTuple):
    w2v: torch.Tensor        # [4,4]
    full_proj: torch.Tensor  # [4,4]
    campos: torch.Tensor     # [3]


@dataclass(frozen=True)
class RasterizeConfig:
    width: int
    height: int
    # viewer fast path: forward-only color + alpha [+ features]; depth,
    # normal, median and distortion outputs are zeros
    fwd_viewer: bool = False
    # skip the expected-depth and distortion machinery (K1/K2 no_dist) for
    # callers whose loss reads neither rend_dist nor the expected depth
    # (lambda_dist == 0 and depth_ratio == 1, the reference defaults); the
    # depth and distortion outputs come back exact zeros
    no_depth_dist: bool = False
    # later slices
    track_contrib: bool = False      # K1 track mode (slice 4)
    bwd_extras_only: bool = False    # K1 extras_only + K2 (slice 3)
    clip_rect: bool = False          # K1 clip_rect (slice 4)
    conic_cull: bool = False         # preprocess.conic_cull_masks (slice 4)
    tiles_per_view: int = 0          # K1 merged multi-view (slice 4)

    def check(self) -> None:
        later = {"track_contrib": "slice 4 (contributor tracking, K1 track "
                                  "mode)",
                 "bwd_extras_only": "slice 3 (semantic step, K1 extras_only "
                                    "and K2)",
                 "clip_rect": "slice 4 (cached-superset binning, K1 "
                              "clip_rect)",
                 "conic_cull": "slice 4 (exact conic pair culling)",
                 "tiles_per_view": "slice 4 (merged multi-view, K1 "
                                   "tiles_per_view)"}
        for name, when in later.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"RasterizeConfig.{name} is not ported yet: it comes in "
                    f"{when}")


class BlendOut(NamedTuple):
    color: torch.Tensor          # [H,W,3] with background
    depth: torch.Tensor          # [H,W] sum of w·depth
    alpha: torch.Tensor          # [H,W]
    normal: torch.Tensor         # [H,W,3] view-space
    median_depth: torch.Tensor   # [H,W]
    distortion: torch.Tensor     # [H,W]
    extra: Optional[torch.Tensor]  # [H,W,E]
    final_T: torch.Tensor        # [H,W]
    n_contrib: torch.Tensor      # [H,W] int32


class RasterizeOut(NamedTuple):
    blend: BlendOut
    radii: torch.Tensor          # [N] int32 screen radius (0 → culled)
    visible: torch.Tensor        # [N] bool
    depth: torch.Tensor          # [N] per-gaussian view z
    n_dropped: int               # always 0: buffers follow the pair total
    T: torch.Tensor              # [N,3,3] splat→pixel transforms
    total_pairs: int             # (gaussian, tile) pairs of the frame


def tiles_to_map(x: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """[T, C, 256] tile-major kernel output → [H, W, C] image map."""
    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    c = x.shape[1]
    x = x.reshape(grid_y, grid_x, c, TILE, TILE).permute(0, 3, 1, 4, 2)
    return x.reshape(grid_y * TILE, grid_x * TILE, c)[:height, :width]


def maps_from_tiles(out, iout, width, height, n_extra) -> dict:
    """Kernel outputs → [H, W, ·] maps (the m1/m2 residual rows stay
    internal)."""
    maps = tiles_to_map(out, width, height)
    imaps = tiles_to_map(iout, width, height)
    E = n_extra
    return dict(color_nobg=maps[..., 0:3], depth=maps[..., 3],
                normal=maps[..., 4:7], median_depth=maps[..., 7],
                distortion=maps[..., 8], final_T=maps[..., 9],
                extra=maps[..., 10:10 + E],
                n_contrib=imaps[..., 0], med_slot=imaps[..., 1])


def rasterize(means3d, scales, rotations, opacities, cam: CameraMats, bg,
              cfg: RasterizeConfig, colors=None, shs=None, sh_degree: int = 0,
              extras=None, t_offset=None, alive=None,
              done0=None) -> RasterizeOut:
    """means3d [N,3]; scales [N,2] (activated); rotations [N,4] (w,x,y,z);
    opacities [N] or [N,1] (activated); exactly one of colors [N,3] /
    shs [N,K,3]; extras [N,E] optional feature channels; t_offset [N,3,3]
    optional zero tensor whose gradient is dL/dT (the densification tap:
    added to T after the screen AABB, so it reaches the blend alone). All
    on one device: CUDA runs the kernels, CPU their plain versions.
    Differentiable unless cfg.fwd_viewer."""
    cfg.check()
    if done0 is not None:
        raise NotImplementedError("sampled-pixel done0 masks come in slice 3 "
                                  "(semantic step, K1 extras_only)")
    width, height = cfg.width, cfg.height
    n = means3d.shape[0]
    opac = torch.reshape(opacities, (n,))
    pre = preprocess_gaussians(
        means3d, scales, rotations, cam.w2v, cam.full_proj, cam.campos,
        width, height, opac, color=colors, shs=shs, sh_degree=sh_degree,
        alive=alive)
    binning = bin_gaussians(pre, width, height)
    E = extras.shape[1] if extras is not None else 0
    grid_x = (width + TILE - 1) // TILE
    T_used = pre.T if t_offset is None else pre.T + t_offset
    flat = pack_flat_cols(T_used, pre.xy, pre.normal_view, opac, pre.color,
                          extras)
    bargs = (binning.sorted_gid, binning.tile_start, binning.tile_end,
             grid_x, E)
    if cfg.fwd_viewer:
        out, iout = bv.blend_fwd(flat.detach(), *bargs, viewer=True)
    else:
        out, iout = bv.blend(flat, *bargs,
                             (binning.gid_order, binning.run_start),
                             no_dist=cfg.no_depth_dist)
    maps = maps_from_tiles(out, iout, width, height, E)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=means3d.device)
    color = maps["color_nobg"] + maps["final_T"][..., None] * bg
    blend = BlendOut(color=color, depth=maps["depth"],
                     alpha=1.0 - maps["final_T"], normal=maps["normal"],
                     median_depth=maps["median_depth"],
                     distortion=maps["distortion"],
                     extra=maps["extra"] if extras is not None else None,
                     final_T=maps["final_T"], n_contrib=maps["n_contrib"])
    return RasterizeOut(blend=blend, radii=pre.radius.to(torch.int32),
                        visible=pre.valid & (pre.radius > 0),
                        depth=pre.depth, n_dropped=0, T=pre.T,
                        total_pairs=binning.total_pairs)


def densify_screen_grad(t_grad: torch.Tensor, depth: torch.Tensor,
                        width: int, height: int) -> torch.Tensor:
    """dL/dT → the reference's NDC-space view-space gradient of the
    densification stats (backward.cu:652-655): dL/dT[0,2]·z·W/2,
    dL/dT[1,2]·z·H/2. [N,2]."""
    gx = t_grad[:, 0, 2] * depth * 0.5 * width
    gy = t_grad[:, 1, 2] * depth * 0.5 * height
    return torch.stack([gx, gy], dim=-1)
