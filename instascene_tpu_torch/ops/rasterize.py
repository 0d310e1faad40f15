"""Rasterize 2D gaussian surfels: preprocess → bin → pack → blend (K1).

Port of instascene_tpu/ops/rasterize.py:35-143 (`RasterizeConfig`, reduced
to what the port serves so far), :146-230 (`_blend_via_pallas`: the
extras-only mode with its sampled-pixel done0 mask, contributor tracking,
`extra_tiles`), :242-364 (`_rasterize_impl`, `rasterize`, with the t_offset
densification tap, `cached_binning` and the slab origin `y_offset` /
`full_height`), :457-485
(`rasterize_extras_tiles`, the tile-subset feature render through K3/K4),
:488-495 (`densify_screen_grad`), :498-587 (`compute_binning_cache`, with
`dilate_tiles` and `conic_cull`) and instascene_tpu/ops/rasterize_pallas.py
:30-57 (`pallas_tiles_to_map`, `maps_from_pallas`). Buffers follow the
exact pair total, so the TPU's pair and tile caps, their grow-and-retry
loop, slab plans and gather tuning are gone; `n_dropped` is always 0. The
frozen-geometry binning cache is the camera's BinningOut itself (no visit
layout, no chain-reduce indices); a tile subset of it renders in every
mode but track through K1/K2's tile list (K3/K4: `tile_ids`), where the
JAX package builds a select_tiles_bundle mini bundle
(rasterize.py:277-282, blend_pallas.py:987-1085).

Differentiable: torch autograd runs through preprocess, SH and pack, and
the blend's gradient comes from K2 (ops/blend_visits.BlendFunction). A
call that needs no gradient through the geometry (detached inputs, no
grad mode, the viewer and tracker modes) takes preprocess's one-launch
kernel on the card (ops/preprocess.py).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from .binning import BinningOut, bin_gaussians
from . import blend_visits as bv
from .blend_visits import pack_flat_cols
from .preprocess import TILE, preprocess_gaussians
from ..utils.profiling import span


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
    # forward-only full blend plus the per-pixel w > 0.1 contributor buffer
    # (K1 track): BlendOut.contrib_ids / contrib_w [H,W,10]
    track_contrib: bool = False
    # feature-lifting fast path (K1/K2 extras_only): the forward computes
    # only the features, final T and n_contrib (every other map is zero)
    # and the gradient reaches the feature columns alone
    bwd_extras_only: bool = False
    # cached-superset mode (K1/K2 clip_rect): pack each gaussian's fresh
    # tile rect as 4 trailing columns and gate every pair by tile ∈ rect,
    # so a cached SUPERSET pair list (compute_binning_cache(dilate_tiles=)
    # at a nearby camera) renders exactly as fresh binning would; requires
    # cached_binning, not with track_contrib
    clip_rect: bool = False
    # exact conic-vs-tile pair culling (preprocess.conic_cull_masks) on
    # fresh binning: drops every pair whose tile cannot reach alpha >=
    # 1/255; the maps and gradients are unchanged, the pair lists shorter
    conic_cull: bool = False

    def check(self) -> None:
        modes = [m for m in ("fwd_viewer", "track_contrib",
                             "bwd_extras_only") if getattr(self, m)]
        if len(modes) > 1:
            raise ValueError(f"RasterizeConfig: {modes} are separate modes")
        if self.clip_rect and self.track_contrib:
            raise ValueError("RasterizeConfig: clip_rect serves cached "
                             "pair lists without track_contrib")


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
    contrib_ids: Optional[torch.Tensor] = None  # [H,W,10] int32 (track)
    contrib_w: Optional[torch.Tensor] = None    # [H,W,10] f32 (track)
    # the kernels' tile-major features [T,E,256]: a loss that reads sampled
    # pixels fetches them here, with no [H,W,E] map and no un-transpose
    extra_tiles: Optional[torch.Tensor] = None


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
              done0=None, cached_binning=None, tile_ids=None, y_offset=None,
              full_height: Optional[int] = None) -> RasterizeOut:
    """means3d [N,3]; scales [N,2] (activated); rotations [N,4] (w,x,y,z);
    opacities [N] or [N,1] (activated); exactly one of colors [N,3] /
    shs [N,K,3]; extras [N,E] optional feature channels; t_offset [N,3,3]
    optional zero tensor whose gradient is dL/dT (the densification tap:
    added to T after the screen AABB, so it reaches the blend alone). All
    on one device: CUDA runs the kernels, CPU their plain versions.
    Differentiable unless cfg.fwd_viewer or cfg.track_contrib.

    cached_binning: the camera's BinningOut from compute_binning_cache
    (frozen geometry): preprocess still runs, binning is skipped. done0
    [num_tiles, 1, 256] int32 (cfg.bwd_extras_only only): 1 pre-latches a
    pixel done; the other pixels' features and gradients are bit for bit
    those of done0=None, the latched pixels' come back zero and must not be
    read.

    cfg.clip_rect renders a cached superset pair list (cached_binning from
    compute_binning_cache(dilate_tiles=) at a nearby camera): each
    gaussian's fresh rect gates its pairs in the kernels, and a gaussian
    with no fresh pairs gets an empty rect, so its stale cached pairs
    contribute nothing. tile_ids [K] int (ascending, unique; with
    cached_binning, every mode but track_contrib): only these tiles
    render (K3, and K4 for the gradient); the other tiles' outputs are
    zero and are not to be read.

    y_offset / full_height (the tile-slab sharded render): render the rows
    [y_offset, y_offset + cfg.height) of a full_height-tall image; the slab
    origin is folded into the splat→pixel transform, so binning and blend
    run unchanged on local rows."""
    cfg.check()
    if done0 is not None and not cfg.bwd_extras_only:
        raise ValueError("sampled-pixel done0 masks require "
                         "cfg.bwd_extras_only")
    if (cfg.clip_rect or tile_ids is not None) and cached_binning is None:
        raise ValueError("clip_rect and tile_ids render a cached binning "
                         "(compute_binning_cache)")
    width, height = cfg.width, cfg.height
    n = means3d.shape[0]
    opac = torch.reshape(opacities, (n,))
    # the viewer's and the tracker's blends take flat detached: no graph
    # through preprocess, so its forward-only kernel serves them
    forward_only = cfg.fwd_viewer or cfg.track_contrib
    with torch.no_grad() if forward_only else contextlib.nullcontext():
        pre = preprocess_gaussians(
            means3d, scales, rotations, cam.w2v, cam.full_proj, cam.campos,
            width, height, opac, color=colors, shs=shs, sh_degree=sh_degree,
            alive=alive, conic_cull=cfg.conic_cull and cached_binning is None,
            y_offset=y_offset, full_height=full_height)
    binning = (cached_binning if cached_binning is not None
               else bin_gaussians(pre, width, height))
    with span("raster"):
        E = extras.shape[1] if extras is not None else 0
        grid_x = (width + TILE - 1) // TILE
        T_used = pre.T if t_offset is None else pre.T + t_offset
        rect = None
        if cfg.clip_rect:
            has_pairs = (pre.tiles_touched > 0)[:, None]
            rect = (pre.rect_min,
                    torch.where(has_pairs, pre.rect_max, pre.rect_min))
        flat = pack_flat_cols(T_used, pre.xy, pre.normal_view, opac, pre.color,
                              extras, rect=rect)
        bargs = (binning.sorted_gid, binning.tile_start, binning.tile_end,
                 grid_x, E)
        sel = (None if tile_ids is None else torch.as_tensor(
            tile_ids, device=flat.device).to(torch.int32).contiguous())
        kw = dict(tile_ids=sel, clip_rect=cfg.clip_rect)
        ids = tw = None
        if cfg.fwd_viewer:
            out, iout = bv.blend_fwd(flat.detach(), *bargs, viewer=True, **kw)
        elif cfg.track_contrib:
            out, iout, ids, tw = bv.blend_fwd(flat.detach(), *bargs,
                                              track=True, tile_ids=sel)
        else:
            out, iout = bv.blend(flat, *bargs,
                                 (binning.gid_order, binning.run_start),
                                 no_dist=cfg.no_depth_dist,
                                 extras_only=cfg.bwd_extras_only, done0=done0,
                                 **kw)
        if sel is not None:
            # the listed tiles' rows in a whole frame of zeros
            nt = binning.tile_start.shape[0]
            rows = sel.long()
            out = out.new_zeros((nt,) + out.shape[1:]).index_put((rows,), out)
            iout = iout.new_zeros((nt,) + iout.shape[1:]).index_put((rows,),
                                                                     iout)
        maps = maps_from_tiles(out, iout, width, height, E)
        bg = torch.as_tensor(bg, dtype=torch.float32, device=means3d.device)
        color = maps["color_nobg"] + maps["final_T"][..., None] * bg
        blend = BlendOut(color=color, depth=maps["depth"],
                         alpha=1.0 - maps["final_T"], normal=maps["normal"],
                         median_depth=maps["median_depth"],
                         distortion=maps["distortion"],
                         extra=maps["extra"] if extras is not None else None,
                         final_T=maps["final_T"], n_contrib=maps["n_contrib"],
                         contrib_ids=(tiles_to_map(ids, width, height)
                                      if ids is not None else None),
                         contrib_w=(tiles_to_map(tw, width, height)
                                    if tw is not None else None),
                         extra_tiles=out[:, 10:10 + E] if E else None)
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


def compute_binning_cache(params, cam: CameraMats, width: int,
                          height: int, dilate_tiles: int = 0,
                          conic_cull: bool = False) -> BinningOut:
    """The frozen-geometry binning of one camera (semantic training: the
    geometry never moves, so each camera's pair list is computed once):
    preprocess with the opacity-aware rects, as every render does, then
    bin. Pass it as rasterize(..., cached_binning=...).

    dilate_tiles > 0 expands every visible gaussian's rect by that many
    tiles per side: a SUPERSET pair list that a nearby camera renders
    exactly through RasterizeConfig(clip_rect=True), as long as its fresh
    rects stay inside the dilated ones. conic_cull drops the pairs whose
    tile the conic cannot reach (off when dilating, as in the JAX
    package)."""
    with torch.no_grad():
        g = params.raster_inputs()
        pre = preprocess_gaussians(
            g.xyz, g.scales, g.rotations, cam.w2v, cam.full_proj, cam.campos,
            width, height, g.opacities, color=torch.zeros_like(g.xyz),
            alive=params.alive, conic_cull=conic_cull and not dilate_tiles)
        return bin_gaussians(pre, width, height, dilate_tiles=dilate_tiles)


def pack_extras(means3d, scales, rotations, opacities, cam: CameraMats,
                width: int, height: int, extras, alive=None):
    """The packed table [N, 21+E] of one view with `extras` as its feature
    columns, for the extras_only kernels (K1/K2 extras_only, K3/K4, K5/K6):
    preprocess with zero color (they read none), then pack."""
    opac = torch.reshape(opacities, (means3d.shape[0],))
    pre = preprocess_gaussians(
        means3d, scales, rotations, cam.w2v, cam.full_proj, cam.campos,
        width, height, opac, color=torch.zeros_like(means3d), alive=alive)
    return pack_flat_cols(pre.T, pre.xy, pre.normal_view, opac, pre.color,
                          extras)


def rasterize_extras_tiles(means3d, scales, rotations, opacities,
                           cam: CameraMats, cfg: RasterizeConfig, extras,
                           binning: BinningOut, sel_tiles, alive=None):
    """The features of the tiles sel_tiles [K] (ascending, unique) alone:
    preprocess, pack and K1 extras_only over the tile list (K3) on the
    camera's cached binning → [K, 256, E] (row-major pixels within each
    tile). Differentiable in `extras` (K4 for the blend); pass the geometry
    detached."""
    E = extras.shape[1]
    flat = pack_extras(means3d, scales, rotations, opacities, cam,
                       cfg.width, cfg.height, extras, alive)
    ids = sel_tiles.to(device=flat.device, dtype=torch.int32).contiguous()
    out, _ = bv.blend(flat, binning.sorted_gid, binning.tile_start,
                      binning.tile_end, (cfg.width + TILE - 1) // TILE, E,
                      (binning.gid_order, binning.run_start),
                      extras_only=True, tile_ids=ids)
    return out[:, 10:10 + E].transpose(1, 2)
