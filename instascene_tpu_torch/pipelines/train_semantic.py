"""Semantic feature lifting: the spatial-track priors, the contrastive step
and the trainer that drives them.

Port of instascene_tpu/pipelines/train_semantic.py:37-185 (`render_features`,
`_pix_to_tile`, `_done0_from_idx`, `_draw_sv_pixel_idx`,
`single_view_and_3d_losses` with the tile-major fetch from `extra_tiles`),
:188-243 (the step's dataclasses), :245-306 (`_mv_tile_subsample_loss`),
:309-406 (`_mv_full_loss_merged`), :409-457 (`_sparse_view_feats`,
`_mv_full_loss_sparse`), :460-514 (`_mv_full_loss` with the sampled-pixel
done masks), :517-691 (`semantic_train_step`, with the sparse-pixel branch
and its dense fallback), :694-907 and :990-1103 (`SegSplatting`:
`robust_semantic_priors`, `_precompute_binning`, `_precompute_sampling`,
`_camera_bundles`, `_max_labels`, `train_segfeat`, `save`) and
:1110-1160 (`render_views`) and :1163-1177 (`export_segment_results`).

Stage 1 renders every training view with contributor tracking (K1 track)
and runs the spatial-track mask clustering on the host (output_dict.npy,
sam/mask_sorted, sam/mask_filtered); stage 2 trains the 16-channel features
with frozen geometry: single-view ProtoNCE on two segmap types and 3D
ProtoNCE every step, multi-view ProtoNCE over a window of views every 10th
step, through K1 and K2 in their extras_only modes with sampled-pixel done
masks; then the HDBSCAN instance export. Three opt-in variants:
  * --mv_tile_subsample K: the window's loss reads K random tiles per view,
    rendered alone through K1/K2 over a tile list (K3/K4);
  * --mv_merged 1: the window's views blend in one K1 launch and one K2
    launch over their concatenated tables (tiles_per_view);
  * --sparse_px 1: only the drawn pixels blend (K5/K6); when a tile draws
    more than the S slots, the step takes the dense path instead (counted
    in cuda_build.LAUNCHES["sparse_fallback"]).

What differs from the JAX package:
  * the binning cache is each camera's BinningOut, computed once (no probe
    pass, no pair caps, no visit layout);
  * the pixel draws come from a torch.Generator; `draws=` injects index sets
    instead (tests inject JAX's, replayed from its key splits), and all of a
    step's draws are made before it renders, since they depend only on the
    segmaps, the samplers and the frozen visibility;
  * autograd reaches the features alone: the packed table is built from
    detached geometry (GaussianModel.raster_inputs(detach=True)), as JAX
    differentiates with respect to seg_feature only;
  * the tile subset has no pair cap: K3/K4 walk each selected tile's
    whole range, so nothing is truncated (JAX's mv_trunc is always 0 here);
  * the merged window is one launch each way (JAX groups the views to fit
    its scalar-prefetch budget);
  * the sparse path's overflow test is a host read and a Python branch
    (JAX's lax.cond); the 3D loss draws from its sampler pack, so the
    sparse path needs no visibility mask.
With `dp`, SegSplatting is one rank of a camera-batch data-parallel group
(JAX :909-986): rank 0 computes and writes the priors and the others load
them, each contrastive step pops `dp` cameras and this rank trains on its
own through parallel/data_parallel.dp_semantic_step (no multi-view
window, as in the JAX package), and rank 0 saves and exports.
"""

from __future__ import annotations

import os
import random
import shutil
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..cuda_build import LAUNCHES
from ..models import gaussians as gmod
from ..models.gaussians import normalize_features
from ..models.optimizer import (GEOMETRY_FIELDS, adam_step, init_adam_state,
                                semantic_lrs)
from ..ops import blend_visits as bv
from ..ops.binning import BinningOut, merge_binnings
from ..ops.blend_sparse import blend_sparse, pick_sparse_s, spix_from_idx
from ..ops.preprocess import TILE, preprocess_gaussians
from ..ops.rasterize import (CameraMats, RasterizeConfig,
                             compute_binning_cache, pack_extras, rasterize,
                             rasterize_extras_tiles)
from ..semantic.contrastive import (contrastive_loss, sample_from_ids,
                                    sample_valid_pixels, valid_ids_pack)
from ..semantic.spatial_track import GausCluster
from ..utils.profiling import TraceWindow, span, stage
from .train import camera_tensors


def render_features(params: gmod.GaussianModel, cam: CameraMats, bg,
                    cfg: RasterizeConfig, seg_feature=None,
                    cached_binning: Optional[BinningOut] = None, done0=None):
    """Render with `seg_feature` (default the model's), L2-normalised, as
    the extra channels. Geometry enters detached: gradients reach only the
    features."""
    with span("model"):
        feat = seg_feature if seg_feature is not None else params.seg_feature
        if feat is not None:
            feat = normalize_features(feat)
        g = params.raster_inputs(detach=True)
        shs = params.features().detach()
    return rasterize(*g, cam, bg, cfg, shs=shs,
                     sh_degree=params.active_sh_degree, extras=feat,
                     alive=params.alive, cached_binning=cached_binning,
                     done0=done0)


def _pix_to_tile(idx, width: int, tile: int, grid_x: int):
    """Flat pixel index → (tile index, row-major position in the tile)."""
    y, x = idx // width, idx % width
    return (y // tile) * grid_x + (x // tile), (y % tile) * tile + (x % tile)


def _done0_from_idx(idx_list, width: int, height: int, tile: int = TILE):
    """[num_tiles, 1, tile²] int32 done mask: 1 everywhere but the sampled
    flat pixel indices of idx_list, so K1 extras_only skips the pixels the
    loss never reads."""
    grid_x = (width + tile - 1) // tile
    grid_y = (height + tile - 1) // tile
    d = torch.ones((grid_x * grid_y, 1, tile * tile), dtype=torch.int32,
                   device=idx_list[0].device)
    for idx in idx_list:
        t, p2 = _pix_to_tile(idx, width, tile, grid_x)
        d[t, 0, p2] = 0
    return d


@dataclass
class SemanticCamera:
    """One training view's constant inputs to the semantic step (built once
    by SegSplatting._camera_bundles): camera, segmaps, the frozen-geometry
    binning, and the valid-index sampler packs with their valid counts
    (host ints, so drawing needs no device read)."""
    w2v: torch.Tensor            # [4,4]
    full_proj: torch.Tensor      # [4,4]
    campos: torch.Tensor         # [3]
    segmap: torch.Tensor         # [H,W] int raw/filtered instance labels
    sorted_segmap: torch.Tensor  # [H,W] int cluster-consistent labels
    binning: BinningOut
    seg_samp: torch.Tensor       # valid_ids_pack(segmap > 0)
    sorted_samp: torch.Tensor    # valid_ids_pack(sorted_segmap > 0)
    vis3d_samp: torch.Tensor     # valid_ids_pack(visible & 3D label > 0)
    seg_nv: int
    sorted_nv: int
    vis3d_nv: int

    @property
    def mats(self) -> CameraMats:
        return CameraMats(self.w2v, self.full_proj, self.campos)


@dataclass
class SemanticMVBlock:
    """The every-10th-step multi-view window: its views, in order (their
    sorted segmaps are the labels), and for --mv_tile_subsample the tiles
    each view renders."""
    cams: List[SemanticCamera]
    sel_tiles: Optional[torch.Tensor] = None   # [V, K] int ascending ids


@dataclass
class SemanticHypers:
    """Constants shared by every step."""
    bg: torch.Tensor
    lrs: dict                    # per-field learning rates (semantic_lrs)
    lam_sv: float
    lam_mv: float
    lam_3d: float
    seg3d_labels: torch.Tensor   # [capacity] int 3D prior labels
    class_feat: Optional[torch.Tensor] = None   # [max_labels, E] anchors


@dataclass(frozen=True)
class SemanticStepConfig:
    raster: RasterizeConfig      # bwd_extras_only=True
    batch: int
    max_labels: int
    consider_negative: bool = False
    mv_merged: bool = False      # the full window in one launch (K1/K2)
    sparse_px: bool = False      # only the drawn pixels blend (K5/K6)


def _sv_types(cam: SemanticCamera, cf):
    """(segmap, sampler pack, valid count, mask type) per single-view loss:
    the raw/filtered segmap, and with class anchors the sorted one."""
    out = [(cam.segmap, cam.seg_samp, cam.seg_nv, 0)]
    if cf is not None:
        out.append((cam.sorted_segmap, cam.sorted_samp, cam.sorted_nv, 1))
    return out


def _grid(cam: SemanticCamera):
    """(width, height, tiles per row, tiles) of a view."""
    H, W = cam.sorted_segmap.shape
    grid_x = (W + TILE - 1) // TILE
    return W, H, grid_x, grid_x * ((H + TILE - 1) // TILE)


def _mv_pack(mv: SemanticMVBlock):
    """The window's valid pixels as one sampler pack over the concatenated
    sorted segmaps (ascending, as the prefix-sum search of the JAX package
    orders them) and their count."""
    hw = mv.cams[0].sorted_segmap.numel()
    parts = [c.sorted_samp[:c.sorted_nv].to(torch.int64) + v * hw
             for v, c in enumerate(mv.cams)]
    nv = sum(c.sorted_nv for c in mv.cams)
    return torch.cat(parts + [parts[0].new_tensor([nv])]), nv


def _tile_labels(mv: SemanticMVBlock) -> torch.Tensor:
    """[V·K·256] labels of the tile-subsampled window: each selected tile's
    pixels (views, tiles, then row-major within the tile) read from its
    view's sorted segmap; pixels past the image's edge get 0 (invalid), so
    no rendered feature is paired with a clamped label."""
    W, H, grid_x, _ = _grid(mv.cams[0])
    sel = mv.sel_tiles.to(torch.int64)                     # [V, K]
    lane = torch.arange(TILE * TILE, device=sel.device)
    yy = (sel // grid_x)[..., None] * TILE + lane // TILE  # [V, K, 256]
    xx = (sel % grid_x)[..., None] * TILE + lane % TILE
    maps = torch.stack([c.sorted_segmap.reshape(-1) for c in mv.cams])
    lab = torch.gather(maps, 1, (yy * W + xx).clamp(max=H * W - 1)
                       .reshape(len(mv.cams), -1)).reshape(yy.shape)
    return torch.where((yy < H) & (xx < W), lab, 0).reshape(-1)


def draw_step_pixels(generator: torch.Generator, cam: SemanticCamera,
                     mv: Optional[SemanticMVBlock], cf, batch: int,
                     consider_negative: bool) -> dict:
    """All index sets one step reads, drawn before it renders (they depend
    only on segmaps, samplers and the frozen visibility): {"sv": one per
    single-view loss, "d3": the 3D set, "mv": the window's set (flat index
    over the concatenated views, or with sel_tiles over _tile_labels'
    pixels), when mv is given}. Uniform with replacement over each valid
    set; with consider_negative the raw segmap's set is uniform over all
    its pixels."""
    sv = []
    for seg, pack, nv, mask_type in _sv_types(cam, cf):
        if consider_negative and mask_type == 0:
            sv.append(torch.randint(0, seg.numel(), (batch,),
                                    generator=generator, device=seg.device))
        else:
            sv.append(sample_from_ids(generator, pack, batch, nv)[0])
    out = {"sv": sv, "d3": sample_from_ids(generator, cam.vis3d_samp, batch,
                                           cam.vis3d_nv)[0]}
    if mv is not None and mv.sel_tiles is not None:
        out["mv"] = sample_valid_pixels(generator, _tile_labels(mv) > 0,
                                        batch)[0]
    elif mv is not None:
        pack, nv = _mv_pack(mv)
        out["mv"] = sample_from_ids(generator, pack, batch, nv)[0]
    return out


def single_view_and_3d_losses(seg_feature, fetch, cam: SemanticCamera,
                              hyp: SemanticHypers, scfg: SemanticStepConfig,
                              draws: dict):
    """Single-view ProtoNCE on the raw/filtered (weight 0.5) and, with class
    anchors, the sorted (weight 1) segmap, plus 3D ProtoNCE over visible
    gaussians (reference train_semantic.py:108-141, :175-195). fetch(si,
    idx) → [batch, E]: the rendered features of the si-th set's pixels idx
    (from the kernel's tile-major output, or the sparse slots)."""
    cf = hyp.class_feat
    total = seg_feature.new_zeros(())
    for si, ((seg, _, nv, mask_type), idx) in enumerate(
            zip(_sv_types(cam, cf), draws["sv"])):
        idx = idx.to(torch.int64)
        neg = scfg.consider_negative and mask_type == 0
        if not (neg or nv > 0):
            continue
        cl = contrastive_loss(fetch(si, idx), seg.reshape(-1)[idx],
                              scfg.max_labels,
                              predef_u=cf if mask_type == 1 else None,
                              consider_negative=neg)
        total = total + cl * hyp.lam_sv * (1.0 if mask_type == 1 else 0.5)
    if cam.vis3d_nv > 0:
        idx = draws["d3"].to(torch.int64)
        f3 = normalize_features(seg_feature[idx])
        cl = contrastive_loss(f3, hyp.seg3d_labels[idx], scfg.max_labels,
                              predef_u=cf)
        total = total + cl * hyp.lam_3d
    return total


def _pack_features(params, cam: CameraMats, cfg: RasterizeConfig, featn):
    """The packed table [N, 21+E] of one view with the normalised features
    featn as its extras, on detached geometry."""
    return pack_extras(*params.raster_inputs(detach=True), cam, cfg.width,
                       cfg.height, featn, params.alive)


def _window_labels(mv: SemanticMVBlock):
    return torch.cat([c.sorted_segmap.reshape(-1) for c in mv.cams])


def _mv_full_loss(params, seg_feature, mv: SemanticMVBlock, hyp, scfg,
                  idx):
    """Multi-view ProtoNCE over the window (reference
    train_semantic.py:145-172): every view renders with a done mask that
    latches all but its own sampled pixels, whose features are fetched from
    its tile-major output."""
    cfg = scfg.raster
    W, H, grid_x, T = _grid(mv.cams[0])
    hw = H * W
    idx = idx.to(torch.int64)
    view_of = idx // hw
    t, p2 = _pix_to_tile(idx % hw, W, TILE, grid_x)
    done = torch.ones((len(mv.cams), T, 1, TILE * TILE), dtype=torch.int32,
                      device=idx.device)
    done[view_of, t, 0, p2] = 0
    f_mv = 0.0
    for v, cam in enumerate(mv.cams):
        out = render_features(params, cam.mats, hyp.bg, cfg, seg_feature,
                              cam.binning, done0=done[v])
        fv = out.blend.extra_tiles[t, :, p2]
        f_mv = f_mv + torch.where((view_of == v)[:, None], fv, 0.0)
    return contrastive_loss(f_mv, _window_labels(mv)[idx], scfg.max_labels,
                            predef_u=hyp.class_feat)


def _mv_full_loss_merged(params, seg_feature, mv: SemanticMVBlock, hyp,
                         scfg, idx):
    """The same loss through one merged render: the window's packed tables
    and binnings concatenated along the tile axis (merge_binnings), and one
    K1 extras_only launch (tiles_per_view; no done masks, as the JAX
    package renders it) blends all V·T tiles; one K2 launch and one
    segment sum take the gradient back. Each view's values are bit for bit
    its own render's."""
    cfg = scfg.raster
    featn = normalize_features(seg_feature)
    W, H, grid_x, _ = _grid(mv.cams[0])
    flat, b, T = merge_binnings([
        (_pack_features(params, cam.mats, cfg, featn), cam.binning)
        for cam in mv.cams])
    E = featn.shape[1]
    out, _ = bv.blend(flat, b.sorted_gid, b.tile_start, b.tile_end, grid_x,
                      E, (b.gid_order, b.run_start), extras_only=True,
                      tiles_per_view=T)
    idx = idx.to(torch.int64)
    hw = H * W
    t, p2 = _pix_to_tile(idx % hw, W, TILE, grid_x)
    f = out[(idx // hw) * T + t, 10:10 + E, p2]
    return contrastive_loss(f, _window_labels(mv)[idx], scfg.max_labels,
                            predef_u=hyp.class_feat)


def _mv_tile_subsample_loss(params, seg_feature, mv: SemanticMVBlock, hyp,
                            scfg, idx):
    """Multi-view ProtoNCE over the tile-subsampled window (the JAX
    package's --mv_tile_subsample, no reference equivalent): each view
    renders only its selected tiles (K3, K4 for the gradient), and idx
    draws uniformly over their label-valid pixels (_tile_labels)."""
    cfg = scfg.raster
    featn = normalize_features(seg_feature)
    feats = [rasterize_extras_tiles(
        *params.raster_inputs(detach=True), cam.mats, cfg, featn,
        cam.binning, mv.sel_tiles[v], alive=params.alive).reshape(
            -1, featn.shape[1])
        for v, cam in enumerate(mv.cams)]
    idx = idx.to(torch.int64)
    return contrastive_loss(torch.cat(feats)[idx], _tile_labels(mv)[idx],
                            scfg.max_labels, predef_u=hyp.class_feat)


def _sparse_plan(cam: SemanticCamera, mv: Optional[SemanticMVBlock],
                 scfg: SemanticStepConfig, draws: dict):
    """The slot lists of the sparse-pixel path: the single-view sets packed
    together ({"sv": (spix, t_of, slot_of)}) and, for the full window mv,
    one list per view ({"mv": ([spix per view], t_of, slot_of)}, t/slot
    merged by the view that owns each draw). None when some tile drew more
    than its S slots: the step then takes the dense path (one host read;
    counted in cuda_build.LAUNCHES["sparse_fallback"])."""
    W, H, _, T = _grid(cam)
    idx_all = torch.cat([i.to(torch.int64) for i in draws["sv"]])
    spix, t_of, slot_of, overflow = spix_from_idx(
        idx_all, W, H, TILE, pick_sparse_s(idx_all.shape[0], T))
    plan = {"sv": (spix, t_of, slot_of)}
    if mv is not None:
        S_mv = pick_sparse_s(scfg.batch, len(mv.cams) * T)
        idx = draws["mv"].to(torch.int64)
        view_of, pix = idx // (H * W), idx % (H * W)
        spix_v, tl, sl = [], None, None
        for v in range(len(mv.cams)):
            own = view_of == v
            sp, t_v, s_v, ov = spix_from_idx(pix, W, H, TILE, S_mv,
                                             valid=own)
            overflow = overflow | ov
            spix_v.append(sp)
            tl = t_v if tl is None else torch.where(own, t_v, tl)
            sl = s_v if sl is None else torch.where(own, s_v, sl)
        plan["mv"] = (spix_v, tl, sl)
    if bool(overflow):
        LAUNCHES["sparse_fallback"] += 1
        return None
    return plan


def _sparse_view_feats(params, featn, cam: SemanticCamera,
                       cfg: RasterizeConfig, spix):
    """One view's features at its drawn pixels: feat [T, S, E] (K5; K6
    and the segment sum for the gradient)."""
    flat = _pack_features(params, cam.mats, cfg, featn)
    feat, _ = blend_sparse(flat, cam.binning, spix, _grid(cam)[2],
                           featn.shape[1])
    return feat


def _mv_full_loss_sparse(params, seg_feature, mv: SemanticMVBlock, hyp,
                         scfg, idx, plan_mv):
    """The window's loss through per-view sparse renders: only the drawn
    pixels blend, each at the slot _sparse_plan gave it."""
    spix_v, tl, sl = plan_mv
    featn = normalize_features(seg_feature)
    idx = idx.to(torch.int64)
    view_of = idx // mv.cams[0].sorted_segmap.numel()
    f_mv = 0.0
    for v, cam in enumerate(mv.cams):
        feat = _sparse_view_feats(params, featn, cam, scfg.raster, spix_v[v])
        f_mv = f_mv + torch.where((view_of == v)[:, None], feat[tl, sl], 0.0)
    return contrastive_loss(f_mv, _window_labels(mv)[idx], scfg.max_labels,
                            predef_u=hyp.class_feat)


def semantic_loss(params, seg_feature, cam: SemanticCamera,
                  mv: Optional[SemanticMVBlock], hyp: SemanticHypers,
                  scfg: SemanticStepConfig, draws: dict,
                  mark: Callable[[str], None] = lambda name: None):
    """The step's loss, differentiable in seg_feature: the single-view and
    3D terms on `cam`, plus λ_mv · the multi-view term when mv is given.
    The single view renders with the sampled-pixel mask (K1/K2
    extras_only), or with scfg.sparse_px only at the drawn pixels (K5/K6;
    the full window too, unless scfg.mv_merged). The full window renders
    per view, or merged (scfg.mv_merged); a window with sel_tiles renders
    those tiles (K3/K4). The render and the losses are stages
    (utils/profiling.stage) whose ends call mark("render") and
    mark("loss")."""
    cfg = scfg.raster
    mv_full = (mv is not None and mv.sel_tiles is None
               and sum(c.sorted_nv for c in mv.cams) > 0)
    with stage("render", mark):
        plan = None
        if scfg.sparse_px and not (mv_full and scfg.mv_merged):
            plan = _sparse_plan(cam, mv if mv_full else None, scfg, draws)
        if plan is None:
            done0 = _done0_from_idx([i.to(torch.int64) for i in draws["sv"]],
                                    cfg.width, cfg.height)
            tiles = render_features(params, cam.mats, hyp.bg, cfg,
                                    seg_feature, cam.binning,
                                    done0=done0).blend.extra_tiles
            grid_x = _grid(cam)[2]

            def fetch(si, idx):
                t, p2 = _pix_to_tile(idx, cfg.width, TILE, grid_x)
                return tiles[t, :, p2]                       # [batch, E]
        else:
            feat_sv = _sparse_view_feats(params,
                                         normalize_features(seg_feature),
                                         cam, cfg, plan["sv"][0])
            _, t_of, slot_of = plan["sv"]
            b = scfg.batch

            def fetch(si, idx):
                return feat_sv[t_of[si * b:(si + 1) * b],
                               slot_of[si * b:(si + 1) * b]]
    with stage("loss", mark):
        total = single_view_and_3d_losses(seg_feature, fetch, cam, hyp,
                                          scfg, draws)
        if mv_full:
            if plan is not None:
                cl = _mv_full_loss_sparse(params, seg_feature, mv, hyp, scfg,
                                          draws["mv"], plan["mv"])
            elif scfg.mv_merged:
                cl = _mv_full_loss_merged(params, seg_feature, mv, hyp,
                                          scfg, draws["mv"])
            else:
                cl = _mv_full_loss(params, seg_feature, mv, hyp, scfg,
                                   draws["mv"])
            total = total + cl * hyp.lam_mv
        elif mv is not None and mv.sel_tiles is not None:
            total = total + _mv_tile_subsample_loss(
                params, seg_feature, mv, hyp, scfg, draws["mv"]) * hyp.lam_mv
    return total


def semantic_gradient(params: gmod.GaussianModel, cam: SemanticCamera,
                      mv: Optional[SemanticMVBlock], hyp: SemanticHypers,
                      scfg: SemanticStepConfig,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[dict] = None,
                      mark: Callable[[str], None] = lambda name: None):
    """The step's loss and its gradient with respect to seg_feature → (loss
    detached, gradient): the first half of semantic_train_step, with its
    draws and stages ("draws", "render", "loss", "backward")."""
    dev = params.device
    with stage("draws", mark):
        if draws is None:
            draws = draw_step_pixels(generator, cam, mv, hyp.class_feat,
                                     scfg.batch, scfg.consider_negative)
        else:
            as_t = lambda a: torch.as_tensor(np.asarray(a) if not isinstance(
                a, torch.Tensor) else a).to(device=dev, dtype=torch.int64)
            draws = {k: ([as_t(a) for a in v] if k == "sv" else as_t(v))
                     for k, v in draws.items()}
    seg = params.seg_feature.detach().requires_grad_(True)
    loss = semantic_loss(params, seg, cam, mv, hyp, scfg, draws, mark)
    with stage("backward", mark):
        (g,) = torch.autograd.grad(loss, [seg])
    return loss.detach(), g


@torch.no_grad()
def semantic_adam(params: gmod.GaussianModel, opt_state, g,
                  hyp: SemanticHypers):
    """Adam on the features alone (geometry frozen) → (params,
    opt_state)."""
    return adam_step(params, {"seg_feature": g}, opt_state, hyp.lrs,
                     frozen_fields=GEOMETRY_FIELDS)


def semantic_train_step(params: gmod.GaussianModel, opt_state,
                        cam: SemanticCamera, mv: Optional[SemanticMVBlock],
                        hyp: SemanticHypers, scfg: SemanticStepConfig,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[dict] = None,
                        on_stage: Optional[Callable[[str], None]] = None):
    """One contrastive step → (params, opt_state, loss): the single-view
    and 3D losses on `cam`, plus the multi-view loss over `mv` when given,
    differentiated with respect to seg_feature alone, then Adam on the
    features (geometry frozen). draws: injected index sets in
    draw_step_pixels' layout (ints, any device), else they are drawn from
    `generator`. on_stage(name) is called as each stage ends: "draws",
    "render", "loss", "backward", "adam". The step is the span "step", its
    stages spans of their names (utils/profiling.py)."""
    mark = on_stage or (lambda name: None)
    with span("step"):
        loss, g = semantic_gradient(params, cam, mv, hyp, scfg, generator,
                                    draws, mark)
        with stage("adam", mark):
            params, opt_state = semantic_adam(params, opt_state, g, hyp)
    return params, opt_state, loss


class SegSplatting:
    """The semantic stage on `device` (CUDA unless "cpu" is asked for):
    reference train_semantic.py SegSplatting. dp > 0: one rank of the
    torch.distributed `group` (default: the world), whose size must be
    dp."""

    def __init__(self, dataset, opt, pipe, output_root: str = "output",
                 dp: int = 0, device=None, group=None):
        self.dp, self.group, self.rank = int(dp), group, 0
        if self.dp:
            if dist.get_world_size(group) != self.dp:
                raise ValueError(f"--dp {self.dp} in a process group of "
                                 f"{dist.get_world_size(group)} ranks")
            self.rank = dist.get_rank(group)
        self.device = resolve_device(device)
        self.dataset = dataset
        self.opt = opt
        self.pipe = pipe
        self.data_dir = dataset.source_path
        sp = self.data_dir.rstrip("/").split("/")
        self.model_path = os.path.join(
            output_root, sp[-2] if len(sp) > 1 else "scene", sp[-1],
            dataset.model_path)
        self.params = gmod.load_ply(
            os.path.join(self.data_dir, "point_cloud.ply"), max_sh_degree=3,
            seg_feat_dim=dataset.seg_feat_dim,
            load_seg_feat=dataset.load_seg_feat, device=self.device)
        self.bg = torch.tensor([1.0, 1.0, 1.0] if dataset.white_background
                               else [0.0, 0.0, 0.0], device=self.device)
        self.class_feat = None
        self.scene = None
        self.rng = random.Random(0)
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self.timings = {}          # stage → host seconds
        # the CLI's --profile_trace dir and [start, end) iterations
        self.profile_trace = None
        self.profile_window = (100, 120)

    def _load_scene(self):
        from ..data.dataset import Scene
        self.scene = Scene(self.dataset, load_images=True,
                           output_root=os.path.dirname(os.path.dirname(
                               os.path.dirname(self.model_path)))
                           or "output")
        self.cam_objs = self.scene.get_train_cameras()
        self.cams = [camera_tensors(c, self.device) for c in self.cam_objs]
        self._max_labels_memo = None

    def tracker_view(self, view_idx: int):
        """One view's contributor tracking (K1 track): (contrib_ids
        [H,W,10] numpy, the view's segmap)."""
        cam_obj = self.cam_objs[view_idx]
        cfg = RasterizeConfig(width=int(cam_obj.width),
                              height=int(cam_obj.height), track_contrib=True)
        with torch.no_grad():
            out = render_features(self.params, self.cams[view_idx].mats,
                                  self.bg, cfg)
        return out.blend.contrib_ids.cpu().numpy(), np.asarray(
            cam_obj.segmap)

    def robust_semantic_priors(self):
        """Stage 1 (reference train_semantic.py:33-72). Under dp, rank 0
        computes and writes the priors first; the other ranks then load
        them (self.priors says which this rank did)."""
        if not self.dp:
            return self._semantic_priors()
        from ..parallel.launch import rank0_first
        with rank0_first(self.group):
            return self._semantic_priors()

    def _semantic_priors(self):
        if self.dataset.preload_robust_semantic and os.path.exists(
                self.dataset.preload_robust_semantic):
            seg_dir = self.dataset.preload_robust_semantic
        else:
            seg_dir = os.path.join(self.model_path, "semantic_association")
            os.makedirs(seg_dir, exist_ok=True)
        self._load_scene()
        n_alive = self.params.n_alive()
        t0 = time.perf_counter()
        trace_s = [0.0]

        def trace_fn(view_idx: int):
            ts = time.perf_counter()
            res = self.tracker_view(view_idx)
            trace_s[0] += time.perf_counter() - ts
            return res

        gc = GausCluster(n_alive, self.params.xyz[:n_alive].cpu().numpy(),
                         [c.image_name for c in self.cam_objs], trace_fn)
        self.gausclustering = gc
        out_path = os.path.join(seg_dir, "output_dict.npy")
        self.priors = "loaded" if os.path.exists(out_path) else "computed"
        if not os.path.exists(out_path):
            for d in ("mask_filtered", "mask_sorted", "mask_undersegment"):
                p = os.path.join(self.data_dir, "sam", d)
                if os.path.exists(p):
                    shutil.rmtree(p)
            gc.maskclustering(seg_dir)
        self.timings["tracker renders"] = trace_s[0]
        self.timings["spatial track"] = time.perf_counter() - t0 - trace_s[0]

        priors = np.load(out_path, allow_pickle=True).item()
        self.seg3d_masks = priors["mask_3d_labels"]
        self.seg3d_labels = np.argmax(
            self.seg3d_masks.astype(np.int16), axis=1).astype(np.int32)
        if not os.path.exists(os.path.join(self.data_dir, "sam/mask_sorted")):
            gc.rearrange_mask(os.path.join(self.data_dir, "sam/mask"),
                              priors["mask_2d_clusters"])
        if (len(priors["underseg_mask_ids"]) > 0 and
                not os.path.exists(os.path.join(self.data_dir,
                                                "sam/mask_filtered"))):
            gc.filter_undersegment_mask(
                os.path.join(self.data_dir, "sam/mask"),
                priors["underseg_mask_ids"])

        self._load_scene()          # picks up mask_sorted / mask_filtered
        self.params, self.class_feat = gmod.set_3d_feat(
            self.params, self.seg3d_masks, self.dataset.seg_feat_dim,
            gram_feat=self.opt.gram_feat_3d)
        lab = np.zeros(self.params.capacity, np.int32)
        lab[:len(self.seg3d_labels)] = self.seg3d_labels
        self.seg3d_labels_padded = torch.as_tensor(lab, device=self.device)

    def _precompute_binning(self):
        """Frozen geometry: each camera's binning, computed once."""
        self.binning_cache = [
            compute_binning_cache(self.params, ct.mats, int(c.width),
                                  int(c.height))
            for ct, c in zip(self.cams, self.cam_objs)]
        return self.binning_cache

    def _precompute_sampling(self):
        """Per camera the valid-index sampler packs of the raw and sorted
        segmaps and of the visible gaussians with a 3D label, and their
        valid counts (one host read each, here)."""
        lab3d_ok = self.seg3d_labels_padded > 0
        p = self.params
        packs = []
        for ct, cam in zip(self.cams, self.cam_objs):
            hw = int(cam.width) * int(cam.height)
            row = []
            for m in (cam.segmap, cam.sorted_segmap):
                valid = (torch.as_tensor(m, device=self.device).reshape(-1)
                         > 0 if m is not None else
                         torch.zeros(hw, dtype=torch.bool, device=self.device))
                row.append(valid_ids_pack(valid))
            with torch.no_grad():
                g = p.raster_inputs()
                pre = preprocess_gaussians(
                    g.xyz, g.scales, g.rotations, ct.w2v, ct.full_proj,
                    ct.campos, int(cam.width), int(cam.height), g.opacities,
                    color=torch.zeros_like(p.xyz), alive=p.alive)
            row.append(valid_ids_pack(pre.valid & (pre.radius > 0)
                                      & lab3d_ok))
            packs.append(row)
        self.sampling_packs = packs
        return packs

    def _camera_bundles(self) -> List[SemanticCamera]:
        bundles = []
        for ci, (ct, cam) in enumerate(zip(self.cams, self.cam_objs)):
            zeros = np.zeros((int(cam.height), int(cam.width)), np.int32)
            maps = [torch.as_tensor(m if m is not None else zeros,
                                    device=self.device)
                    for m in (cam.segmap, cam.sorted_segmap)]
            packs = self.sampling_packs[ci]
            bundles.append(SemanticCamera(
                ct.w2v, ct.full_proj, ct.campos, *maps,
                self.binning_cache[ci], *packs,
                *[int(pk[-1]) for pk in packs]))
        return bundles

    def _max_labels(self) -> int:
        if getattr(self, "_max_labels_memo", None) is not None:
            return self._max_labels_memo
        m = 1
        for c in self.cam_objs:
            if c.segmap is not None:
                m = max(m, int(c.segmap.max()))
            if c.sorted_segmap is not None:
                m = max(m, int(c.sorted_segmap.max()))
        m = max(m, int(self.seg3d_labels.max()) + 1)
        self._max_labels_memo = int((m + 7) // 8 * 8)
        return self._max_labels_memo

    def train_segfeat(self, iterations: Optional[int] = None,
                      progress: bool = True, save_every: int = 2500):
        """Stage 2 (reference train_semantic.py:75-237), then the HDBSCAN
        export; under dp the data-parallel loop (_contrastive_dp)."""
        opt = self.opt
        if self.dp:
            sizes = {(int(c.width), int(c.height)) for c in self.cam_objs}
            if len(sizes) != 1:
                raise ValueError(f"--dp requires uniform camera resolution; "
                                 f"got {sizes}")
        iterations = iterations or opt.iterations
        opt_state = init_adam_state(self.params)
        max_labels = self._max_labels()
        if not hasattr(self, "binning_cache"):
            self._precompute_binning()
        if not hasattr(self, "sampling_packs"):
            self._precompute_sampling()
        fallbacks0 = LAUNCHES["sparse_fallback"]
        cf = None
        if self.class_feat is not None:
            cf = torch.as_tensor(np.pad(self.class_feat, (
                (0, max(0, max_labels - len(self.class_feat))), (0, 0))),
                device=self.device)
        hyp = SemanticHypers(
            bg=self.bg, lrs=semantic_lrs(opt),
            lam_sv=opt.lambda_singview_contras,
            lam_mv=opt.lambda_multiview_contras,
            lam_3d=opt.lambda_3D_contras,
            seg3d_labels=self.seg3d_labels_padded, class_feat=cf)
        bundles = self._camera_bundles()
        scfg_of = {}

        def scfg_for(ci):
            wh = (int(self.cam_objs[ci].width), int(self.cam_objs[ci].height))
            if wh not in scfg_of:
                scfg_of[wh] = SemanticStepConfig(
                    raster=RasterizeConfig(width=wh[0], height=wh[1],
                                           bwd_extras_only=True),
                    batch=int(opt.sample_batchsize), max_labels=max_labels,
                    consider_negative=bool(opt.consider_negative_labels),
                    mv_merged=bool(opt.mv_merged),
                    sparse_px=bool(opt.sparse_px))
            return scfg_of[wh]

        first = self.rank == 0
        tracer = TraceWindow(self.profile_trace if first else None,
                             *self.profile_window)
        t0 = time.perf_counter()
        loop = self._contrastive_dp if self.dp else self._contrastive
        for it, loss in loop(iterations, opt_state, hyp, bundles, scfg_for,
                             tracer):
            if progress and first and it % 10 == 0:
                print(f"[ITER {it}] ContraLoss {float(loss):.3f}",
                      flush=True)
            if it % save_every == 0 or it == iterations:
                if first:
                    self.save(it)
                if self.dp:
                    dist.barrier(group=self.group)
        tracer.close()          # also a trace left open mid-window
        self.last_loss = float(loss)
        self.timings["training"] = time.perf_counter() - t0
        if opt.sparse_px and first:
            print(f"sparse-pixel steps that took the dense path (a tile "
                  f"drew more than its slots): "
                  f"{LAUNCHES['sparse_fallback'] - fallbacks0}",
                  flush=True)
        t1 = time.perf_counter()
        if first:
            self.export_segment_results(
                iterations, use_hdbscan=True,
                note=f"iteration_{iterations}_hdbscan")
        if self.dp:
            dist.barrier(group=self.group)
        self.timings["hdbscan export"] = time.perf_counter() - t1

    def _contrastive(self, iterations: int, opt_state, hyp, bundles,
                     scfg_for, tracer):
        """The single-process contrastive loop: yields (iteration, loss)
        after each step, the tracer ticked at its top."""
        opt = self.opt
        # tiny scenes: the window shrinks to the camera count
        n_mv = min(int(opt.sample_mv_frames), len(self.cams))
        stack = []
        for it in range(1, iterations + 1):
            tracer.tick(it)
            if not stack:
                stack = list(range(len(self.cams)))
            ci = stack.pop(self.rng.randint(0, len(stack) - 1))
            mv = None
            if opt.lambda_multiview_contras > 0 and it % 10 == 0:
                v0 = self.rng.randint(0, max(0, len(self.cams) - n_mv - 1))
                sel = None
                num_tiles = _grid(bundles[ci])[3]
                mv_k = min(int(opt.mv_tile_subsample), num_tiles)
                if mv_k:
                    # the host stream draws as the JAX trainer's does
                    sel = torch.as_tensor(np.stack([np.sort(np.asarray(
                        self.rng.sample(range(num_tiles), mv_k), np.int32))
                        for _ in range(n_mv)]), device=self.device)
                mv = SemanticMVBlock([bundles[v] for v in
                                      range(v0, v0 + n_mv)], sel)
            self.params, opt_state, loss = semantic_train_step(
                self.params, opt_state, bundles[ci], mv, hyp, scfg_for(ci),
                generator=self.generator)
            yield it, loss

    def _contrastive_dp(self, iterations: int, opt_state, hyp, bundles,
                        scfg_for, tracer):
        """The data-parallel contrastive loop (JAX :909-986): every rank
        pops the same `dp` cameras, draws every one's pixels in batch order
        from its generator (seeded alike) and keeps the rank-th's, so the
        draws do not depend on the batch's layout; yields (iteration, mean
        loss)."""
        from ..parallel.data_parallel import dp_semantic_step
        scfg = scfg_for(0)
        stack = []
        for it in range(1, iterations + 1):
            tracer.tick(it)
            idxs = []
            for _ in range(self.dp):
                if not stack:
                    stack = list(range(len(self.cams)))
                idxs.append(stack.pop(self.rng.randint(0, len(stack) - 1)))
            draws = [draw_step_pixels(self.generator, bundles[v], None,
                                      hyp.class_feat, scfg.batch,
                                      scfg.consider_negative)
                     for v in idxs][self.rank]
            self.params, opt_state, loss = dp_semantic_step(
                self.params, opt_state, bundles[idxs[self.rank]], hyp, scfg,
                draws=draws, group=self.group)
            yield it, loss

    def save(self, iteration: int) -> str:
        path = os.path.join(self.model_path,
                            f"point_cloud/iteration_{iteration}",
                            "point_cloud.ply")
        gmod.save_ply(self.params, path)
        return path

    def render_views(self, save_mask: bool = False, view_idx=()):
        """Per-view feature exports (reference train_semantic.py:353-428)
        under <model_path>/render: segfeat/<name>.npy (the view's raw
        [H,W,E] features from render(viewer=True), K1 `viewer`; a file
        already there is read instead) and segfeat/<name>.png (their PCA
        colours); with save_mask, segmask/<name>.png colours each pixel by
        its best per-instance mean-feature match (score >= 0.75, else
        black; colours from numpy's default_rng(0))."""
        from ..render import render
        from ..semantic.export import pca_proj_matrix
        from ..utils.image import write_png

        save_dir = os.path.join(self.model_path, "render")
        os.makedirs(os.path.join(save_dir, "segfeat"), exist_ok=True)
        os.makedirs(os.path.join(save_dir, "segmask"), exist_ok=True)
        if self.scene is None:
            self._load_scene()
        to8 = lambda rgb01: np.uint8(np.clip(rgb01, 0, 1) * 255.0)

        feats = self.params.seg_feature.detach().cpu().numpy()
        inst_feats = inst_colors = None
        if save_mask:
            inst_feats = np.stack(
                [feats[self.seg3d_masks[:, k]].mean(0)
                 for k in range(self.seg3d_masks.shape[1])])
            rng = np.random.default_rng(0)
            inst_colors = rng.random((len(inst_feats), 3)) * 0.7 + 0.3

        views = (self.cam_objs if not view_idx
                 else [self.cam_objs[i] for i in view_idx])
        proj = None
        for cam_obj in views:
            name = cam_obj.image_name
            npy = os.path.join(save_dir, "segfeat", f"{name}.npy")
            if os.path.exists(npy):
                feat = np.load(npy)
            else:
                with torch.no_grad():
                    pkg = render(cam_obj, self.params, self.pipe, self.bg,
                                 viewer=True)
                feat = pkg["seg_feature"].cpu().numpy()
                np.save(npy, feat)
            if proj is None:
                proj = pca_proj_matrix(feats)
            fn = feat / (np.linalg.norm(feat, axis=-1, keepdims=True) + 1e-6)
            write_png(os.path.join(save_dir, "segfeat", f"{name}.png"),
                      to8(fn @ proj * 0.5 + 0.5))
            if save_mask:
                infn = inst_feats / (np.linalg.norm(
                    inst_feats, axis=1, keepdims=True) + 1e-6)
                score = fn @ infn.T                       # [H,W,K]
                best = score.argmax(-1)
                ok = np.take_along_axis(
                    score, best[..., None], axis=-1)[..., 0] >= 0.75
                write_png(os.path.join(save_dir, "segmask", f"{name}.png"),
                          to8(inst_colors[best] * ok[..., None]))

    def export_segment_results(self, iteration: int,
                               score_threshold: float = 0.9,
                               use_hdbscan: bool = False,
                               note: Optional[str] = None):
        """Per-instance point clouds (reference train_semantic.py:240-350);
        the HDBSCAN labelling runs its spanning tree on the trainer's
        device."""
        from ..semantic.export import export_segment_results
        save_dir = os.path.join(self.model_path, "point_cloud",
                                note if note else f"iteration_{iteration}")
        pc = gmod.compact(self.params)
        return export_segment_results(
            pc.xyz.cpu().numpy(), pc.seg_feature_normed().cpu().numpy(),
            self.seg3d_masks, self.seg3d_labels, save_dir,
            score_threshold=score_threshold, use_hdbscan=use_hdbscan,
            device=self.device, seconds=self.timings)
