"""Adaptive density control over a fixed-capacity gaussian set.

Port of instascene_tpu/models/densify.py:35-200 (`DensifyStats`,
`init_stats`, `add_densification_stats`, `densify_and_prune`,
`reset_opacity`, `grow_capacity`). The set keeps the JAX package's fixed
capacity with an `alive` mask: clone, split and prune are one masked pass,
new gaussians go into dead slots rank-matched in index order, their Adam
moments are zeroed, and the count of new gaussians that found no dead slot
is returned so the caller can double the capacity. Semantics of the
reference (gaussian_model.py:520-605): clone at grad ≥ threshold and
max scale ≤ percent_dense·extent; split above it into 2 children drawn
from N(0, scale) in the surfel frame with scales /1.6, the parent pruned;
prune at opacity < min_opacity and, with use_screen_size, screen radius >
max_screen_size or world scale > 0.1·extent; stats reset after.

The split noise `eps` [2, C, 3] is an argument: the trainer draws it from
its torch.Generator, and a test can hand in the JAX package's draw.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.general import build_rotation
from .gaussians import GaussianModel
from .optimizer import AdamState, zero_state_rows


class DensifyStats(NamedTuple):
    xyz_gradient_accum: torch.Tensor  # [C]
    denom: torch.Tensor               # [C]
    max_radii2d: torch.Tensor         # [C] f32


def init_stats(capacity: int, device=None) -> DensifyStats:
    z = lambda: torch.zeros(capacity, dtype=torch.float32, device=device)
    return DensifyStats(z(), z(), z())


def add_densification_stats(stats: DensifyStats, screen_grad: torch.Tensor,
                            visible: torch.Tensor, radii: torch.Tensor
                            ) -> DensifyStats:
    """screen_grad [C,2]: NDC-space view-space gradients."""
    gnorm = torch.linalg.norm(screen_grad, dim=-1)
    vis = visible.to(torch.float32)
    return DensifyStats(
        xyz_gradient_accum=stats.xyz_gradient_accum + gnorm * vis,
        denom=stats.denom + vis,
        max_radii2d=torch.where(
            visible, torch.maximum(stats.max_radii2d, radii.to(torch.float32)),
            stats.max_radii2d))


def densify_and_prune(params: GaussianModel, opt_state: AdamState,
                      stats: DensifyStats, eps: torch.Tensor,
                      max_grad: float, min_opacity: float, extent: float,
                      max_screen_size: float, percent_dense: float = 0.01,
                      use_screen_size: bool = True):
    """→ (params, opt_state, stats, n_overflow). eps [2, C, 3]: the
    standard-normal split noise of the two children of every slot."""
    cap = params.capacity
    dev = params.device
    alive = params.alive
    grads = torch.where(stats.denom > 0, stats.xyz_gradient_accum
                        / torch.clamp(stats.denom, min=1.0), 0.0)
    grads = torch.nan_to_num(grads, 0.0)
    scale_act = torch.exp(params.scaling)
    max_scale = torch.max(scale_act, dim=1).values

    clone_mask = alive & (grads >= max_grad) & (max_scale
                                                <= percent_dense * extent)
    split_mask = alive & (grads >= max_grad) & (max_scale
                                                > percent_dense * extent)
    # prune criteria, evaluated for originals and inherited by children
    prune_opac = torch.sigmoid(params.opacity[:, 0]) < min_opacity
    child_scale_max = max_scale / (0.8 * 2)
    if use_screen_size:
        prune_old = (prune_opac | (stats.max_radii2d > max_screen_size)
                     | (max_scale > 0.1 * extent))
        prune_child = prune_opac | (child_scale_max > 0.1 * extent)
    else:
        prune_old = prune_child = prune_opac
    alive_after = alive & ~split_mask & ~prune_old

    # candidates [3C] = clones + split children A + split children B
    n_mask = torch.cat([clone_mask & ~prune_old, split_mask & ~prune_child,
                        split_mask & ~prune_child])
    src = torch.arange(cap, device=dev).repeat(3)

    # split child positions: x + R @ N(0, (s_u, s_v, 0))
    stds = torch.cat([scale_act, torch.zeros((cap, 1), device=dev)], dim=1)
    R = build_rotation(params.rotation)                      # [C,3,3]
    offs = torch.einsum("cij,kcj->kci", R, eps * stds[None])  # [2,C,3]
    child_xyz = params.xyz[None] + offs
    child_scaling = torch.log(scale_act / (0.8 * 2))

    # rank-match candidates to dead slots (in index order)
    cand_rank = torch.cumsum(n_mask.to(torch.int64), 0) - 1
    dead = ~alive_after
    slot_of_rank = torch.nonzero(dead).squeeze(1)
    place = n_mask & (cand_rank < slot_of_rank.shape[0])
    n_overflow = int(n_mask.sum()) - int(place.sum())
    target = slot_of_rank[cand_rank[place]]

    def scatter(old, cand):
        out = old.clone()
        out[target] = cand[place]
        return out

    def same(field):
        return scatter(field, field[src])

    new_params = params.replace(
        xyz=scatter(params.xyz, torch.cat([params.xyz, child_xyz[0],
                                           child_xyz[1]])),
        features_dc=same(params.features_dc),
        features_rest=same(params.features_rest),
        scaling=scatter(params.scaling, torch.cat(
            [params.scaling, child_scaling, child_scaling])),
        rotation=same(params.rotation), opacity=same(params.opacity),
        seg_feature=(same(params.seg_feature)
                     if params.seg_feature is not None else None),
        alive=scatter(alive_after, torch.ones(3 * cap, dtype=torch.bool,
                                              device=dev)))

    # new slots (and freed slots) get zeroed Adam moments
    touched = torch.zeros(cap, dtype=torch.bool, device=dev)
    touched[target] = True
    freed = alive & ~alive_after
    new_opt = zero_state_rows(opt_state, touched | freed)
    return new_params, new_opt, init_stats(cap, dev), n_overflow


def reset_opacity(params: GaussianModel, opt_state: AdamState):
    """opacity ← logit(min(σ(opacity), 0.01)); its Adam moments zeroed."""
    opac = torch.clamp(torch.sigmoid(params.opacity), max=0.01)
    params = params.replace(opacity=torch.log(opac / (1 - opac)))
    opt_state = zero_state_rows(
        opt_state, torch.ones(params.capacity, dtype=torch.bool,
                              device=params.device), fields=("opacity",))
    return params, opt_state


def grow_capacity(params: GaussianModel, opt_state: AdamState,
                  stats: DensifyStats, new_capacity: int):
    """Pad every row array with dead slots up to new_capacity."""
    extra = new_capacity - params.capacity
    if extra <= 0:
        raise ValueError(f"new capacity {new_capacity} <= "
                         f"{params.capacity}")

    def pad(a):
        if a is None:
            return None
        return torch.cat([a, torch.zeros((extra,) + tuple(a.shape[1:]),
                                         dtype=a.dtype, device=a.device)])

    fields = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "alive", "seg_feature")
    new_params = params.replace(**{f: pad(getattr(params, f))
                                   for f in fields})
    new_opt = AdamState(m={f: pad(a) for f, a in opt_state.m.items()},
                        v={f: pad(a) for f, a in opt_state.v.items()},
                        count=opt_state.count)
    return new_params, new_opt, DensifyStats(*(pad(a) for a in stats))
