"""Adam over the GaussianModel's fields, with per-field learning rates.

Port of instascene_tpu/models/optimizer.py:22-128 (`AdamState`,
`init_adam_state`, `geometry_lrs`, `semantic_lrs`, `adam_step` with its
`frozen_fields`, `zero_state_rows`): the
reference's torch.optim.Adam as it configures it (β = (0.9, 0.999),
eps = 1e-15 added outside the sqrt, bias correction by one global step
count), hand-rolled so that densification can zero moment rows. Updates
are masked by `alive` with torch.where, so dead capacity rows stay fixed
even under non-finite gradients. Moments are dicts field → tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from .gaussians import GaussianModel

TRAINABLE_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                    "rotation", "opacity", "seg_feature")


@dataclass
class AdamState:
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    count: int = 0


def init_adam_state(params: GaussianModel) -> AdamState:
    z = {f: torch.zeros_like(getattr(params, f)) for f in TRAINABLE_FIELDS
         if getattr(params, f) is not None}
    return AdamState(m=z, v={f: a.clone() for f, a in z.items()}, count=0)


def geometry_lrs(opt, spatial_lr_scale: float,
                 xyz_lr: float) -> Dict[str, float]:
    """Learning rates of geometry training; `xyz_lr` is the scheduled value
    (spatial scale included). Features do not train here."""
    return {"xyz": xyz_lr, "features_dc": opt.feature_lr,
            "features_rest": opt.feature_lr / 20.0,
            "opacity": opt.opacity_lr, "scaling": opt.scaling_lr,
            "rotation": opt.rotation_lr, "seg_feature": 0.0}


def semantic_lrs(opt) -> Dict[str, float]:
    """Learning rates of semantic training: only seg_feature trains
    (reference gaussian_model.py:217-232)."""
    return {f: 0.0 for f in TRAINABLE_FIELDS} | {
        "seg_feature": opt.seg_feature_lr}


# the fields semantic training never moves (adam_step's frozen_fields)
GEOMETRY_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                   "rotation", "opacity")


def adam_step(params: GaussianModel, grads: Dict[str, Optional[torch.Tensor]],
              state: AdamState, lrs: Dict[str, float], b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-15,
              frozen_fields: tuple = ()):
    """One Adam step → (new params, new state). `grads` maps field → its
    gradient (None or absent counts as zero). frozen_fields are skipped
    outright: their params and moments are neither read nor written (the
    semantic step freezes the geometry)."""
    count = state.count + 1
    dev = params.device
    f32 = torch.float32
    c1 = 1.0 - torch.tensor(b1, dtype=f32, device=dev) ** float(count)
    c2 = 1.0 - torch.tensor(b2, dtype=f32, device=dev) ** float(count)
    updates, new_m, new_v = {}, dict(state.m), dict(state.v)
    for f in TRAINABLE_FIELDS:
        p = getattr(params, f)
        if p is None or f in frozen_fields:
            continue
        g = grads.get(f)
        if g is None:
            g = torch.zeros_like(p)
        m = b1 * state.m[f] + (1 - b1) * g
        v = b2 * state.v[f] + (1 - b2) * (g * g)
        amask = params.alive.reshape((-1,) + (1,) * (p.dim() - 1))
        upd = torch.where(amask, lrs[f] * (m / c1) / (torch.sqrt(v / c2)
                                                      + eps), 0.0)
        updates[f] = p - upd
        new_m[f] = m
        new_v[f] = v
    return (params.replace(**updates),
            AdamState(m=new_m, v=new_v, count=count))


def zero_state_rows(state: AdamState, row_mask: torch.Tensor,
                    fields=TRAINABLE_FIELDS) -> AdamState:
    """Moments zeroed at the rows of row_mask (new or freed slots)."""
    def zero(d):
        out = dict(d)
        for f in fields:
            if f in d:
                mask = row_mask.reshape((-1,) + (1,) * (d[f].dim() - 1))
                out[f] = torch.where(mask, 0.0, d[f])
        return out
    return AdamState(m=zero(state.m), v=zero(state.v), count=state.count)
