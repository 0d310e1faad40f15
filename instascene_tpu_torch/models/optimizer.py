"""Adam over the GaussianModel's fields, with per-field learning rates.

Port of instascene_tpu/models/optimizer.py:22-128 (`AdamState`,
`init_adam_state`, `geometry_lrs`, `semantic_lrs`, `adam_step` with its
`frozen_fields`, `zero_state_rows`): the
reference's torch.optim.Adam as it configures it (β = (0.9, 0.999),
eps = 1e-15 added outside the sqrt, bias correction by one global step
count), hand-rolled so that densification can zero moment rows. Updates
are masked by `alive` with torch.where, so dead capacity rows stay fixed
even under non-finite gradients. Moments are dicts field → tensor.

On CUDA, adam_step is one launch of csrc/adam.cu over every field it
updates (`adam_kernel`), bit for bit the eager chain (`adam_plain`),
which the CPU keeps; `cuda_build.LAUNCHES["adam"]` counts the launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..cuda_build import LAUNCHES, F, I, P, lib_fn, operand, ptr, stream
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
    semantic step freezes the geometry). Every returned tensor of an
    updated field is new; the inputs are left as they were."""
    count = state.count + 1
    fields = [(f, getattr(params, f), grads.get(f)) for f in TRAINABLE_FIELDS
              if getattr(params, f) is not None and f not in frozen_fields]
    run = adam_kernel if _on_card(params.alive) else adam_plain
    out = run(fields, state, params.alive, lrs, b1, b2, eps, count)
    return (params.replace(**{f: o[0] for f, o in out.items()}),
            AdamState(m=state.m | {f: o[1] for f, o in out.items()},
                      v=state.v | {f: o[2] for f, o in out.items()},
                      count=count))


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def adam_plain(fields, state: AdamState, alive: torch.Tensor,
               lrs: Dict[str, float], b1: float, b2: float, eps: float,
               count: int) -> Dict[str, tuple]:
    """adam_step's update as an eager chain: fields are (name, param,
    gradient or None) → {name: (new param, new m, new v)}."""
    dev = alive.device
    f32 = torch.float32
    c1 = 1.0 - torch.tensor(b1, dtype=f32, device=dev) ** float(count)
    c2 = 1.0 - torch.tensor(b2, dtype=f32, device=dev) ** float(count)
    out = {}
    for f, p, g in fields:
        if g is None:
            g = torch.zeros_like(p)
        m = b1 * state.m[f] + (1 - b1) * g
        v = b2 * state.v[f] + (1 - b2) * (g * g)
        amask = alive.reshape((-1,) + (1,) * (p.dim() - 1))
        upd = torch.where(amask, lrs[f] * (m / c1) / (torch.sqrt(v / c2)
                                                      + eps), 0.0)
        out[f] = (p - upd, m, v)
    return out


def adam_kernel(fields, state: AdamState, alive: torch.Tensor,
                lrs: Dict[str, float], b1: float, b2: float, eps: float,
                count: int) -> Dict[str, tuple]:
    """adam_plain's outputs from one launch of csrc/adam.cu over every
    field, bit for bit. CUDA tensors only; raises on what the kernel does
    not take (a field not float32 [rows, ...] on alive's device, a
    gradient or moment of another shape). Each launch counts one in
    LAUNCHES["adam"]; with no element to update nothing is launched or
    counted."""
    dev = alive.device
    rows = alive.shape[0]
    if alive.dtype != torch.bool or alive.dim() != 1:
        raise ValueError("adam_kernel: alive must be a bool vector")
    alive = alive.contiguous()
    out, operands, n, width, lr = {}, [], [], [], []
    for f, p, g in fields:
        if p.dim() == 0 or p.shape[0] != rows:
            raise ValueError(f"adam_kernel: {f} has {tuple(p.shape)}, not "
                             f"{rows} rows")
        ins = [None if t is None else operand(f"{f}.{k}", t, p.shape, dev)
               for k, t in (("p", p), ("grad", g), ("m", state.m[f]),
                            ("v", state.v[f]))]
        out[f] = tuple(torch.empty(p.shape, dtype=torch.float32, device=dev)
                       for _ in range(3))
        if p.numel():
            operands += ins + list(out[f])
            n.append(p.numel())
            width.append(p.numel() // rows)
            lr.append(lrs[f])
    if not n:
        return out      # nothing to update: nothing to launch
    k = len(n)
    arrays = ((ctypes.c_void_p * (7 * k))(*map(ptr, operands)),
              (ctypes.c_longlong * k)(*n), (ctypes.c_int * k)(*width),
              (ctypes.c_float * k)(*lr))
    fn = lib_fn("adam.cu", "adam_launch", [I] + [P] * 5 + [F] * 5 + [I, P])
    with torch.cuda.device(dev):
        err = fn(k, *map(ctypes.addressof, arrays), alive.data_ptr(), b1,
                 1 - b1, b2, 1 - b2, eps, count, stream(dev))
    if err != 0:
        raise RuntimeError(f"adam kernel launch failed: cudaError {err}")
    LAUNCHES["adam"] += 1
    return out


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
