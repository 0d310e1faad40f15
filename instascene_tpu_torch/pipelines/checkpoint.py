"""Full-state training checkpoints as npz.

Port of instascene_tpu/pipelines/checkpoint.py: the same keys (`p.*`,
`m.*`, `v.*` per field, `adam_count`, `xyz_gradient_accum`, `denom`,
`max_radii2d`, `iteration`, `active_sh_degree`, `max_sh_degree`), so a
checkpoint of the JAX trainer resumes here and the other way round.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.densify import DensifyStats
from ..models.gaussians import FIELDS, GaussianModel, from_numpy
from ..models.optimizer import AdamState


def save_checkpoint(trainer, model_path: str, iteration: int) -> str:
    p = trainer.params
    host = lambda a: a.detach().cpu().numpy()
    out = {"iteration": np.int64(iteration),
           "active_sh_degree": np.int64(p.active_sh_degree),
           "max_sh_degree": np.int64(p.max_sh_degree),
           "adam_count": np.asarray(trainer.opt_state.count, np.int32),
           **{k: host(getattr(trainer.stats, k))
              for k in DensifyStats._fields}}
    for f in FIELDS:
        if getattr(p, f) is not None:
            out[f"p.{f}"] = host(getattr(p, f))
    # the moments carry `alive` too, as the JAX package's GaussianParams do
    for prefix, d in (("m.", trainer.opt_state.m), ("v.", trainer.opt_state.v)):
        out[f"{prefix}alive"] = host(p.alive)
        for f, a in d.items():
            out[f"{prefix}{f}"] = host(a)
    os.makedirs(model_path, exist_ok=True)
    path = os.path.join(model_path, f"chkpnt{iteration}.npz")
    np.savez(path, **out)
    return path


def load_checkpoint(path: str, device=None) -> Tuple[GaussianModel,
                                                     AdamState,
                                                     DensifyStats, int]:
    """→ (params, Adam state, densify stats, iteration) on `device`."""
    dev = resolve_device(device)
    z = np.load(path)
    sh, max_sh = int(z["active_sh_degree"]), int(z["max_sh_degree"])
    params = from_numpy({**{f: z[f"p.{f}"] for f in FIELDS
                            if f"p.{f}" in z},
                         "active_sh_degree": sh, "max_sh_degree": max_sh},
                        dev)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=dev)
    moments = [{f: t(z[f"{prefix}{f}"]) for f in FIELDS
                if f != "alive" and f"{prefix}{f}" in z}
               for prefix in ("m.", "v.")]
    opt = AdamState(m=moments[0], v=moments[1], count=int(z["adam_count"]))
    stats = DensifyStats(*(t(z[k]) for k in DensifyStats._fields))
    return params, opt, stats, int(z["iteration"])
