"""Camera-batch data parallelism: one camera per rank, gradients averaged.

Port of instascene_tpu/parallel/data_parallel.py:48-200
(`build_dp_train_step`, `build_dp_semantic_step`) on torch.distributed,
one process per rank (parallel/launch.py). The gaussians are replicated;
each rank renders and differentiates its own camera with the
single-camera step's own functions, and one flattened all_reduce takes the
place of the JAX package's pmean (and one its pmax), so every rank then
takes the same Adam step and the replicas stay bit for bit equal. A world
of one is the single-camera step bit for bit. The learning rates travel as
the step's dict (the JAX package's `LR_ORDER`/`lrs_vector` only turn them
into a traced vector).

The densification stats follow the JAX package's: the mean dL/dT times the
per-gaussian depth of rank 0's camera (JAX returns device 0's replica of
stats each device computed with its own depth; ROADMAP C). Rank 0's depth
rides in the same all_reduce as the gradients, zeros from the other ranks,
so it arrives exact.
"""

from __future__ import annotations

import hashlib
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from ..models import densify as dens
from ..models.gaussians import FIELDS, GaussianModel
from ..ops.rasterize import RasterizeConfig
from ..pipelines.train import (CameraTensors, StepGrads, apply_gradients,
                               step_gradients)
from ..pipelines.train_semantic import (SemanticCamera, SemanticHypers,
                                        SemanticStepConfig, semantic_adam,
                                        semantic_gradient)
from ..utils.profiling import span, stage
from .launch import all_reduce

_METRICS = ("ll1", "dist", "normal")


def reduce_step_grads(sg: StepGrads, group=None) -> StepGrads:
    """The batch's StepGrads on every rank: the mean of the gradients, of
    dL/dT, of the loss and the metrics (one SUM all_reduce, then a divide
    by the world), rank 0's depth, and the max of visibility, radii and the
    pair count (one MAX all_reduce)."""
    world = dist.get_world_size(group)
    names = list(sg.grads)
    mean_parts = [sg.grads[f].reshape(-1) for f in names] + [
        sg.t_grad.reshape(-1),
        torch.stack([sg.loss] + [sg.aux[k].detach() for k in _METRICS])]
    depth = sg.aux["depth"].detach()
    if dist.get_rank(group) != 0:
        depth = torch.zeros_like(depth)
    flat = all_reduce(torch.cat(mean_parts + [depth]), group=group)
    n_mean = flat.numel() - depth.numel()
    mean = flat[:n_mean] / world
    pieces = iter(torch.split(mean, [p.numel() for p in mean_parts]))
    grads = {f: next(pieces).view_as(sg.grads[f]) for f in names}
    t_grad = next(pieces).view_as(sg.t_grad)
    scalars = next(pieces)
    vis, radii = sg.aux["visible"], sg.aux["radii"]
    ints = all_reduce(torch.cat([
        vis.to(torch.int64), radii.to(torch.int64),
        torch.tensor([sg.aux["total_pairs"]], device=vis.device)]),
        op=dist.ReduceOp.MAX, group=group)
    n = vis.numel()
    aux = {**{k: scalars[1 + i] for i, k in enumerate(_METRICS)},
           "depth": flat[n_mean:], "visible": ints[:n] > 0,
           "radii": ints[n:2 * n].to(radii.dtype),
           "total_pairs": int(ints[-1])}
    return StepGrads(scalars[0], grads, t_grad, aux)


def dp_train_step(params: GaussianModel, opt_state, stats: dens.DensifyStats,
                  ct: CameraTensors, bg, lrs: dict, lambda_dssim: float,
                  lambda_dist: float, lambda_normal: float,
                  lambda_normal_prior: float, cfg: RasterizeConfig,
                  depth_ratio: float, group=None,
                  on_stage: Optional[Callable[[str], None]] = None):
    """One data-parallel geometry step (build_dp_train_step): this rank's
    camera `ct` through pipelines/train.py's step_gradients, the batch's
    reduction, then apply_gradients → (params, opt_state, stats, metrics),
    the same on every rank. Metrics: the means of loss, ll1, dist and
    normal, and the largest total_pairs. on_stage(name) and the spans as
    train_step's, with the stage "reduce" after "backward"."""
    mark = on_stage or (lambda name: None)
    with span("step"):
        sg = step_gradients(params, ct, bg, lambda_dssim, lambda_dist,
                            lambda_normal, lambda_normal_prior, cfg,
                            depth_ratio, mark)
        with stage("reduce", mark):
            sg = reduce_step_grads(sg, group)
        with stage("adam", mark):
            out = apply_gradients(params, opt_state, stats, sg, lrs, cfg)
    return out


def dp_semantic_step(params: GaussianModel, opt_state, cam: SemanticCamera,
                     hyp: SemanticHypers, scfg: SemanticStepConfig,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[dict] = None, group=None,
                     on_stage: Optional[Callable[[str], None]] = None):
    """One data-parallel contrastive step (build_dp_semantic_step): the
    single-view and 3D losses of this rank's camera (no multi-view window,
    as in the JAX package), the mean seg_feature gradient and loss over
    the ranks (one all_reduce), then Adam on the features alone →
    (params, opt_state, loss). draws as semantic_train_step's: this rank's
    index sets, else drawn from `generator`. on_stage(name) and the spans
    as semantic_train_step's, with the stage "reduce" after "backward"."""
    mark = on_stage or (lambda name: None)
    with span("step"):
        loss, g = semantic_gradient(params, cam, None, hyp, scfg, generator,
                                    draws, mark)
        with stage("reduce", mark):
            flat = all_reduce(torch.cat([g.reshape(-1), loss.reshape(1)]),
                              group=group) / dist.get_world_size(group)
        with stage("adam", mark):
            params, opt_state = semantic_adam(params, opt_state,
                                              flat[:-1].view_as(g), hyp)
    return params, opt_state, flat[-1]


def state_digest(params: GaussianModel, opt_state=None, stats=None) -> str:
    """sha256 of a replica's parameters and, when given, its Adam state
    and densification stats, bit for bit."""
    tensors = [getattr(params, f) for f in FIELDS
               if getattr(params, f) is not None]
    if opt_state is not None:
        tensors += [d[f] for d in (opt_state.m, opt_state.v)
                    for f in sorted(d)]
    if stats is not None:
        tensors += list(stats)
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    if opt_state is not None:
        h.update(str(opt_state.count).encode())
    return h.hexdigest()


def gather_notes(note: dict, group=None) -> List[dict]:
    """Every rank's `note` (picklable), in rank order, on every rank."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, note, group=group)
    return out
