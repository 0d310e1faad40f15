"""Geometry training: the 2DGS train step and the trainer that drives it.

Port of instascene_tpu/pipelines/train.py:36-151 (the pixel rays, now
ops/depth_utils.pixel_rays, `render_for_training`, `geometry_loss_fn`,
`train_step`, `eval_step`),
:207-262 and :287-304 (`CameraTensors`, `camera_tensors`,
`GeometryTrainer` and its `_cfg` rule) and :433-636 (the camera stack,
`step` with the SH, λ and densification schedules, `evaluate`,
`training_report` with its TensorBoard scalars and images, `save`,
`train`, which also carries the root train.py loop's TensorBoard scalars
and profile window, train.py:87-136).

One step: render → photometric (L1 + SSIM) + distortion + normal
consistency (+ the optional mono-normal prior) → gradients by torch
autograd, whose blend backward is K2, and of the zero t_offset tap →
densification stats + Adam. Its activations and maps are render()'s
(GaussianModel.raster_inputs, ops/depth_utils.surface_maps). The TPU
scheduling around the JAX step (pair
caps and their autotune, the slow-roll watchdog, device scalars) has no
counterpart: buffers follow each frame's pair total. With `dp`, the
trainer is one rank of a camera-batch data-parallel group (JAX :276-285,
:438-486): each step pops `dp` cameras from the shared stack, this rank
trains on its own through parallel/data_parallel.dp_train_step, and rank
0 alone reports, saves and checkpoints.
"""

from __future__ import annotations

import math
import os
import random
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..cameras import Camera
from ..losses import l1_loss, photometric_loss, psnr
from ..models import densify as dens
from ..models.gaussians import GaussianModel, create_from_pcd, save_ply
from ..models.optimizer import (TRAINABLE_FIELDS, adam_step, geometry_lrs,
                                init_adam_state)
from ..ops.depth_utils import pixel_rays, surface_maps
from ..ops.knn import mean_dist2_knn3
from ..ops.rasterize import (CameraMats, RasterizeConfig,
                             densify_screen_grad, rasterize)
from ..utils.general import get_expon_lr_func
from ..utils.profiling import span, stage


def render_for_training(params: GaussianModel, cam: CameraMats, bg,
                        cfg: RasterizeConfig, t_offset, c2w_rot,
                        tanfovx: float, tanfovy: float, depth_ratio: float):
    """Render + the derived maps the losses read (channels-last):
    (RasterizeOut, rend_normal, surf_normal, alpha, surf_depth)."""
    with span("model"):
        g = params.raster_inputs()
        shs = params.features()
        extras = params.seg_feature_normed()
    out = rasterize(*g, cam, bg, cfg, shs=shs,
                    sh_degree=params.active_sh_degree, extras=extras,
                    t_offset=t_offset, alive=params.alive)
    rays = pixel_rays(cfg.width, cfg.height, tanfovx, tanfovy, c2w_rot)
    rend_normal, _, _, surf_depth, surf_normal = surface_maps(
        out.blend, cam.w2v, cam.campos, rays, depth_ratio)
    return (out, rend_normal, surf_normal, out.blend.alpha[..., None],
            surf_depth)


@dataclass
class CameraTensors:
    w2v: torch.Tensor
    full_proj: torch.Tensor
    campos: torch.Tensor
    c2w_rot: torch.Tensor
    gt_image: Optional[torch.Tensor]
    normal_prior: Optional[torch.Tensor]
    normal_mask: Optional[torch.Tensor]
    tanfovx: float
    tanfovy: float

    @property
    def mats(self) -> CameraMats:
        return CameraMats(self.w2v, self.full_proj, self.campos)


def camera_tensors(cam: Camera, device) -> CameraTensors:
    f = lambda a: (torch.as_tensor(np.asarray(a, np.float32), device=device)
                   if a is not None else None)
    return CameraTensors(
        w2v=f(cam.w2v), full_proj=f(cam.full_proj),
        campos=f(cam.camera_center), c2w_rot=f(cam.c2w[:3, :3]),
        gt_image=f(cam.image), normal_prior=f(cam.normal),
        normal_mask=f(cam.normal_mask), tanfovx=float(cam.tanfovx),
        tanfovy=float(cam.tanfovy))


def geometry_loss_fn(parts, ct: CameraTensors, lambda_dssim, lambda_dist,
                     lambda_normal, lambda_normal_prior):
    """The geometry training loss (reference train.py:71-103) over a
    render_for_training result: photometric + λ_dist·mean distortion +
    λ_normal·(1 − n_rend·n_surf) + with a normal prior λ_prior·its masked
    cosine error. → (total, aux). Unlike the JAX function it does not
    render, so a step can time the render and the losses apart."""
    out, rend_normal, surf_normal, alpha, _ = parts
    image = out.blend.color
    photo, ll1 = photometric_loss(image, ct.gt_image, lambda_dssim)
    dist_loss = lambda_dist * torch.mean(out.blend.distortion)
    normal_error = torch.mean(1.0 - torch.sum(rend_normal * surf_normal,
                                              dim=-1))
    normal_loss = lambda_normal * normal_error
    if ct.normal_prior is not None:
        prior = ct.normal_prior * alpha.detach()
        dots = 1.0 - torch.sum(prior * rend_normal, dim=-1)
        msum = torch.clamp(torch.sum(ct.normal_mask), min=1.0)
        prior_err = torch.sum(dots * ct.normal_mask) / msum
        normal_loss = normal_loss + lambda_normal_prior * prior_err
    total = photo + dist_loss + normal_loss
    aux = {"ll1": ll1, "photo": photo, "dist": dist_loss,
           "normal": normal_loss, "radii": out.radii,
           "visible": out.visible, "depth": out.depth, "image": image,
           "total_pairs": out.total_pairs}
    return total, aux


class StepGrads(NamedTuple):
    """What one camera's backward gives a step: the loss, each trainable
    field's gradient (zeros where the loss does not reach it), dL/dT from
    the t_offset tap, and geometry_loss_fn's aux (the metrics, the
    per-gaussian depth, visibility and radii, the pair count)."""
    loss: torch.Tensor
    grads: Dict[str, torch.Tensor]
    t_grad: torch.Tensor
    aux: dict


def step_gradients(params: GaussianModel, ct: CameraTensors, bg,
                   lambda_dssim: float, lambda_dist: float,
                   lambda_normal: float, lambda_normal_prior: float,
                   cfg: RasterizeConfig, depth_ratio: float,
                   mark: Callable[[str], None] = lambda name: None
                   ) -> StepGrads:
    """Render, losses and backward of one camera: the first half of
    train_step. Each is a stage (utils/profiling.stage) whose end calls
    mark(name): "render", "loss" and "backward"."""
    with stage("render", mark):
        leaves = {f: getattr(params, f).detach().requires_grad_(True)
                  for f in TRAINABLE_FIELDS if getattr(params, f) is not None}
        p = params.replace(**leaves)
        t0 = torch.zeros((params.capacity, 3, 3), dtype=torch.float32,
                         device=params.device, requires_grad=True)
        parts = render_for_training(p, ct.mats, bg, cfg, t0, ct.c2w_rot,
                                    ct.tanfovx, ct.tanfovy, depth_ratio)
    with stage("loss", mark):
        loss, aux = geometry_loss_fn(parts, ct, lambda_dssim, lambda_dist,
                                     lambda_normal, lambda_normal_prior)
    names = list(leaves)
    with stage("backward", mark):
        grads = torch.autograd.grad(loss, [leaves[f] for f in names] + [t0],
                                    allow_unused=True)
    grads = [g if g is not None else torch.zeros_like(leaf) for g, leaf in
             zip(grads, [leaves[f] for f in names] + [t0])]
    return StepGrads(loss.detach(), dict(zip(names, grads[:-1])), grads[-1],
                     aux)


@torch.no_grad()
def apply_gradients(params: GaussianModel, opt_state,
                    stats: dens.DensifyStats, sg: StepGrads, lrs: dict,
                    cfg: RasterizeConfig):
    """The second half of train_step: densification stats from dL/dT and
    the per-gaussian depth, then Adam → (params, opt_state, stats,
    metrics)."""
    aux = sg.aux
    screen_grad = densify_screen_grad(sg.t_grad, aux["depth"], cfg.width,
                                      cfg.height)
    stats = dens.add_densification_stats(stats, screen_grad, aux["visible"],
                                         aux["radii"])
    params, opt_state = adam_step(params, sg.grads, opt_state, lrs)
    metrics = {"loss": sg.loss, "ll1": aux["ll1"].detach(),
               "dist": aux["dist"].detach(),
               "normal": aux["normal"].detach(),
               "total_pairs": aux["total_pairs"]}
    return params, opt_state, stats, metrics


def train_step(params: GaussianModel, opt_state, stats: dens.DensifyStats,
               ct: CameraTensors, bg, lrs: dict, lambda_dssim: float,
               lambda_dist: float, lambda_normal: float,
               lambda_normal_prior: float, cfg: RasterizeConfig,
               depth_ratio: float,
               on_stage: Optional[Callable[[str], None]] = None):
    """One geometry step → (params, opt_state, stats, metrics). Metrics
    are device scalars (read them only when needed) plus the frame's pair
    count. on_stage(name), when given, is called as each stage ends:
    "render", "loss", "backward", "adam" (for timing). The step is the span
    "step", its stages spans of their names (utils/profiling.py)."""
    mark = on_stage or (lambda name: None)
    with span("step"):
        sg = step_gradients(params, ct, bg, lambda_dssim, lambda_dist,
                            lambda_normal, lambda_normal_prior, cfg,
                            depth_ratio, mark)
        with stage("adam", mark):
            out = apply_gradients(params, opt_state, stats, sg, lrs, cfg)
    return out


@torch.no_grad()
def eval_step(params: GaussianModel, ct: CameraTensors, bg,
              cfg: RasterizeConfig, depth_ratio: float) -> dict:
    out, rend_normal, surf_normal, alpha, surf_depth = render_for_training(
        params, ct.mats, bg, cfg, None, ct.c2w_rot, ct.tanfovx, ct.tanfovy,
        depth_ratio)
    img = torch.clamp(out.blend.color, 0.0, 1.0)
    gt = torch.clamp(ct.gt_image, 0.0, 1.0)
    return {"l1": l1_loss(img, gt), "psnr": psnr(img, gt), "image": img,
            "surf_depth": surf_depth, "rend_normal": rend_normal,
            "surf_normal": surf_normal, "rend_alpha": alpha,
            "rend_dist": out.blend.distortion, "gt": gt}


class GeometryTrainer:
    """Drives the 2DGS geometry optimization (reference train.py:34-185) on
    `device` (CUDA unless "cpu" is asked for). dp > 0: this trainer is one
    rank of the torch.distributed `group` (default: the world), whose size
    must be dp; every rank builds the same replica from the same seed."""

    def __init__(self, dataset, opt, pipe, scene, seed: int = 0,
                 capacity_multiplier: float = 4.0, device=None, dp: int = 0,
                 group=None):
        self.dp, self.group, self.rank = int(dp), group, 0
        if self.dp:
            sizes = {(int(c.width), int(c.height))
                     for c in scene.get_train_cameras()}
            if len(sizes) != 1:
                raise ValueError(
                    f"--dp requires a uniform camera resolution; got {sizes}")
            if dist.get_world_size(group) != self.dp:
                raise ValueError(f"--dp {self.dp} in a process group of "
                                 f"{dist.get_world_size(group)} ranks")
            self.rank = dist.get_rank(group)
        self.device = resolve_device(device)
        self.opt = opt
        self.pipe = pipe
        self.dataset = dataset
        self.scene = scene
        pcd = scene.scene_info.point_cloud
        n0 = len(pcd.points)
        cap = int(2 ** math.ceil(math.log2(max(n0 * capacity_multiplier,
                                               1024))))
        pts = pcd.points.astype(np.float32)
        dist2 = mean_dist2_knn3(torch.as_tensor(pts, device=self.device))
        self.params = create_from_pcd(
            pts, pcd.colors.astype(np.float32), dist2.cpu().numpy(),
            capacity=cap, max_sh_degree=dataset.sh_degree, seed=seed,
            device=self.device)
        self.opt_state = init_adam_state(self.params)
        self.stats = dens.init_stats(cap, self.device)
        self.spatial_lr_scale = float(scene.cameras_extent)
        self.xyz_sched = get_expon_lr_func(
            lr_init=opt.position_lr_init * self.spatial_lr_scale,
            lr_final=opt.position_lr_final * self.spatial_lr_scale,
            lr_delay_mult=opt.position_lr_delay_mult,
            max_steps=opt.position_lr_max_steps)
        self.bg = torch.tensor([1.0, 1.0, 1.0] if dataset.white_background
                               else [0.0, 0.0, 0.0], device=self.device)
        self.cam_objs = scene.get_train_cameras()
        self.cams = [camera_tensors(c, self.device) for c in self.cam_objs]
        self.test_cam_objs = scene.get_test_cameras()
        self.test_cams = [camera_tensors(c, self.device)
                          for c in self.test_cam_objs]
        self.rng = random.Random(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.ema = {"loss": 0.0, "dist": 0.0, "normal": 0.0}
        self.reports = {}       # iteration → training_report's results
        self._stack = []

    def _cfg(self, cam: Camera, lam_dist: float = 1.0) -> RasterizeConfig:
        """With the distortion loss off and median-only surface depth, the
        kernels skip their distortion machinery (K1/K2 no_dist)."""
        no_dist = lam_dist == 0.0 and float(self.pipe.depth_ratio) == 1.0
        return RasterizeConfig(width=int(cam.width), height=int(cam.height),
                               no_depth_dist=no_dist)

    def _pop_cam(self) -> int:
        if not self._stack:
            self._stack = list(range(len(self.cams)))
        return self._stack.pop(self.rng.randint(0, len(self._stack) - 1))

    def split_noise(self, capacity: int) -> torch.Tensor:
        """Standard-normal split noise [2, capacity, 3] for densification."""
        return torch.randn((2, capacity, 3), generator=self.generator,
                           device=self.device)

    def _dp_run(self, lrs: dict, lam: tuple, on_stage=None) -> dict:
        """One data-parallel step: every rank pops the same `dp` cameras
        and trains on the rank-th (JAX pipelines/train.py:438-486)."""
        from ..parallel.data_parallel import dp_train_step
        idxs = [self._pop_cam() for _ in range(self.dp)]
        fovs = {(round(self.cams[i].tanfovx, 6),
                 round(self.cams[i].tanfovy, 6)) for i in idxs}
        if len(fovs) != 1:
            # the batch shares one ray grid (depth → normal)
            raise ValueError(
                f"--dp requires uniform camera intrinsics; got tanfovs "
                f"{sorted(fovs)} in one batch")
        i = idxs[self.rank]
        self.params, self.opt_state, self.stats, metrics = dp_train_step(
            self.params, self.opt_state, self.stats, self.cams[i], self.bg,
            lrs, *lam, self._cfg(self.cam_objs[i], lam_dist=lam[1]),
            float(self.pipe.depth_ratio), group=self.group,
            on_stage=on_stage)
        return metrics

    def step(self, iteration: int, cam_idx: Optional[int] = None,
             on_stage=None) -> dict:
        opt = self.opt
        if iteration % 1000 == 0:
            self.params = self.params.one_up_sh_degree()
        lrs = geometry_lrs(opt, self.spatial_lr_scale,
                           self.xyz_sched(iteration))
        lam_normal = opt.lambda_normal if iteration > 7000 else 0.0
        lam_dist = opt.lambda_dist if iteration > 3000 else 0.0
        lam_prior = opt.lambda_normal_prior if iteration > 7000 else 0.0
        lam = (opt.lambda_dssim, lam_dist, lam_normal, lam_prior)
        if self.dp and cam_idx is None:
            metrics = self._dp_run(lrs, lam, on_stage)
        else:
            if cam_idx is None:
                cam_idx = self._pop_cam()
            cfg = self._cfg(self.cam_objs[cam_idx], lam_dist=lam_dist)
            self.params, self.opt_state, self.stats, metrics = train_step(
                self.params, self.opt_state, self.stats, self.cams[cam_idx],
                self.bg, lrs, *lam, cfg, float(self.pipe.depth_ratio),
                on_stage=on_stage)

        # densification schedule (reference train.py:139-151)
        if iteration < opt.densify_until_iter:
            if (iteration > opt.densify_from_iter
                    and iteration % opt.densification_interval == 0):
                size_thr = (20.0 if iteration > opt.opacity_reset_interval
                            else 0.0)
                (self.params, self.opt_state, self.stats,
                 n_overflow) = dens.densify_and_prune(
                    self.params, self.opt_state, self.stats,
                    self.split_noise(self.params.capacity),
                    opt.densify_grad_threshold, opt.opacity_cull,
                    float(self.scene.cameras_extent), size_thr,
                    percent_dense=opt.percent_dense,
                    use_screen_size=iteration > opt.opacity_reset_interval)
                if n_overflow > 0:
                    (self.params, self.opt_state,
                     self.stats) = dens.grow_capacity(
                        self.params, self.opt_state, self.stats,
                        self.params.capacity * 2)
            if (iteration % opt.opacity_reset_interval == 0
                    or (self.dataset.white_background
                        and iteration == opt.densify_from_iter)):
                self.params, self.opt_state = dens.reset_opacity(
                    self.params, self.opt_state)
        return metrics

    def _eval(self, ct, obj) -> dict:
        return eval_step(self.params, ct, self.bg, self._cfg(obj),
                         float(self.pipe.depth_ratio))

    def evaluate(self, cameras: Optional[List[int]] = None,
                 split: str = "train") -> dict:
        cams = self.cams if split == "train" else self.test_cams
        objs = self.cam_objs if split == "train" else self.test_cam_objs
        idxs = cameras if cameras is not None else range(len(cams))
        res = [self._eval(cams[i], objs[i]) for i in idxs]
        return {"l1": float(np.mean([float(r["l1"]) for r in res])),
                "psnr": float(np.mean([float(r["psnr"]) for r in res]))}

    def training_report(self, iteration: int, tb=None,
                        is_first_test_iter: bool = False,
                        max_tb_views: int = 5) -> dict:
        """L1/PSNR over all test cameras (the --eval split) and the train
        cameras [idx % n_train for idx in 5, 10, ..., 25], printed and,
        with a TensorBoard writer `tb`, logged with image grids of each
        config's first max_tb_views views (+ the ground truth at the first
        test iteration) (reference train.py:222-279)."""
        from ..utils.tb import log_eval_images, log_eval_scalars
        results = {}
        n_train = len(self.cams)
        configs = [("test", self.test_cams, self.test_cam_objs,
                    list(range(len(self.test_cams)))),
                   ("train", self.cams, self.cam_objs,
                    [idx % n_train for idx in range(5, 30, 5)])]
        for name, cams, objs, idxs in configs:
            if not idxs or not cams:
                continue
            l1s, psnrs = [], []
            for k, i in enumerate(idxs):
                m = self._eval(cams[i], objs[i])
                l1s.append(float(m["l1"]))
                psnrs.append(float(m["psnr"]))
                if tb is not None and k < max_tb_views:
                    log_eval_images(tb, iteration, name, objs[i].image_name,
                                    m, with_gt=is_first_test_iter)
            res = {"l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs))}
            print(f"\n[ITER {iteration}] Evaluating {name}: "
                  f"L1 {res['l1']:.4f} PSNR {res['psnr']:.2f}", flush=True)
            log_eval_scalars(tb, iteration, name, res["l1"], res["psnr"],
                             int(self.params.n_alive()))
            results[name] = res
        return results

    def save(self, iteration: int) -> str:
        path = os.path.join(self.scene.model_path,
                            f"point_cloud/iteration_{iteration}",
                            "point_cloud.ply")
        save_ply(self.params, path)
        return path

    def log(self, iteration: int, metrics: dict, seconds: float) -> None:
        """EMA of the losses, printed with the gaussian count."""
        for k in ("loss", "dist", "normal"):
            self.ema[k] = 0.4 * float(metrics[k]) + 0.6 * self.ema[k]
        print(f"[ITER {iteration}] loss {self.ema['loss']:.5f} distort "
              f"{self.ema['dist']:.5f} normal {self.ema['normal']:.5f} "
              f"points {self.params.n_alive()} ({seconds * 1e3:.1f} ms/it)",
              flush=True)

    def train(self, iterations: Optional[int] = None, test_iterations=(),
              save_iterations=(), log_every: int = 10, first_iter: int = 0,
              checkpoint_iterations=(), progress: bool = True,
              on_iteration: Optional[Callable[[int], None]] = None,
              tb=None, tracer=None):
        """Run iterations first_iter+1..iterations; `on_iteration(it)` is
        called at the end of each (the CLI's network viewer). With a
        TensorBoard writer `tb`, every 10th step's losses and host time and
        the reports go to it; a utils/profiling.TraceWindow `tracer` is
        ticked at the top of each iteration and closed at the end. Under
        dp only rank 0 logs, reports, saves and checkpoints; the other
        ranks wait for it at a barrier after each of those iterations."""
        from ..utils.tb import log_train_scalars
        from .checkpoint import save_checkpoint
        iterations = iterations or self.opt.iterations
        t_last = time.perf_counter()
        for it in range(first_iter + 1, iterations + 1):
            if tracer is not None:
                tracer.tick(it)
            t_step = time.perf_counter()
            metrics = self.step(it)
            if tb is not None and it % 10 == 0:
                log_train_scalars(tb, it, metrics,
                                  time.perf_counter() - t_step)
            main = self.rank == 0
            if progress and main and it % log_every == 0:
                now = time.perf_counter()
                self.log(it, metrics, (now - t_last) / log_every)
                t_last = now
            host = (it in test_iterations, it in save_iterations,
                    it in checkpoint_iterations)
            if main and host[0]:
                self.reports[it] = self.training_report(
                    it, tb, is_first_test_iter=it == min(test_iterations))
            if main and host[1]:
                print(f"\n[ITER {it}] Saving Gaussians", flush=True)
                self.save(it)
            if main and host[2]:
                save_checkpoint(self, self.scene.model_path, it)
            if self.dp and any(host):
                dist.barrier(group=self.group)  # rank 0's files are written
            if on_iteration is not None:
                on_iteration(it)
        if tracer is not None:
            tracer.close()      # also a trace left open mid-window
        return self
