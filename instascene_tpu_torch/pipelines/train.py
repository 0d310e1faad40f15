"""Geometry training: the 2DGS train step and the trainer that drives it.

Port of instascene_tpu/pipelines/train.py:36-151 (`rays_from_cam`,
`render_for_training`, `geometry_loss_fn`, `train_step`, `eval_step`),
:207-262 and :287-304 (`CameraTensors`, `camera_tensors`,
`GeometryTrainer` and its `_cfg` rule) and :433-636 (the camera stack,
`step` with the SH, λ and densification schedules, `evaluate`,
`training_report`, `save`, `train`).

One step: render → photometric (L1 + SSIM) + distortion + normal
consistency (+ the optional mono-normal prior) → gradients by torch
autograd, whose blend backward is K2, and of the zero t_offset tap →
densification stats + Adam. The TPU scheduling around the JAX step (pair
caps and their autotune, the slow-roll watchdog, device scalars) has no
counterpart: buffers follow each frame's pair total. Camera-batch data
parallelism (--dp) and TensorBoard logging wait for a later slice.
"""

from __future__ import annotations

import math
import os
import random
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..cameras import Camera
from ..losses import l1_loss, photometric_loss, psnr
from ..models import densify as dens
from ..models.gaussians import GaussianModel, create_from_pcd, save_ply
from ..models.optimizer import (TRAINABLE_FIELDS, adam_step, geometry_lrs,
                                init_adam_state)
from ..ops.depth_utils import depth_to_normal
from ..ops.knn import mean_dist2_knn3
from ..ops.rasterize import (CameraMats, RasterizeConfig,
                             densify_screen_grad, rasterize)
from ..utils.general import get_expon_lr_func


def rays_from_cam(width: int, height: int, tanfovx: float, tanfovy: float,
                  c2w_rot: torch.Tensor) -> torch.Tensor:
    """Per-pixel world ray directions [H,W,3] through integer pixel
    coordinates, image centre W/2."""
    dev = c2w_rot.device
    fx = width / (2 * tanfovx)
    fy = height / (2 * tanfovy)
    x = (torch.arange(width, dtype=torch.float32, device=dev) - width / 2) / fx
    y = (torch.arange(height, dtype=torch.float32, device=dev)
         - height / 2) / fy
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return (xx[..., None] * c2w_rot[:, 0] + yy[..., None] * c2w_rot[:, 1]
            + c2w_rot[:, 2])


def render_for_training(params: GaussianModel, cam: CameraMats, bg,
                        cfg: RasterizeConfig, t_offset, c2w_rot,
                        tanfovx: float, tanfovy: float, depth_ratio: float):
    """Render + the derived maps the losses read (channels-last):
    (RasterizeOut, rend_normal, surf_normal, alpha, surf_depth)."""
    out = rasterize(params.xyz, params.scaling_activated(),
                    params.rotation_normalized(),
                    params.opacity_activated()[:, 0], cam, bg, cfg,
                    shs=params.features(), sh_degree=params.active_sh_degree,
                    extras=params.seg_feature_normed(), t_offset=t_offset,
                    alive=params.alive)
    b = out.blend
    R = cam.w2v[:3, :3]
    rend_normal = (b.normal[..., 0:1] * R[0] + b.normal[..., 1:2] * R[1]
                   + b.normal[..., 2:3] * R[2])
    alpha = b.alpha[..., None]
    alpha_ok = alpha > 0
    depth_exp = torch.where(
        alpha_ok, b.depth[..., None] / torch.where(alpha_ok, alpha, 1.0), 0.0)
    depth_med = torch.nan_to_num(b.median_depth[..., None], 0.0)
    surf_depth = depth_exp * (1 - depth_ratio) + depth_ratio * depth_med
    rays = rays_from_cam(cfg.width, cfg.height, tanfovx, tanfovy, c2w_rot)
    surf_normal = depth_to_normal(surf_depth[..., 0], rays, cam.campos)
    surf_normal = surf_normal * alpha.detach()
    return out, rend_normal, surf_normal, alpha, surf_depth


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


def train_step(params: GaussianModel, opt_state, stats: dens.DensifyStats,
               ct: CameraTensors, bg, lrs: dict, lambda_dssim: float,
               lambda_dist: float, lambda_normal: float,
               lambda_normal_prior: float, cfg: RasterizeConfig,
               depth_ratio: float,
               on_stage: Optional[Callable[[str], None]] = None):
    """One geometry step → (params, opt_state, stats, metrics). Metrics
    are device scalars (read them only when needed) plus the frame's pair
    count. on_stage(name), when given, is called as each stage ends:
    "render", "loss", "backward", "adam" (for timing)."""
    mark = on_stage or (lambda name: None)
    leaves = {f: getattr(params, f).detach().requires_grad_(True)
              for f in TRAINABLE_FIELDS if getattr(params, f) is not None}
    p = params.replace(**leaves)
    t0 = torch.zeros((params.capacity, 3, 3), dtype=torch.float32,
                     device=params.device, requires_grad=True)
    parts = render_for_training(p, ct.mats, bg, cfg, t0, ct.c2w_rot,
                                ct.tanfovx, ct.tanfovy, depth_ratio)
    mark("render")
    loss, aux = geometry_loss_fn(parts, ct, lambda_dssim, lambda_dist,
                                 lambda_normal, lambda_normal_prior)
    mark("loss")
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[f] for f in names] + [t0],
                                allow_unused=True)
    mark("backward")
    t_grad = grads[-1] if grads[-1] is not None else torch.zeros_like(t0)
    with torch.no_grad():
        screen_grad = densify_screen_grad(t_grad, aux["depth"], cfg.width,
                                          cfg.height)
        stats = dens.add_densification_stats(stats, screen_grad,
                                             aux["visible"], aux["radii"])
        params, opt_state = adam_step(params, dict(zip(names, grads[:-1])),
                                      opt_state, lrs)
    mark("adam")
    metrics = {"loss": loss.detach(), "ll1": aux["ll1"].detach(),
               "dist": aux["dist"].detach(),
               "normal": aux["normal"].detach(),
               "total_pairs": aux["total_pairs"]}
    return params, opt_state, stats, metrics


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
    `device` (CUDA unless "cpu" is asked for)."""

    def __init__(self, dataset, opt, pipe, scene, seed: int = 0,
                 capacity_multiplier: float = 4.0, device=None):
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

    def step(self, iteration: int, cam_idx: Optional[int] = None,
             on_stage=None) -> dict:
        opt = self.opt
        if iteration % 1000 == 0:
            self.params = self.params.one_up_sh_degree()
        if cam_idx is None:
            cam_idx = self._pop_cam()
        lrs = geometry_lrs(opt, self.spatial_lr_scale,
                           self.xyz_sched(iteration))
        lam_normal = opt.lambda_normal if iteration > 7000 else 0.0
        lam_dist = opt.lambda_dist if iteration > 3000 else 0.0
        lam_prior = opt.lambda_normal_prior if iteration > 7000 else 0.0
        cfg = self._cfg(self.cam_objs[cam_idx], lam_dist=lam_dist)
        self.params, self.opt_state, self.stats, metrics = train_step(
            self.params, self.opt_state, self.stats, self.cams[cam_idx],
            self.bg, lrs, opt.lambda_dssim, lam_dist, lam_normal, lam_prior,
            cfg, float(self.pipe.depth_ratio), on_stage=on_stage)

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
        m = eval_step(self.params, ct, self.bg, self._cfg(obj),
                      float(self.pipe.depth_ratio))
        return {"l1": float(m["l1"]), "psnr": float(m["psnr"])}

    def evaluate(self, cameras: Optional[List[int]] = None,
                 split: str = "train") -> dict:
        cams = self.cams if split == "train" else self.test_cams
        objs = self.cam_objs if split == "train" else self.test_cam_objs
        idxs = cameras if cameras is not None else range(len(cams))
        res = [self._eval(cams[i], objs[i]) for i in idxs]
        return {"l1": float(np.mean([r["l1"] for r in res])),
                "psnr": float(np.mean([r["psnr"] for r in res]))}

    def training_report(self, iteration: int) -> dict:
        """L1/PSNR over all test cameras (the --eval split) and the train
        cameras [idx % n_train for idx in 5, 10, ..., 25], printed (reference
        train.py:222-279; its TensorBoard images wait for a later slice)."""
        results = {}
        n_train = len(self.cams)
        configs = [("test", self.test_cams, self.test_cam_objs,
                    list(range(len(self.test_cams)))),
                   ("train", self.cams, self.cam_objs,
                    [idx % n_train for idx in range(5, 30, 5)])]
        for name, cams, objs, idxs in configs:
            if not idxs or not cams:
                continue
            r = [self._eval(cams[i], objs[i]) for i in idxs]
            res = {"l1": float(np.mean([x["l1"] for x in r])),
                   "psnr": float(np.mean([x["psnr"] for x in r]))}
            print(f"\n[ITER {iteration}] Evaluating {name}: "
                  f"L1 {res['l1']:.4f} PSNR {res['psnr']:.2f}", flush=True)
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
              checkpoint_iterations=(), progress: bool = True):
        from .checkpoint import save_checkpoint
        iterations = iterations or self.opt.iterations
        t_last = time.perf_counter()
        for it in range(first_iter + 1, iterations + 1):
            metrics = self.step(it)
            if progress and it % log_every == 0:
                now = time.perf_counter()
                self.log(it, metrics, (now - t_last) / log_every)
                t_last = now
            if it in test_iterations:
                self.reports[it] = self.training_report(it)
            if it in save_iterations:
                print(f"\n[ITER {it}] Saving Gaussians", flush=True)
                self.save(it)
            if it in checkpoint_iterations:
                save_checkpoint(self, self.scene.model_path, it)
        return self
