"""The benchmark's scenes and cameras, made on the device from the seed.

Frozen copy of the arithmetic of instascene_tpu_torch/data/synthetic.py
(`make_bench_scene`, profile "trained", and `look_at`) and of
instascene_tpu_torch/cameras.py (`get_world2view`, `get_projection_matrix`,
`Camera.__post_init__`) at commit e06f678. Later changes to the program do
not move them.

What differs from make_bench_scene: the per-gaussian draws come from a
torch.Generator on the device, in a few large calls, instead of numpy on
the host; and the scene's layout (the cluster centres, radii, colours and
features) comes from the configuration's `layout_seed`, so every --seed
draws its gaussians into the same envelope and gives the same amount of
work, in another arrangement.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

FEATURE_DIM_REST = 15        # SH degree 3: 16 coefficients, 15 beyond DC


def look_at(cam_pos: np.ndarray, target: np.ndarray,
            up=np.array([0.0, 0.0, 1.0])):
    """w2c (R_w2c, t), COLMAP convention (x right, y down, z forward)."""
    fwd = target - cam_pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_w2c = np.stack([right, down, fwd], axis=0)
    return R_w2c, -R_w2c @ cam_pos


def projection(znear: float, zfar: float, fovx: float,
               fovy: float) -> np.ndarray:
    """Perspective view→clip matrix with w = z_view."""
    top = math.tan(fovy / 2) * znear
    right = math.tan(fovx / 2) * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclass
class View:
    """One camera as both sides take it: host matrices (float32) and the
    sizes. w2v maps world to view as p_view = w2v[:3,:3] @ p + w2v[:3,3]."""
    width: int
    height: int
    w2v: np.ndarray
    full_proj: np.ndarray
    campos: np.ndarray
    c2w_rot: np.ndarray
    tanfovx: float
    tanfovy: float


def orbit_view(angle: float, cfg: dict, width: int, height: int,
               fovy: float) -> View:
    """A camera on the configuration's orbit ring at `angle` (radians),
    looking at the origin: make_bench_scene's make_cam with a continuous
    angle."""
    r, h = cfg["orbit_radius"], cfg["orbit_height"]
    pos = np.array([r * math.cos(angle), r * math.sin(angle), h])
    R_w2c, t = look_at(pos, np.zeros(3))
    w2c = np.eye(4)
    w2c[:3, :3] = R_w2c
    w2c[:3, 3] = t
    w2v = w2c.astype(np.float32)
    fovx = cfg["fovx"]
    full_proj = (projection(0.01, 100.0, fovx, fovy) @ w2v).astype(
        np.float32)
    c2w = np.linalg.inv(w2c)
    return View(width, height, w2v, full_proj,
                np.linalg.inv(w2v)[:3, 3].astype(np.float32),
                np.ascontiguousarray(c2w[:3, :3].astype(np.float32)),
                math.tan(fovx * 0.5), math.tan(fovy * 0.5))


def train_view(i: int, cfg: dict) -> View:
    """Training camera i of the configuration's orbit of n_cameras."""
    return orbit_view(2 * math.pi * i / cfg["n_cameras"], cfg,
                      cfg["train_width"], cfg["train_height"],
                      cfg["train_fovy"])


def make_scene(cfg: dict, seed: int, dev) -> dict:
    """The `trained` profile's gaussians as device tensors under the
    program's field names (xyz, features_dc, features_rest, scaling,
    rotation, opacity, seg_feature, alive). The layout comes from
    cfg["layout_seed"], the gaussians from `seed` on the device."""
    n, K, E = cfg["n_gaussians"], cfg["clusters"], cfg["seg_feat_dim"]
    lay = np.random.default_rng(cfg["layout_seed"])
    centers = lay.normal(0, 0.9, (K, 3))
    radii = np.exp(lay.normal(np.log(0.18), 0.5, K))
    cluster_color = lay.normal(0, 0.45, (K + 1, 3))
    cluster_feat = lay.random((K + 1, E))
    f32 = torch.float32
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    centers, radii = t(centers), t(radii)
    cluster_color, cluster_feat = t(cluster_color), t(cluster_feat)

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n_bg = n // 8
    n_fg = n - n_bg
    clusters = torch.cat([
        torch.randint(0, K, (n_fg,), generator=gen, device=dev),
        torch.full((n_bg,), K, dtype=torch.int64, device=dev)])
    normal = torch.randn((n, 3 + 3 + 1 + 1 + 4), generator=gen,
                         device=dev, dtype=f32)
    uni = torch.rand((n, 5 + E), generator=gen, device=dev, dtype=f32)
    fg = clusters < K
    cf = clusters.clamp(max=K - 1)
    xyz = torch.where(fg[:, None],
                      centers[cf] + normal[:, 0:3] * radii[cf][:, None],
                      normal[:, 0:3] * 1.6)
    base = normal[:, 6] * 0.7 + math.log(0.008)
    aniso = torch.abs(normal[:, 7] * 0.35 + 0.5)
    scaling = torch.stack([base + 0.5 * aniso, base - 0.5 * aniso], dim=-1)
    u = uni[:, 0]
    op = torch.where(u < 0.6, 0.5 + 0.495 * uni[:, 1] ** 0.35,
                     torch.where(u < 0.9, 0.05 + 0.45 * uni[:, 2],
                                 0.05 + 0.05 * uni[:, 3]))
    op = op.clamp(0.05, 0.995)
    opacity = torch.log(op / (1 - op))[:, None]
    fdc = (cluster_color[clusters] + normal[:, 3:6] * 0.08)[:, None, :]
    segf = cluster_feat[clusters] + 0.05 * uni[:, 5:5 + E]
    return dict(
        xyz=xyz.contiguous(), features_dc=fdc.contiguous(),
        features_rest=torch.zeros((n, FEATURE_DIM_REST, 3), device=dev,
                                  dtype=f32),
        scaling=scaling.contiguous(),
        rotation=normal[:, 8:12].contiguous(), opacity=opacity.contiguous(),
        seg_feature=segf.contiguous(),
        alive=torch.ones(n, dtype=torch.bool, device=dev))


def pca_projection(feats: torch.Tensor, seed: int = 0,
                   n_sample: int = 200_000) -> torch.Tensor:
    """[E,3] PCA projection of sampled normalised, centred features: the
    arithmetic of instascene_tpu_torch/semantic/export.py::pca_proj_matrix
    (the viewer's feature colouring), on the host in numpy."""
    f = feats.detach().cpu().numpy()
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, f.shape[0], min(n_sample, f.shape[0] * 4))
    f = f[idx]
    f = f / (np.linalg.norm(f, axis=1, keepdims=True) + 1e-6)
    f = f - f.mean(axis=0)
    eigvals, eigvecs = np.linalg.eigh(f.T @ f / len(f))
    order = np.argsort(-eigvals)
    return torch.as_tensor(eigvecs[:, order[:3]].astype(np.float32),
                           device=feats.device)
