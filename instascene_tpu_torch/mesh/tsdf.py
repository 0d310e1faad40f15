"""TSDF fusion of rendered depth maps on the device (a dense volume in
x-slabs), and its mesh.

Port of instascene_tpu/mesh/tsdf.py: `integrate_slab` is the `lax.scan`
body of `_integrate_slab` (:17-66) as a loop over the cameras, in float32
with the same operation order; `tsdf_fusion_mesh` is :69-157 with the same
bounds estimate (numpy float64 on a subsample of the depth maps), voxel cap,
slab plan (1-voxel overlap: the slab planes' vertices are duplicated, as in
the JAX package) and nearest-voxel vertex colors. The depth and color maps,
the volume and the marching stay on the maps' device; the slabs' meshes come
back to the host.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.preprocess import fma, fma_rows
from .marching import marching_tetrahedra


def sync_clock(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def add_seconds(stats: Optional[dict], key: str, t0: float, dev) -> float:
    """Adds the seconds since t0 (the device's queue drained) to stats[key]
    when stats is a dict; returns the clock."""
    if stats is None:
        return t0
    t1 = sync_clock(dev)
    stats[key] = stats.get(key, 0.0) + t1 - t0
    return t1


def integrate_slab(voxels, w2c, intr, depths, rgbs, depth_trunc: float,
                   sdf_trunc: float, height: int, width: int):
    """voxels [V,3]; w2c [C,4,4]; intr [C,4] (fx,fy,cx,cy); depths [C,H,W];
    rgbs [C,H,W,3], all float32 on one device. Returns (tsdf [V], weight
    [V], color [V,3]). The products and sums are rounded as XLA's CPU
    backend rounds the JAX package's (its multiply-adds contracted), so
    the outputs are the JAX package's bits on the CPU and on the card."""
    dev = voxels.device
    # device scalars: a CUDA division by a host scalar multiplies by its
    # reciprocal, a division by a tensor divides
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    depth_trunc, sdf_trunc = f32(depth_trunc), f32(sdf_trunc)
    n = voxels.shape[0]
    tsdf = torch.ones(n, device=dev)
    weight = torch.zeros(n, device=dev)
    color = torch.zeros((n, 3), device=dev)
    for i in range(w2c.shape[0]):
        pv = fma_rows(voxels, w2c[i, :3, :3]) + w2c[i, :3, 3]
        z = pv[:, 2]
        zc = torch.clamp(z, min=1e-8)
        u = fma(pv[:, 0] / zc, intr[i, 0].expand(n), intr[i, 2].expand(n))
        v = fma(pv[:, 1] / zc, intr[i, 1].expand(n), intr[i, 3].expand(n))
        # clamped before the cast: an out-of-range float has no int32
        u0 = torch.clamp(torch.floor(u), 0, width - 2)
        v0 = torch.clamp(torch.floor(v), 0, height - 2)
        fu = torch.clamp(u - u0, 0.0, 1.0)[:, None]
        fv = torch.clamp(v - v0, 0.0, 1.0)[:, None]
        at = v0.long() * width + u0.long()

        def corners(img):
            img = img.reshape(height * width, -1)
            return (img[at], img[at + 1], img[at + width],
                    img[at + width + 1])

        # bilinear samples, contracted as XLA's CPU backend contracts them
        # (the depth's rows fuse their second product, the colors' their
        # first)
        d00, d01, d10, d11 = corners(depths[i])
        fu1, fv1 = fu.expand_as(d00), fv.expand_as(d00)
        d = fma(1 - fv1, fma(fu1, d01, (1 - fu1) * d00),
                fv1 * fma(fu1, d11, (1 - fu1) * d10))[:, 0]
        c00, c01, c10, c11 = corners(rgbs[i])
        fu3, fv3 = fu.expand_as(c00), fv.expand_as(c00)
        c = fma(1 - fv3, fma(1 - fu3, c00, fu3 * c01),
                fv3 * fma(1 - fu3, c10, fu3 * c11))
        in_img = (u >= 0) & (u <= width - 1) & (v >= 0) & (v <= height - 1)
        valid = (z > 0) & in_img & (d > 0) & (d <= depth_trunc)
        sdf = d - z
        valid = valid & (sdf > -sdf_trunc)
        tsdf_new = torch.clamp(sdf / sdf_trunc, max=1.0)
        w_new = valid.to(torch.float32)
        tsdf = fma(tsdf, weight, tsdf_new * w_new) / torch.clamp(
            weight + w_new, min=1e-8)
        w3 = weight[:, None].expand_as(color)
        color = fma(color, w3, c * w_new[:, None]) / torch.clamp(
            weight[:, None] + w_new[:, None], min=1e-8)
        weight = weight + w_new
    return tsdf, weight, color


def _stack(maps, dev):
    return torch.stack([torch.as_tensor(np.asarray(m) if not isinstance(
        m, torch.Tensor) else m, device=dev) for m in maps]).to(torch.float32)


def estimate_bounds(depth_maps, w2cs, intrinsics, depth_trunc: float,
                    sdf_trunc: float):
    """Scene bounds from the depth maps unprojected at every
    max(1, h // 64)-th pixel (tsdf.py:82-102, numpy float64); only that
    subsample leaves the device."""
    h, w = depth_maps[0].shape[:2]
    step = max(1, h // 64)
    mins = np.full(3, np.inf)
    maxs = np.full(3, -np.inf)
    for d, w2c, K in zip(depth_maps, w2cs, intrinsics):
        fx, fy, cx, cy = K
        ys, xs = np.mgrid[0:h:step, 0:w:step]
        sub = d[0:h:step, 0:w:step]
        z = (sub.cpu().numpy() if isinstance(sub, torch.Tensor)
             else np.asarray(sub)).reshape(-1)
        ok = (z > 0) & (z <= depth_trunc)
        if not ok.any():
            continue
        x = (xs.reshape(-1)[ok] - cx) / fx * z[ok]
        y = (ys.reshape(-1)[ok] - cy) / fy * z[ok]
        pc = np.stack([x, y, z[ok]], -1)
        c2w = np.linalg.inv(w2c)
        pw = pc @ c2w[:3, :3].T + c2w[:3, 3]
        mins = np.minimum(mins, pw.min(0))
        maxs = np.maximum(maxs, pw.max(0))
    return mins - 2 * sdf_trunc, maxs + 2 * sdf_trunc


def tsdf_fusion_mesh(depth_maps, rgb_maps, w2cs, intrinsics,
                     voxel_size: float = 0.004, sdf_trunc: float = 0.02,
                     depth_trunc: float = 3.0, bounds=None,
                     max_slab_voxels: int = 2_000_000, max_dim: int = 512,
                     device=None, stats: Optional[dict] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fuse depth maps ([H,W] each) and color maps ([H,W,3]) and extract a
    mesh. Returns host (verts [V,3] f32, faces [F,3] i32, vert_colors
    [V,3] f32). intrinsics: per-camera (fx, fy, cx, cy) numpy f32; w2cs
    numpy 4x4.

    The maps may be tensors (the fusion runs on their device) or numpy
    arrays (moved to `device`). stats (a dict) gets the seconds of
    "fusion" (integration and vertex colors) and "marching" added, and the
    volume's "grid" (X, Y, Z) and "voxel" size."""
    dev = (depth_maps[0].device if isinstance(depth_maps[0], torch.Tensor)
           else resolve_device(device))
    t0 = sync_clock(dev) if stats is not None else 0.0
    h, w = depth_maps[0].shape[:2]
    if bounds is None:
        bounds = estimate_bounds(depth_maps, w2cs, intrinsics, depth_trunc,
                                 sdf_trunc)
    mins, maxs = np.asarray(bounds[0], np.float64), np.asarray(bounds[1],
                                                               np.float64)
    dims = np.ceil((maxs - mins) / voxel_size).astype(int) + 1
    if dims.max() > max_dim:
        voxel_size = float((maxs - mins).max() / max_dim)
        dims = np.ceil((maxs - mins) / voxel_size).astype(int) + 1
    X, Y, Z = [int(v) for v in dims]
    if stats is not None:
        stats.update(grid=(X, Y, Z), voxel=voxel_size)

    w2c_t = torch.as_tensor(np.stack(w2cs).astype(np.float32), device=dev)
    intr_t = torch.as_tensor(np.stack(intrinsics).astype(np.float32),
                             device=dev)
    depth_t = _stack(depth_maps, dev).reshape(len(depth_maps), h, w)
    rgb_t = _stack(rgb_maps, dev)
    f64 = dict(dtype=torch.float64, device=dev)
    vs = torch.tensor(voxel_size, **f64)

    slab_x = max(2, min(X, max_slab_voxels // max(Y * Z, 1)))
    verts_all, faces_all, cols_all = [], [], []
    n_verts = 0
    x0 = 0
    ys = float(mins[1]) + voxel_size * torch.arange(Y, **f64)
    zs = float(mins[2]) + voxel_size * torch.arange(Z, **f64)
    while x0 < X - 1:
        x1 = min(x0 + slab_x, X)
        xs = float(mins[0]) + voxel_size * torch.arange(x0, x1, **f64)
        grid = torch.stack(torch.meshgrid(xs, ys, zs, indexing="ij"),
                           dim=-1).reshape(-1, 3).to(torch.float32)
        tsdf, weight, color = integrate_slab(
            grid, w2c_t, intr_t, depth_t, rgb_t, float(depth_trunc),
            float(sdf_trunc), h, w)
        field = torch.where(weight > 0, tsdf, 1.0).reshape(x1 - x0, Y, Z)
        color = color.reshape(x1 - x0, Y, Z, 3)
        t0 = add_seconds(stats, "fusion", t0, dev)
        org = (mins[0] + x0 * voxel_size, mins[1], mins[2])
        v, f = marching_tetrahedra(field.to(torch.float64), level=0.0,
                                   origin=org, spacing=voxel_size)
        t0 = add_seconds(stats, "marching", t0, dev)
        if len(v):
            # vertex colors by nearest voxel
            rel = (v.to(torch.float64) - torch.tensor(org, **f64)) / vs
            hi = torch.tensor([x1 - x0 - 1, Y - 1, Z - 1], device=dev)
            gi = torch.minimum(torch.clamp(torch.round(rel).long(), min=0),
                               hi)
            vc = color[gi[:, 0], gi[:, 1], gi[:, 2]]
            verts_all.append(v.cpu().numpy())
            faces_all.append(f.cpu().numpy() + n_verts)
            cols_all.append(vc.cpu().numpy())
            n_verts += len(v)
        t0 = add_seconds(stats, "fusion", t0, dev)
        x0 = x1 - 1  # 1-voxel overlap keeps slab boundaries watertight-ish

    if not verts_all:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                np.zeros((0, 3), np.float32))
    return (np.concatenate(verts_all), np.concatenate(faces_all),
            np.concatenate(cols_all))
