"""Tile-based triangle rasterizer: camera-ray mesh queries without a BVH.

Port of instascene_tpu/ops/mesh_raster.py (`rasterize_mesh`,
`mesh_normal_prior`) in torch ops on the mesh's device. Triangles are binned
to 16x16 tiles with buffers sized to the exact pair total; every (tile,
triangle) pair tests the tile's 256 pixel positions with the JAX package's
arithmetic (the same `area`, `inside` and `zhit > 1e-4` tests,
perspective-correct depth), and each pixel keeps its nearest hit. The JAX
package's `pair_cap`, `tile_cap` and `chunk` are TPU static-shape
artifacts and are gone: nothing is dropped. On a depth tie the smallest
face id wins (in the JAX package, the face first in its tile's list).

The world position of a hit is the camera centre plus depth times the
pixel's ray rotated by the camera-to-world rotation. The JAX package rotates
the ray by the world-to-camera rotation instead, so its positions are off
the surface for any camera whose rotation is not symmetric (ROADMAP C); the
two agree where it is (an identity camera).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device

# (tile, triangle) pairs tested per step: bounds the [pairs, 256] temporaries
_PAIRS_PER_STEP = 1 << 14


class MeshRasterOut(NamedTuple):
    depth: torch.Tensor     # [H,W] view-space z (0 = miss)
    face_id: torch.Tensor   # [H,W] int32 (-1 = miss)
    position: torch.Tensor  # [H,W,3] world-space hit point
    normal: torch.Tensor    # [H,W,3] unit face normal (world)


def _nearest_hits(tri_u, tri_v, tri_z, fid, tile_id, grid_x, tile, best):
    """Folds the hits of pairs (fid, tile_id) into best [T*tile²] int64
    keys (z bits << 32 | face id: the nearest z, then the smallest id)."""
    P2 = tile * tile
    dev = tri_u.device
    lane = torch.arange(tile, dtype=torch.float32, device=dev)
    ly = lane.repeat_interleave(tile)[None]          # pixel row in the tile
    lx = lane.repeat(tile)[None]
    tx = (tile_id % grid_x).to(torch.float32)[:, None]
    ty = (tile_id // grid_x).to(torch.float32)[:, None]
    px = tx * tile + lx
    py = ty * tile + ly
    au, bu, cu = (tri_u[fid, k][:, None] for k in range(3))
    av, bv, cv = (tri_v[fid, k][:, None] for k in range(3))
    az, bz, cz = (tri_z[fid, k][:, None] for k in range(3))
    area = (bu - au) * (cv - av) - (bv - av) * (cu - au)
    area_ok = torch.abs(area) > 1e-12
    inv_area = torch.where(area_ok, 1.0 / torch.where(area_ok, area, 1.0),
                           0.0)
    w0 = ((bu - px) * (cv - py) - (bv - py) * (cu - px)) * inv_area
    w1 = ((cu - px) * (av - py) - (cv - py) * (au - px)) * inv_area
    w2 = 1.0 - w0 - w1
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    inv_z = w0 / az + w1 / bz + w2 / cz
    zhit = 1.0 / torch.clamp(inv_z, min=1e-12)
    hit = inside & area_ok & (zhit > 1e-4)
    rows, cols = torch.nonzero(hit, as_tuple=True)
    key = ((zhit[rows, cols].view(torch.int32).to(torch.int64) << 32)
           | fid[rows])
    best.scatter_reduce_(0, tile_id[rows] * P2 + cols, key, reduce="amin")


def rasterize_mesh(verts, faces, w2v, intr, width: int, height: int,
                   tile: int = 16) -> MeshRasterOut:
    """verts [V,3] f32 world; faces [F,3] int; w2v [4,4]; intr (fx,fy,cx,cy),
    all on one device (the output's)."""
    dev = verts.device
    verts = verts.to(torch.float32)
    faces = faces.to(torch.int64)
    w2v = w2v.to(torch.float32)
    intr = intr.to(torch.float32)
    grid_x = (width + tile - 1) // tile
    grid_y = (height + tile - 1) // tile
    num_tiles = grid_x * grid_y
    nf = faces.shape[0]
    P2 = tile * tile

    R, t = w2v[:3, :3], w2v[:3, 3]
    pv = (verts[:, 0:1] * R[:, 0] + verts[:, 1:2] * R[:, 1]
          + verts[:, 2:3] * R[:, 2] + t)
    z = pv[:, 2]
    zs = torch.clamp(z, min=1e-6)
    u = pv[:, 0] / zs * intr[0] + intr[2]
    v = pv[:, 1] / zs * intr[1] + intr[3]
    tri_u, tri_v, tri_z = u[faces], v[faces], z[faces]      # [F,3]
    valid = (tri_z > 1e-4).all(dim=1)

    # the tiles each triangle's screen box touches, expanded to pairs
    tl = torch.tensor(float(tile), device=dev)
    rect = lambda x, hi, plus: torch.clamp(
        torch.floor(x / tl) + plus, 0, hi).to(torch.int64)
    rx0 = rect(tri_u.amin(1), grid_x, 0)
    ry0 = rect(tri_v.amin(1), grid_y, 0)
    rx1 = rect(tri_u.amax(1), grid_x, 1)
    ry1 = rect(tri_v.amax(1), grid_y, 1)
    touched = torch.where(valid, (rx1 - rx0) * (ry1 - ry0), 0)
    fid = torch.repeat_interleave(torch.arange(nf, device=dev), touched)
    first = torch.cumsum(touched, 0) - touched
    rank = torch.arange(len(fid), device=dev) - first[fid]
    rw = torch.clamp(rx1 - rx0, min=1)[fid]
    dy = rank // rw
    tile_id = (ry0[fid] + dy) * grid_x + rx0[fid] + rank - dy * rw

    # a miss keeps the key of z = inf and face id nf
    miss_key = (int(np.float32(np.inf).view(np.int32)) << 32) | nf
    best = torch.full((num_tiles * P2,), miss_key, dtype=torch.int64,
                      device=dev)
    for s in range(0, len(fid), _PAIRS_PER_STEP):
        sl = slice(s, s + _PAIRS_PER_STEP)
        _nearest_hits(tri_u, tri_v, tri_z, fid[sl], tile_id[sl], grid_x,
                      tile, best)
    bz = (best >> 32).to(torch.int32).view(torch.float32)
    bf = best & 0xFFFFFFFF

    def to_map(x):
        x = x.reshape(grid_y, grid_x, tile, tile)
        return x.permute(0, 2, 1, 3).reshape(grid_y * tile, grid_x * tile
                                             )[:height, :width]

    depth = to_map(bz)
    face = to_map(bf)
    miss = ~torch.isfinite(depth) | (face >= nf)
    depth = torch.where(miss, 0.0, depth)
    face_out = torch.where(miss, -1, face).to(torch.int32)

    # world position + face normal
    face_safe = torch.where(miss, 0, face)
    fverts = verts[faces[face_safe]]                         # [H,W,3,3]
    e1 = fverts[..., 1, :] - fverts[..., 0, :]
    e2 = fverts[..., 2, :] - fverts[..., 0, :]
    n = torch.linalg.cross(e1, e2)
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-24)
    c2w_rot = R.T
    cam_center = -(c2w_rot @ t)
    xs = (torch.arange(width, dtype=torch.float32, device=dev)
          - intr[2]) / intr[0]
    ys = (torch.arange(height, dtype=torch.float32, device=dev)
          - intr[3]) / intr[1]
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    dirs_cam = torch.stack([xx, yy, torch.ones_like(xx)], -1)
    dirs_w = dirs_cam @ c2w_rot.T
    position = cam_center + depth[..., None] * dirs_w
    return MeshRasterOut(
        depth=depth, face_id=face_out,
        position=torch.where(miss[..., None], 0.0, position),
        normal=torch.where(miss[..., None], 0.0, n))


def mesh_normal_prior(cam, verts: np.ndarray, faces: np.ndarray,
                      device=None):
    """Camera.get_mesh_normal parity (reference scene/cameras.py:107-125):
    per-pixel world-frame face normals [H,W,3] and their validity mask
    [H,W] (numpy), rasterized on `device` (None → CUDA)."""
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    intr = f32([cam.focal_x, cam.focal_y, cam.width / 2.0, cam.height / 2.0])
    out = rasterize_mesh(f32(verts), torch.as_tensor(
        np.asarray(faces, np.int32), device=dev), f32(cam.w2c), intr,
        int(cam.width), int(cam.height))
    normal = out.normal.cpu().numpy()
    norm = np.linalg.norm(normal, axis=-1, keepdims=True)
    mask = ~((norm[..., 0] > 1.1) | (norm[..., 0] < 0.9))
    return normal / np.maximum(norm, 1e-9), mask
