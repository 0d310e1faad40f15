"""GaussianExtractor: render the train views and fuse them into a mesh.

Port of instascene_tpu/mesh/extractor.py (reconstruction, the bounding
sphere, the bounded TSDF extraction, the contracted unbounded extraction,
`post_process_mesh`, `write_mesh_ply`). The views render through the port's
render() in `full` mode (K1 on the card); the depth and color maps stay on
the device through the fusion and the marching; only the meshes come back
to the host, where `post_process_mesh` (scipy) and `write_mesh_ply` (numpy)
are the JAX package's code.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..render import render
from ..viewer.render_paths import focus_point_fn
from .marching import marching_tetrahedra
from .tsdf import add_seconds, integrate_slab, sync_clock, tsdf_fusion_mesh


def post_process_mesh(verts: np.ndarray, faces: np.ndarray,
                      colors: Optional[np.ndarray] = None,
                      cluster_to_keep: int = 1000):
    """Keep the face clusters at least as large as the `cluster_to_keep`-th
    largest (connected components of the vertex-sharing graph)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    if len(faces) == 0:
        return verts, faces, colors
    n_v = len(verts)
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n_v, n_v))
    _, labels = connected_components(adj, directed=False)
    face_label = labels[faces[:, 0]]
    sizes = np.bincount(face_label)
    cluster_sizes = np.sort(sizes[sizes > 0])[::-1]
    thr = (cluster_sizes[cluster_to_keep - 1]
           if len(cluster_sizes) >= cluster_to_keep else 0)
    keep = sizes[face_label] >= thr
    faces2 = faces[keep] if keep.any() else faces
    used = np.unique(faces2)
    remap = -np.ones(n_v, np.int64)
    remap[used] = np.arange(len(used))
    return (verts[used], remap[faces2].astype(np.int32),
            colors[used] if colors is not None else None)


def _uncontract(y: torch.Tensor) -> torch.Tensor:
    """The inverse of the mip-NeRF-360 contraction, in y's dtype (|y| as
    numpy's norm sums it: x0² + x1², then + x2²)."""
    mag = torch.sqrt(y[:, 0] * y[:, 0] + y[:, 1] * y[:, 1]
                     + y[:, 2] * y[:, 2])[:, None]
    return torch.where(mag < 1, y, (1 / torch.clamp(2 - mag, min=1e-6))
                       * (y / torch.clamp(mag, min=1e-12)))


class GaussianExtractor:
    """Renders rgb + surf_depth per view, then extracts a TSDF mesh.

    gaussians: a models.gaussians.GaussianModel. The maps, the fusion and
    the marching run on `device` (None → the gaussians' device)."""

    def __init__(self, gaussians, pipe, bg_color=(0.0, 0.0, 0.0),
                 device=None):
        self.gaussians = gaussians
        self.pipe = pipe
        self.bg = np.asarray(bg_color, np.float32)
        self.device = (gaussians.device if device is None
                       else resolve_device(device))
        self.clean()

    def clean(self):
        self.rgbmaps: List[torch.Tensor] = []
        self.depthmaps: List[torch.Tensor] = []
        self.viewpoint_stack = []

    def reconstruction(self, viewpoint_stack):
        self.clean()
        self.viewpoint_stack = viewpoint_stack
        for cam in viewpoint_stack:
            with torch.no_grad():
                pkg = render(cam, self.gaussians, self.pipe, self.bg)
            self.rgbmaps.append(pkg["render"].to(self.device))
            d = pkg["surf_depth"][..., 0].to(self.device)
            if cam.gt_alpha_mask is not None:
                mask = torch.as_tensor(
                    np.asarray(cam.gt_alpha_mask)[..., 0] < 0.5,
                    device=self.device)
                d = torch.where(mask, 0.0, d)
            self.depthmaps.append(d)
        self.estimate_bounding_sphere()

    def estimate_bounding_sphere(self):
        c2ws = np.array([c.c2w for c in self.viewpoint_stack])
        poses = c2ws[:, :3, :] @ np.diag([1, -1, -1, 1])
        center = focus_point_fn(poses)
        self.radius = np.linalg.norm(c2ws[:, :3, 3] - center, axis=-1).min()
        self.center = center

    def _intrinsics(self):
        return [np.array([c.focal_x, c.focal_y, c.width / 2.0,
                          c.height / 2.0], np.float32)
                for c in self.viewpoint_stack]

    def extract_mesh_bounded(self, voxel_size: float = 0.004,
                             sdf_trunc: float = 0.02,
                             depth_trunc: float = 3.0, **kw):
        w2cs = [c.w2c for c in self.viewpoint_stack]
        return tsdf_fusion_mesh(self.depthmaps, self.rgbmaps, w2cs,
                                self._intrinsics(), voxel_size=voxel_size,
                                sdf_trunc=sdf_trunc, depth_trunc=depth_trunc,
                                **kw)

    def extract_mesh_unbounded(self, resolution: int = 512,
                               stats: Optional[dict] = None):
        """Contracted-space TSDF for unbounded scenes: fuse in the
        mip-NeRF-360 contraction around the bounding-sphere center, then
        un-contract the extracted vertices. stats: as tsdf_fusion_mesh's
        (the grid and voxel of the contracted space)."""
        dev = self.device
        t0 = sync_clock(dev) if stats is not None else 0.0
        h, w = self.depthmaps[0].shape[:2]
        w2cs = torch.as_tensor(np.stack([c.w2c for c in self.viewpoint_stack]
                                        ).astype(np.float32), device=dev)
        intr = torch.as_tensor(np.stack(self._intrinsics()), device=dev)
        depth_t = torch.stack(self.depthmaps).to(torch.float32)
        rgb_t = torch.stack(self.rgbmaps).to(torch.float32)
        # the JAX package's numpy promotes float32 · radius (a numpy
        # float64) + center to float64
        f64 = dict(dtype=torch.float64, device=dev)
        radius = torch.tensor(self.radius, **f64)
        center = torch.tensor(self.center, **f64)

        n = resolution
        grid_1d = np.linspace(-2 + 2 / n, 2 - 2 / n, n, dtype=np.float32)
        g1 = torch.as_tensor(grid_1d, device=dev)
        voxel = 4.0 / n
        if stats is not None:
            stats.update(grid=(n, n, n), voxel=voxel)
        sdf_trunc = 5 * voxel * self.radius
        verts_all, faces_all = [], []
        n_verts = 0
        slab = max(2, min(n, 2_000_000 // (n * n)))
        x0 = 0
        while x0 < n - 1:
            x1 = min(x0 + slab, n)
            y = torch.stack(torch.meshgrid(g1[x0:x1], g1, g1, indexing="ij"),
                            dim=-1).reshape(-1, 3)
            world = _uncontract(y).to(torch.float64) * radius + center
            tsdf, weight, _ = integrate_slab(
                world.to(torch.float32), w2cs, intr, depth_t, rgb_t,
                float(6.0 * self.radius), float(sdf_trunc), h, w)
            field = torch.where(weight > 0, tsdf, 1.0).reshape(x1 - x0, n, n)
            t0 = add_seconds(stats, "fusion", t0, dev)
            v, f = marching_tetrahedra(
                field.to(torch.float64), 0.0,
                origin=(grid_1d[x0], grid_1d[0], grid_1d[0]), spacing=voxel)
            t0 = add_seconds(stats, "marching", t0, dev)
            if len(v):
                v = _uncontract(v).to(torch.float64) * radius + center
                verts_all.append(v.cpu().numpy())
                faces_all.append(f.cpu().numpy() + n_verts)
                n_verts += len(v)
            t0 = add_seconds(stats, "fusion", t0, dev)
            x0 = x1 - 1
        if not verts_all:
            return (np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.int32), None)
        return np.concatenate(verts_all), np.concatenate(faces_all), None


def write_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray,
                   colors: Optional[np.ndarray] = None) -> None:
    """Binary PLY mesh writer (vertex + face elements)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n_v, n_f = len(verts), len(faces)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n_v}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {n_f}",
               "property list uchar int vertex_indices", "end_header\n"]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        if colors is not None:
            c8 = np.clip(colors * 255, 0, 255).astype(np.uint8)
            rec = np.empty(n_v, dtype=[("x", "<f4"), ("y", "<f4"),
                                       ("z", "<f4"), ("r", "u1"),
                                       ("g", "u1"), ("b", "u1")])
            rec["x"], rec["y"], rec["z"] = verts.T.astype(np.float32)
            rec["r"], rec["g"], rec["b"] = c8.T
        else:
            rec = np.empty(n_v, dtype=[("x", "<f4"), ("y", "<f4"),
                                       ("z", "<f4")])
            rec["x"], rec["y"], rec["z"] = verts.T.astype(np.float32)
        f.write(rec.tobytes())
        frec = np.empty(n_f, dtype=[("n", "u1"), ("a", "<i4"), ("b", "<i4"),
                                    ("c", "<i4")])
        frec["n"] = 3
        frec["a"], frec["b"], frec["c"] = faces.T.astype(np.int32)
        f.write(frec.tobytes())
