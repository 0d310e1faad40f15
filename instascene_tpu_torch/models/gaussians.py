"""Gaussian-surfel parameter state as a dataclass of tensors.

Port of instascene_tpu/models/gaussians.py:32-121 (`GaussianParams` with
its activations, `capacity`, `n_alive`, `one_up_sh_degree`, and
`create_from_pcd`) and :124-233 (`compact`, `save_ply`, `load_ply`), plus
`from_numpy`, which takes the JAX field names as numpy arrays so both
packages can be fed one state. Fixed capacity with an `alive` mask, as in
the JAX package: densification writes new gaussians into dead slots
(models/densify.py).

Parameterization: scaling stored as log (exp activation, two surfel axes),
opacity as logit (sigmoid), rotation as an unnormalized (w,x,y,z)
quaternion, SH features split dc [N,1,3] / rest [N,R,3], optional
seg_feature [N,E].

PLY attribute contract: x,y,z,nx,ny,nz,f_dc_0..2,f_rest_0..(3R-1),opacity,
scale_0..1,rot_0..3[,segfeat_0..E-1], all f4 — byte-compatible with the JAX
package's save_ply.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "alive", "seg_feature")


@dataclass
class GaussianModel:
    xyz: torch.Tensor            # [C,3]
    features_dc: torch.Tensor    # [C,1,3]
    features_rest: torch.Tensor  # [C,R,3]
    scaling: torch.Tensor        # [C,2] log-scale
    rotation: torch.Tensor       # [C,4] quaternion (w,x,y,z), unnormalized
    opacity: torch.Tensor        # [C,1] logit
    alive: torch.Tensor          # [C] bool — capacity slots in use
    seg_feature: Optional[torch.Tensor] = None  # [C,E]
    active_sh_degree: int = 0
    max_sh_degree: int = 3

    def scaling_activated(self):
        return torch.exp(self.scaling) * self.alive[:, None]

    def opacity_activated(self):
        return torch.sigmoid(self.opacity) * self.alive[:, None]

    def rotation_normalized(self):
        return self.rotation * torch.rsqrt(
            torch.sum(self.rotation * self.rotation, dim=-1, keepdim=True)
            + 1e-24)

    def features(self):
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def seg_feature_normed(self):
        if self.seg_feature is None:
            return None
        return self.seg_feature / (torch.linalg.norm(
            self.seg_feature, dim=1, keepdim=True) + 1e-6)

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def n_alive(self) -> int:
        return int(self.alive.sum())

    def one_up_sh_degree(self) -> "GaussianModel":
        if self.active_sh_degree < self.max_sh_degree:
            return self.replace(active_sh_degree=self.active_sh_degree + 1)
        return self

    def replace(self, **kw) -> "GaussianModel":
        return dataclasses.replace(self, **kw)

    def to_numpy(self) -> dict:
        """The state as numpy arrays under the JAX field names."""
        d = {k: (getattr(self, k).detach().cpu().numpy()
                 if getattr(self, k) is not None else None) for k in FIELDS}
        d["active_sh_degree"] = self.active_sh_degree
        d["max_sh_degree"] = self.max_sh_degree
        return d


def from_numpy(d: dict, device=None) -> GaussianModel:
    """GaussianModel from numpy arrays under the JAX GaussianParams field
    names (xyz, features_dc, features_rest, scaling, rotation, opacity,
    alive, seg_feature; ints active_sh_degree, max_sh_degree)."""
    dev = resolve_device(device)

    def t(name, dtype=torch.float32):
        a = d.get(name)
        if a is None:
            return None
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return GaussianModel(
        xyz=t("xyz"), features_dc=t("features_dc"),
        features_rest=t("features_rest"), scaling=t("scaling"),
        rotation=t("rotation"), opacity=t("opacity"),
        alive=t("alive", torch.bool), seg_feature=t("seg_feature"),
        active_sh_degree=int(d.get("active_sh_degree", 0)),
        max_sh_degree=int(d.get("max_sh_degree", 3)))


def create_from_pcd(points: np.ndarray, colors: np.ndarray, dist2: np.ndarray,
                    capacity: Optional[int] = None, max_sh_degree: int = 3,
                    seg_feat_dim: int = 0, seed: int = 0,
                    device=None) -> GaussianModel:
    """Initialize from an SfM point cloud (reference
    gaussian_model.py:181-204): colors → SH dc, both scales
    log(sqrt(mean 3-NN dist²)), random quaternions from numpy's
    default_rng(seed) (so the state equals the JAX package's for a seed),
    opacity logit(0.1), dead slots up to `capacity`."""
    from ..ops.sh import RGB2SH, num_sh_coeffs
    from ..utils.general import inverse_sigmoid
    n = points.shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} points")
    rng = np.random.default_rng(seed)
    R = num_sh_coeffs(max_sh_degree) - 1

    def pad(a):
        return np.concatenate(
            [a, np.zeros((cap - n,) + a.shape[1:], a.dtype)], axis=0)

    f_dc = RGB2SH(colors.astype(np.float32))[:, None, :]
    scales = np.log(np.sqrt(np.maximum(dist2, 1e-7)))[:, None].repeat(2, 1)
    rots = rng.random((n, 4)).astype(np.float32)
    opac = inverse_sigmoid(0.1 * np.ones((n, 1), np.float32))
    alive = np.zeros(cap, bool)
    alive[:n] = True
    seg = None
    if seg_feat_dim:
        seg = rng.random((n, seg_feat_dim)).astype(np.float32)
        seg = pad(seg / np.linalg.norm(seg, axis=1, keepdims=True))
    return from_numpy(dict(
        xyz=pad(points.astype(np.float32)),
        features_dc=pad(f_dc.astype(np.float32)),
        features_rest=np.zeros((cap, R, 3), np.float32),
        scaling=pad(scales.astype(np.float32)), rotation=pad(rots),
        opacity=pad(opac.astype(np.float32)), alive=alive, seg_feature=seg,
        active_sh_degree=0, max_sh_degree=max_sh_degree), device)


def compact(p: GaussianModel) -> GaussianModel:
    """Drop dead slots."""
    idx = torch.nonzero(p.alive).squeeze(1)
    take = lambda a: a[idx] if a is not None else None
    return GaussianModel(
        xyz=take(p.xyz), features_dc=take(p.features_dc),
        features_rest=take(p.features_rest), scaling=take(p.scaling),
        rotation=take(p.rotation), opacity=take(p.opacity),
        alive=torch.ones(len(idx), dtype=torch.bool, device=p.device),
        seg_feature=take(p.seg_feature),
        active_sh_degree=p.active_sh_degree, max_sh_degree=p.max_sh_degree)


def save_ply(p: GaussianModel, path: str,
             crop_mask: Optional[np.ndarray] = None) -> None:
    """Write the alive gaussians (optionally only `crop_mask` of them, over
    compacted order)."""
    from ..data.ply import write_ply
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pc = compact(p).to_numpy()
    n_all = len(pc["xyz"])
    keep = (np.asarray(crop_mask) if crop_mask is not None
            else np.ones(n_all, bool))

    xyz = pc["xyz"][keep]
    n = len(xyz)
    # channel index slow, coefficient fast (transpose(1, 2) then flatten)
    fd = pc["features_dc"][keep].transpose(0, 2, 1)
    f_dc = fd.reshape(n, fd.shape[1] * fd.shape[2])
    fr = pc["features_rest"][keep].transpose(0, 2, 1)
    f_rest = fr.reshape(n, fr.shape[1] * fr.shape[2])
    opac = pc["opacity"][keep]
    scale = pc["scaling"][keep]
    rot = pc["rotation"][keep]
    cols = [("x", xyz[:, 0]), ("y", xyz[:, 1]), ("z", xyz[:, 2]),
            ("nx", np.zeros(n)), ("ny", np.zeros(n)), ("nz", np.zeros(n))]
    cols += [(f"f_dc_{i}", f_dc[:, i]) for i in range(f_dc.shape[1])]
    cols += [(f"f_rest_{i}", f_rest[:, i]) for i in range(f_rest.shape[1])]
    cols.append(("opacity", opac[:, 0]))
    cols += [(f"scale_{i}", scale[:, i]) for i in range(scale.shape[1])]
    cols += [(f"rot_{i}", rot[:, i]) for i in range(rot.shape[1])]
    if pc["seg_feature"] is not None:
        seg = pc["seg_feature"][keep]
        cols += [(f"segfeat_{i}", seg[:, i]) for i in range(seg.shape[1])]
    arr = np.empty(n, dtype=[(name, "f4") for name, _ in cols])
    for name, v in cols:
        arr[name] = v.astype(np.float32)
    write_ply(path, arr)


def load_ply(path: str, max_sh_degree: int = 3, seg_feat_dim: int = 0,
             load_seg_feat: bool = False, device=None) -> GaussianModel:
    """The PLY's gaussians on `device` (active_sh_degree = max_sh_degree)."""
    from ..data.ply import read_ply
    v = read_ply(path)["vertex"]
    names = v.dtype.names
    n = len(v)
    xyz = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    opac = np.asarray(v["opacity"], np.float32)[:, None]
    f_dc = np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]],
                    -1).astype(np.float32)[:, None, :]
    rest_names = sorted([x for x in names if x.startswith("f_rest_")],
                        key=lambda s: int(s.split("_")[-1]))
    R = (max_sh_degree + 1) ** 2 - 1
    if len(rest_names) != 3 * R:
        raise ValueError(f"{path}: {len(rest_names)} f_rest_* attributes, "
                         f"SH degree {max_sh_degree} needs {3 * R}")
    f_rest = np.stack([v[x] for x in rest_names], -1).astype(np.float32)
    f_rest = f_rest.reshape(n, 3, R).transpose(0, 2, 1)  # channel-major on disk
    scale_names = sorted([x for x in names if x.startswith("scale_")],
                         key=lambda s: int(s.split("_")[-1]))[:2]
    scaling = np.stack([v[x] for x in scale_names], -1).astype(np.float32)
    rot_names = sorted([x for x in names if x.startswith("rot")],
                       key=lambda s: int(s.split("_")[-1]))
    rotation = np.stack([v[x] for x in rot_names], -1).astype(np.float32)
    seg = None
    if load_seg_feat and seg_feat_dim:
        seg_names = [x for x in names if x.startswith("segfeat")]
        if len(seg_names) == seg_feat_dim:
            seg = np.stack([v[f"segfeat_{i}"] for i in range(seg_feat_dim)],
                           -1).astype(np.float32)
    return from_numpy(dict(
        xyz=xyz, features_dc=f_dc, features_rest=f_rest, scaling=scaling,
        rotation=rotation, opacity=opac, alive=np.ones(n, bool),
        seg_feature=seg, active_sh_degree=max_sh_degree,
        max_sh_degree=max_sh_degree), device)
