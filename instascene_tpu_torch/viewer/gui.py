"""Headless click-to-segment engine.

Port of instascene_tpu/viewer/gui.py:21-264 (`OrbitCamera`,
`SegmentationEngine`, `compose_frame`) for the headless path: orbit, click,
segment, save. The dearpygui shell waits for a later slice, and with it
the engine's window-only actions (load another PLY, clear prompts,
single-prompt clicks, delete, convex-hull crop) and the camera's pan and
zoom.

The JAX engine filters the selected gaussians with sklearn's DBSCAN; this
port uses its own (semantic/cluster.py::dbscan, on scipy, with sklearn's
semantics), since the GPU machine has no sklearn.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..cameras import MiniCam, get_projection_matrix
from ..models import gaussians as gmod
from ..semantic.cluster import dbscan
from ..semantic.export import pca_proj_matrix


class OrbitCamera:
    """Orbit camera around a center point."""

    def __init__(self, width, height, r=2.0, fovy=60.0):
        self.W = width
        self.H = height
        self.radius = r
        self.fovy = np.deg2rad(fovy)
        self.center = np.zeros(3, dtype=np.float32)
        from scipy.spatial.transform import Rotation
        self.rot = Rotation.from_matrix(np.eye(3))

    @property
    def fovx(self):
        return 2 * np.arctan(np.tan(self.fovy / 2) * self.W / self.H)

    @property
    def pose(self):
        """c2w, COLMAP convention (z forward): camera at center − R·(0,0,r),
        looking at the orbit center."""
        res = np.eye(4, dtype=np.float32)
        res[:3, :3] = self.rot.as_matrix()
        res[:3, 3] = self.center - res[:3, :3] @ np.array(
            [0, 0, self.radius], dtype=np.float32)
        return res

    def orbit(self, dx, dy):
        from scipy.spatial.transform import Rotation
        side = self.rot.as_matrix()[:3, 0]
        up = self.rot.as_matrix()[:3, 1]
        rotvec_x = up * np.radians(-0.05 * dx)
        rotvec_y = side * np.radians(-0.05 * dy)
        self.rot = (Rotation.from_rotvec(rotvec_x)
                    * Rotation.from_rotvec(rotvec_y) * self.rot)

    def minicam(self, znear=0.01, zfar=100.0) -> MiniCam:
        c2w = self.pose
        w2v = np.linalg.inv(c2w).astype(np.float32)
        proj = get_projection_matrix(znear, zfar, self.fovx, self.fovy)
        return MiniCam(self.W, self.H, self.fovy, self.fovx, znear, zfar,
                       w2v=w2v, full_proj=(proj @ w2v).astype(np.float32))


@dataclass
class SegmentationEngine:
    """Headless click-to-segment engine on one device (the params')."""
    params: gmod.GaussianModel
    pipe: object
    bg_color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    score_threshold: float = 0.7
    dbscan_eps: float = 0.15
    dbscan_min_points: int = 10

    def __post_init__(self):
        self.proj_mat = pca_proj_matrix(
            self.params.seg_feature.detach().cpu().numpy())
        self.chosen_features: List[np.ndarray] = []
        self.prompt_colors: List[np.ndarray] = []
        self._frame_key = None
        self._frame = None
        self._params_version = 0
        self._initial_params = self.params
        self._color_rng = np.random.default_rng(0)

    def reload(self) -> None:
        """Restore the model loaded at startup."""
        self.params = self._initial_params
        self._params_version += 1

    @torch.no_grad()
    def render_view(self, cam, need_aux: bool = False):
        """rgb + feature maps for `cam` (numpy), plus depth/normal/alpha
        maps when `need_aux` (full blend instead of the viewer fast path).
        Re-renders only when the pose, the gaussian set or the aux
        requirement changed."""
        key = (np.asarray(cam.w2v, np.float32).tobytes(),
               self._params_version, bool(need_aux))
        if self._frame_key == key:
            return self._frame
        from ..render import render
        pkg = render(cam, self.params, self.pipe, self.bg_color,
                     viewer=not need_aux)
        feat = pkg["seg_feature"]
        feat = feat / (torch.linalg.norm(feat, dim=-1, keepdim=True) + 1e-6)
        proj = torch.as_tensor(self.proj_mat, device=feat.device)
        feat_rgb = torch.clamp(feat @ proj * 0.5 + 0.5, 0, 1)
        frame = {"rgb": pkg["render"].cpu().numpy(),
                 "feat": feat.cpu().numpy(),
                 "feat_rgb": feat_rgb.cpu().numpy()}
        if need_aux:
            frame["depth"] = pkg["surf_depth"][..., 0].cpu().numpy()
            frame["normal"] = pkg["rend_normal"].cpu().numpy()
            frame["alpha"] = pkg["rend_alpha"][..., 0].cpu().numpy()
        self._frame_key, self._frame = key, frame
        return frame

    def click(self, cam, x: int, y: int) -> None:
        """Add a feature prompt at pixel (x, y)."""
        feat = self.render_view(cam)["feat"]
        h, w = feat.shape[:2]
        self.chosen_features.append(feat[int(y) % h, int(x) % w])
        self.prompt_colors.append(
            self._color_rng.random(3).astype(np.float32) * 0.7 + 0.3)

    def score_map(self, feat: np.ndarray) -> np.ndarray:
        """[H,W,P] scores in [0,1] per prompt."""
        prompts = np.stack(self.chosen_features, axis=-1)
        return (feat @ prompts + 1.0) / 2.0

    def gaussian_mask(self) -> np.ndarray:
        """3D mask: gaussians whose feature matches any prompt, filtered to
        the largest DBSCAN group (noise counts as a group, as in the JAX
        engine)."""
        feats = self.params.seg_feature_normed().detach().cpu().numpy()
        prompts = np.stack(self.chosen_features, axis=-1)
        score = (feats @ prompts + 1.0) / 2.0
        mask = (score > self.score_threshold).sum(axis=1) > 0
        mask = mask & self.params.alive.cpu().numpy()
        if mask.sum() == 0:
            return mask
        pts = self.params.xyz.detach().cpu().numpy()[mask]
        labels = dbscan(pts, self.dbscan_eps, self.dbscan_min_points) + 1
        ids, cnts = np.unique(labels, return_counts=True)
        best = ids[np.argmax(cnts)]
        keep_idx = np.nonzero(mask)[0][labels == best]
        out = np.zeros_like(mask)
        out[keep_idx] = True
        return out

    def segment_3d(self, save_dir: str, seg_id: int = 0):
        """Crop to the selected instance and save its PLY + mask."""
        mask = self.gaussian_mask()
        alive = self.params.alive.cpu().numpy()
        os.makedirs(save_dir, exist_ok=True)
        gmod.save_ply(self.params, os.path.join(save_dir,
                                                f"segment_{seg_id}.ply"),
                      crop_mask=mask[alive])
        np.save(os.path.join(save_dir, f"segment_{seg_id}_mask.npy"), mask)
        self.params = self.params.replace(
            alive=self.params.alive & torch.as_tensor(
                mask, device=self.params.device))
        self._params_version += 1
        return mask


def compose_frame(engine: SegmentationEngine, frame: dict, mode: str
                  ) -> np.ndarray:
    """Display buffer for one render mode; in rgb mode each prompt's
    thresholded region is tinted with that prompt's color."""
    if mode == "rgb":
        rgb = frame["rgb"]
        if engine.chosen_features:
            score = engine.score_map(frame["feat"])
            binary = score > engine.score_threshold
            out = rgb.copy()
            for k, color in enumerate(engine.prompt_colors):
                m = binary[..., k]
                out[m] = rgb[m] * 0.3 + color * 0.7
            return np.clip(out, 0, 1)
        return np.clip(rgb, 0, 1)
    if mode == "feature":
        return np.clip(frame["feat_rgb"] * 0.7 + 0.3, 0, 1)
    if mode == "depth":
        d = frame["depth"]
        dmax = float(d.max())
        g = d / dmax if dmax > 0 else d
        return np.repeat(g[..., None], 3, axis=-1).astype(np.float32)
    if mode == "normal":
        return np.clip(frame["normal"] * 0.5 + 0.5, 0, 1)
    if mode == "alpha":
        return np.repeat(np.clip(frame["alpha"], 0, 1)[..., None], 3,
                         axis=-1).astype(np.float32)
    raise ValueError(mode)
