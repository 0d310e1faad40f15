"""Camera model, matrix conventions and camera loading (numpy).

Port of instascene_tpu/cameras.py:26-253 (`fov2focal`, `focal2fov`,
`get_world2view`, `get_projection_matrix`, `Camera` with its image,
alpha mask and mono-normal prior, `MiniCam`, `load_camera` with the
reference's -r rules, `_load_normal_prior`). Segmentation maps load with
the semantic trainer of a later slice.

All matrices are row-major maps acting on column vectors:

    p_view_h = w2v @ p_world_h
    p_clip   = proj @ p_view_h,   full_proj = proj @ w2v
    x_pix = ((x_ndc + 1) * W - 1) / 2
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def get_world2view(R: np.ndarray, t: np.ndarray,
                   translate=np.array([0.0, 0.0, 0.0]), scale=1.0) -> np.ndarray:
    """World→view 4x4. R is the c2w rotation (COLMAP-reader convention), t
    the w2c translation."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
    return np.linalg.inv(c2w).astype(np.float32)


def get_projection_matrix(znear: float, zfar: float, fovx: float,
                          fovy: float) -> np.ndarray:
    """Perspective view→clip matrix with w = z_view."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclass
class Camera:
    """A calibrated camera; arrays are host numpy, images channels-last
    [H, W, C] float32 in [0, 1]."""
    uid: int
    colmap_id: int
    R: np.ndarray            # c2w rotation (COLMAP-reader convention)
    T: np.ndarray            # w2c translation
    fovx: float
    fovy: float
    image_name: str
    width: int
    height: int
    image: Optional[np.ndarray] = None           # [H,W,3] f32
    gt_alpha_mask: Optional[np.ndarray] = None   # [H,W,1] f32
    normal: Optional[np.ndarray] = None          # [H,W,3] f32, world, unit
    normal_mask: Optional[np.ndarray] = None     # [H,W] bool
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    def __post_init__(self):
        if self.image is not None:
            self.image = np.clip(self.image, 0.0, 1.0)
            self.height, self.width = self.image.shape[:2]
        if self.normal is not None:
            # unit normals, and a mask of the pixels whose prior was a unit
            # vector to begin with (reference scene/cameras.py:49-56)
            norm = np.linalg.norm(self.normal, axis=-1, keepdims=True)
            self.normal_mask = ~((norm[..., 0] > 1.1) | (norm[..., 0] < 0.9))
            self.normal = self.normal / np.maximum(norm, 1e-12)
        self.w2v = get_world2view(self.R, self.T, self.trans, self.scale)
        self.proj = get_projection_matrix(self.znear, self.zfar, self.fovx,
                                          self.fovy)
        self.full_proj = (self.proj @ self.w2v).astype(np.float32)
        self.camera_center = np.linalg.inv(self.w2v)[:3, 3].astype(np.float32)

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy * 0.5)

    @property
    def focal_x(self) -> float:
        return self.width / (2 * self.tanfovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2 * self.tanfovy)

    @property
    def w2c(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.R.T
        m[:3, 3] = self.T
        return m

    @property
    def c2w(self) -> np.ndarray:
        return np.linalg.inv(self.w2c)


@dataclass
class MiniCam:
    """Camera defined directly by matrices (viewer path)."""
    width: int
    height: int
    fovy: float
    fovx: float
    znear: float
    zfar: float
    w2v: np.ndarray
    full_proj: np.ndarray

    def __post_init__(self):
        self.camera_center = np.linalg.inv(self.w2v)[:3, 3].astype(np.float32)

    @property
    def c2w(self) -> np.ndarray:
        return np.linalg.inv(self.w2v)

    tanfovx = Camera.tanfovx
    tanfovy = Camera.tanfovy


def load_camera(args, uid: int, cam_info, resolution_scale: float = 1.0,
                load_images: bool = True) -> Camera:
    """A Camera from a CameraInfo with the reference's resolution rules
    (utils/camera_utils.py:25-102): -r -1 caps the width at 1600, 1/2/4/8
    divide, any other value is a target width. A fourth image band is the
    alpha mask; with load_images and args.w_normal_prior the mono-normal
    prior loads too."""
    from .utils.image import load_image, read_image

    raw = read_image(cam_info.image_path)
    orig_h, orig_w = raw.shape[:2]
    if args.resolution in (1, 2, 4, 8):
        resolution = (round(orig_w / (resolution_scale * args.resolution)),
                      round(orig_h / (resolution_scale * args.resolution)))
    else:
        if args.resolution == -1:
            global_down = orig_w / 1600 if orig_w > 1600 else 1
        else:
            global_down = orig_w / args.resolution
        s = float(global_down) * float(resolution_scale)
        resolution = (int(orig_w / s), int(orig_h / s))

    img = load_image(cam_info.image_path, resolution)
    alpha = None
    if img.shape[2] == 4:
        rgb, alpha = img[..., :3], img[..., 3:4]
    elif img.shape[2] == 3:
        rgb = img
    else:            # gray (+ alpha, which PIL's convert("RGB") drops)
        rgb = np.repeat(img[..., :1], 3, axis=2)

    normal = None
    if load_images and getattr(args, "w_normal_prior", None):
        normal = _load_normal_prior(args, cam_info, resolution)
    return Camera(uid=uid, colmap_id=cam_info.uid, R=cam_info.R, T=cam_info.T,
                  fovx=cam_info.FovX, fovy=cam_info.FovY,
                  image_name=cam_info.image_name,
                  width=resolution[0], height=resolution[1],
                  image=rgb, gt_alpha_mask=alpha, normal=normal)


def _load_normal_prior(args, cam_info, resolution):
    """The mono-normal prior <scene>/<w_normal_prior>/<image>.npy (or .png)
    in [0, 1], flipped to the camera-out convention and rotated to the
    world frame (utils/camera_utils.py:63-78); None when absent. An .npy
    of another size is resized bicubically (a = -0.75, as OpenCV's
    INTER_CUBIC)."""
    from .utils.image import load_image

    normal_path = os.path.join(
        os.path.dirname(os.path.dirname(cam_info.image_path)),
        args.w_normal_prior, os.path.basename(cam_info.image_path))
    base = normal_path[:-4]
    if os.path.exists(base + ".npy"):
        n = np.load(base + ".npy")  # [H,W,3] or [3,H,W] in [0,1]
        if n.shape[0] == 3 and n.ndim == 3:
            n = n.transpose(1, 2, 0)
        n = -(n * 2 - 1)
        if (n.shape[1], n.shape[0]) != tuple(resolution):
            import torch
            t = torch.as_tensor(n.astype(np.float32)).permute(2, 0, 1)[None]
            n = torch.nn.functional.interpolate(
                t, size=(resolution[1], resolution[0]), mode="bicubic",
                align_corners=False)[0].permute(1, 2, 0).numpy()
    elif os.path.exists(base + ".png"):
        n = -(load_image(base + ".png", resolution)[..., :3] * 2 - 1)
    else:
        return None
    # camera → world: n_world = n_cam @ inv(R) (camera_utils.py:77)
    n = n @ np.linalg.inv(cam_info.R).astype(np.float32)
    return n.astype(np.float32)
