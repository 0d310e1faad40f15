"""Scene readers: COLMAP and Blender (NeRF-synthetic), and the Scene that
assembles cameras, the initial point cloud and the output directory.

Port of instascene_tpu/data/dataset.py (`CameraInfo`, `BasicPointCloud`,
`SceneInfo`, `get_nerfpp_norm`, `read_colmap_scene` with the llffhold-8
eval split, `read_blender_scene`, and `Scene` with the same model_path
layout output/<parent>/<scene>/<model_path>, COLMAP first).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..cameras import (Camera, focal2fov, fov2focal, get_world2view,
                       load_camera)
from .colmap import (load_sparse_model, qvec2rotmat, read_points3D_binary,
                     read_points3D_text)
from .ply import read_point_cloud, write_point_cloud


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray
    T: np.ndarray
    FovY: float
    FovX: float
    image_path: str
    image_name: str
    width: int
    height: int


@dataclass
class BasicPointCloud:
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


@dataclass
class SceneInfo:
    point_cloud: BasicPointCloud
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    """Camera extent: 1.1 × the largest distance of a camera center from
    their mean."""
    centers = []
    for cam in cam_infos:
        w2v = get_world2view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2v)[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = np.linalg.norm(centers - avg, axis=0).max()
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def read_colmap_scene(path: str, images: Optional[str], eval_split: bool,
                      llffhold: int = 8) -> SceneInfo:
    """Cameras sorted by image name (every llffhold-th one held out when
    eval_split), their normalization, and the SfM points (points3D.ply,
    written from points3D.bin/.txt on first read)."""
    scene_dir = os.path.join(path, "sparse/0")
    if not os.path.exists(scene_dir):
        scene_dir = os.path.join(path, "sparse")
    cams, imgs = load_sparse_model(scene_dir)

    reading_dir = images if images else "images"
    cam_infos = []
    for key in imgs:
        extr = imgs[key]
        intr = cams[extr.camera_id]
        if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            focal_x = intr.params[0]
            fovy = focal2fov(focal_x, intr.height)
            fovx = focal2fov(focal_x, intr.width)
        elif intr.model in ("PINHOLE", "OPENCV"):
            fovy = focal2fov(intr.params[1], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        else:
            raise ValueError(f"unsupported COLMAP camera model: {intr.model}")
        image_path = os.path.join(path, reading_dir,
                                  os.path.basename(extr.name))
        cam_infos.append(CameraInfo(
            uid=intr.id, R=qvec2rotmat(extr.qvec).T, T=np.array(extr.tvec),
            FovY=fovy, FovX=fovx, image_path=image_path,
            image_name=os.path.basename(image_path).split(".")[0],
            width=intr.width, height=intr.height))
    cam_infos.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    ply_path = os.path.join(scene_dir, "points3D.ply")
    if not os.path.exists(ply_path):
        bin_path = os.path.join(scene_dir, "points3D.bin")
        if os.path.exists(bin_path):
            xyz, rgb, _ = read_points3D_binary(bin_path)
        else:
            xyz, rgb, _ = read_points3D_text(
                os.path.join(scene_dir, "points3D.txt"))
        write_point_cloud(ply_path, xyz, rgb)
    pts, colors, normals = read_point_cloud(ply_path)
    return SceneInfo(point_cloud=BasicPointCloud(pts, colors, normals),
                     train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path)


def read_blender_scene(path: str, white_background: bool, eval_split: bool,
                       extension: str = ".png") -> SceneInfo:
    """transforms_{train,test}.json (reference dataset_readers.py:193-271):
    OpenGL camera-to-world matrices turned to COLMAP axes, each image's
    size from its file, FovY from camera_angle_x. Without eval_split the
    test frames join the training ones. Without points3d.ply, 100,000
    random points in [-1.3, 1.3]³ (numpy default_rng(0)) are written
    there first. As in the JAX package, white_background is not applied
    here and RGBA images keep their alpha band (load_camera)."""
    from ..utils.image import image_size

    def read_transforms(fname):
        cam_infos = []
        with open(os.path.join(path, fname)) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        for idx, frame in enumerate(contents["frames"]):
            image_path = os.path.join(path, frame["file_path"] + extension)
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # OpenGL → COLMAP axes
            w2c = np.linalg.inv(c2w)
            w, h = image_size(image_path)
            cam_infos.append(CameraInfo(
                uid=idx, R=np.transpose(w2c[:3, :3]), T=w2c[:3, 3],
                FovY=focal2fov(fov2focal(fovx, w), h), FovX=fovx,
                image_path=image_path, image_name=Path(image_path).stem,
                width=w, height=h))
        return cam_infos

    train = read_transforms("transforms_train.json")
    test = (read_transforms("transforms_test.json")
            if os.path.exists(os.path.join(path, "transforms_test.json"))
            else [])
    if not eval_split:
        train, test = train + test, []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        rng = np.random.default_rng(0)
        xyz = rng.random((100_000, 3)) * 2.6 - 1.3
        write_point_cloud(ply_path, xyz, rng.random((100_000, 3)))
    pts, colors, normals = read_point_cloud(ply_path)
    return SceneInfo(point_cloud=BasicPointCloud(pts, colors, normals),
                     train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path)


class Scene:
    """Cameras + initial point cloud + model output dir for a COLMAP or a
    Blender scene (the model_path layout
    output/<parent>/<scene>/<model_path>)."""

    def __init__(self, args, load_images: bool = True,
                 resolution_scales=(1.0,), output_root: str = "output"):
        sp = args.source_path.rstrip("/")
        parts = sp.split("/")
        self.model_path = os.path.join(output_root, parts[-2] if len(parts) > 1
                                       else "scene", parts[-1], args.model_path)
        if os.path.exists(os.path.join(sp, "sparse")):
            self.scene_info = read_colmap_scene(sp, args.images, args.eval)
        elif os.path.exists(os.path.join(sp, "transforms_train.json")):
            self.scene_info = read_blender_scene(sp, args.white_background,
                                                 args.eval)
        else:
            raise ValueError(f"Could not recognize scene type at {sp}")

        self.cameras_extent = self.scene_info.nerf_normalization["radius"]
        self.train_cameras = {}
        self.test_cameras = {}
        for scale in resolution_scales:
            self.train_cameras[scale] = [
                load_camera(args, i, c, scale, load_images)
                for i, c in enumerate(self.scene_info.train_cameras)]
            self.test_cameras[scale] = [
                load_camera(args, i, c, scale, load_images)
                for i, c in enumerate(self.scene_info.test_cameras)]

    def get_train_cameras(self, scale=1.0) -> List[Camera]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale=1.0) -> List[Camera]:
        return self.test_cameras.get(scale, [])

    def iteration_dir(self, iteration: int) -> str:
        return os.path.join(self.model_path,
                            f"point_cloud/iteration_{iteration}")
