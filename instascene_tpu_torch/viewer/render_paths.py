"""Novel-view camera paths (numpy) and video export.

Port of instascene_tpu/viewer/render_paths.py (`pad_poses`, `unpad_poses`,
`view_matrix`, `focus_point_fn`, `transform_poses_pca`,
`generate_ellipse_path`, `path_to_minicams`, `render_video`): the same
numpy arithmetic, so the results equal the JAX package's. The mesh
extractor's bounding sphere uses `focus_point_fn`. `render_video` writes
through imageio, imported where it is called, as in the JAX package;
`video_frame` is its per-frame work.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..cameras import MiniCam, get_projection_matrix


def pad_poses(p: np.ndarray) -> np.ndarray:
    """[...,3,4] -> [...,4,4] by appending the affine bottom row."""
    bottom = np.zeros(p.shape[:-2] + (1, 4), p.dtype)
    bottom[..., 0, 3] = 1.0
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p: np.ndarray) -> np.ndarray:
    return p[..., :3, :4]


def view_matrix(lookdir, up, position) -> np.ndarray:
    """Batched OpenGL-style camera-to-world frames [...,3,4] from look
    directions, a shared up hint, and positions (all [...,3])."""
    lookdir = np.asarray(lookdir, np.float64)
    position = np.asarray(position, np.float64)
    up = np.broadcast_to(np.asarray(up, np.float64), lookdir.shape)
    unit = lambda v: v / np.maximum(
        np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    z = unit(lookdir)
    x = unit(np.cross(up, z))
    y = np.cross(z, x)  # already unit: z and x are orthonormal
    return np.stack([x, y, z, position], axis=-1)


def focus_point_fn(poses: np.ndarray) -> np.ndarray:
    """Point minimizing summed squared distance to all camera optical axes:
    with the perpendicular projectors P_i = I - d_i d_iT (symmetric
    idempotent) the normal equations are (sum P_i) p = sum P_i o_i."""
    d = poses[:, :3, 2]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = poses[:, :3, 3]
    proj = np.eye(3)[None] - d[:, :, None] * d[:, None, :]
    lhs = proj.sum(0)
    rhs = np.einsum("nij,nj->i", proj, o)
    return np.linalg.lstsq(lhs, rhs, rcond=None)[0]


def transform_poses_pca(poses: np.ndarray):
    """Recenter c2w poses [N,3,4] so the camera cloud's principal axes align
    with the world axes and positions fit in the unit cube.

    Returns (poses_recentered [N,3,4], transform [4,4]) with
    poses_recentered = (transform @ pad(poses))[:3]; the average camera up
    ends with a positive world-z component."""
    t = poses[:, :3, 3]
    centroid = t.mean(axis=0)
    # rows of vt are the principal axes in decreasing-variance order: the
    # world-from-old rotation
    _, _, vt = np.linalg.svd(t - centroid, full_matrices=False)
    if np.linalg.det(vt) < 0:
        vt = vt * np.array([[1.0], [1.0], [-1.0]])
    transform = np.eye(4)
    transform[:3, :3] = vt
    transform[:3, 3] = -vt @ centroid
    recentered = unpad_poses(transform @ pad_poses(poses))
    scale = 1.0 / max(np.abs(recentered[:, :3, 3]).max(), 1e-12)
    scale_mat = np.diag([scale, scale, scale, 1.0])
    transform = scale_mat @ transform
    recentered = unpad_poses(scale_mat @ pad_poses(recentered))
    if recentered[:, :3, 1].mean(axis=0)[2] < 0:
        flip = np.diag([1.0, -1.0, -1.0, 1.0])
        transform = flip @ transform
        recentered = unpad_poses(flip @ pad_poses(recentered))
    return recentered, transform[:4]


def generate_ellipse_path(poses: np.ndarray, n_frames: int = 120,
                          z_variation: float = 0.0, z_phase: float = 0.0
                          ) -> np.ndarray:
    """Elliptical fly-around of the scene focus point. poses: [N,3,4] c2w
    (recentered frame). Returns [n_frames,3,4] c2w frames, all looking at
    the focus point: xy semi-axes the 90th-percentile spread of the camera
    positions about it, the height oscillating inside the cameras' 10th-90th
    percentile z band scaled by `z_variation`."""
    center = focus_point_fn(poses)
    pos = poses[:, :3, 3]
    semi = np.percentile(np.abs(pos[:, :2] - center[:2]), 90, axis=0)
    z_lo, z_hi = np.percentile(pos[:, 2], [10, 90])

    theta = np.linspace(0.0, 2.0 * np.pi, n_frames, endpoint=False)
    orbit = np.stack([
        center[0] + semi[0] * np.cos(theta),
        center[1] + semi[1] * np.sin(theta),
        z_variation * (0.5 * (z_lo + z_hi) + 0.5 * (z_hi - z_lo)
                       * np.cos(theta + 2 * np.pi * z_phase)),
    ], axis=-1)

    # shared up vector: the dominant world axis of the mean camera up
    mean_up = poses[:, :3, 1].mean(axis=0)
    axis = np.argmax(np.abs(mean_up))
    up = np.zeros(3)
    up[axis] = np.sign(mean_up[axis])
    return view_matrix(orbit - center, up, orbit)


def path_to_minicams(path_c2w: np.ndarray, width: int, height: int,
                     fovx: float, fovy: float) -> List[MiniCam]:
    cams = []
    proj = get_projection_matrix(0.01, 100.0, fovx, fovy)
    for c2w34 in path_c2w:
        c2w = pad_poses(c2w34[None])[0]
        w2v = np.linalg.inv(c2w).astype(np.float32)
        cams.append(MiniCam(width, height, fovy, fovx, 0.01, 100.0, w2v=w2v,
                            full_proj=(proj @ w2v).astype(np.float32)))
    return cams


def video_frame(gaussians, pipe, cam, bg=(0, 0, 0),
                mode: str = "render") -> np.ndarray:
    """One frame of render_video: render() of `cam` as uint8 [H,W,3] —
    the colour, the surface depth over its maximum, or the normal map."""
    import torch
    from ..render import render
    with torch.no_grad():
        pkg = render(cam, gaussians, pipe, torch.as_tensor(
            np.asarray(bg, np.float32), device=gaussians.device))
    if mode == "render":
        frame = pkg["render"].cpu().numpy()
    elif mode == "depth":
        d = pkg["surf_depth"].cpu().numpy()[..., 0]
        frame = np.repeat((d / max(d.max(), 1e-6))[..., None], 3, -1)
    elif mode == "normal":
        frame = pkg["rend_normal"].cpu().numpy() * 0.5 + 0.5
    else:
        raise ValueError(mode)
    return (np.clip(frame, 0, 1) * 255).astype(np.uint8)


def render_video(gaussians, pipe, cams: List[MiniCam], out_path: str,
                 bg=(0, 0, 0), fps: int = 30, mode: str = "render") -> str:
    """Render a camera path to a video through imageio (the reference's
    create_videos): an mp4, or a GIF beside it where imageio has no ffmpeg
    plugin. Returns the path written."""
    import imageio
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    try:
        writer = imageio.get_writer(out_path, fps=fps)
    except (ValueError, ImportError):
        out_path = os.path.splitext(out_path)[0] + ".gif"
        writer = imageio.get_writer(out_path, duration=1000.0 / fps)
    for cam in cams:
        writer.append_data(video_frame(gaussians, pipe, cam, bg, mode))
    writer.close()
    return out_path
