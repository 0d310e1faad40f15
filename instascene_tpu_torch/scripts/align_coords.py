"""Rigidly rotate a reconstructed scene: COLMAP poses and points, and/or a
trained gaussian PLY (xyz, quaternions, SH coefficients).

    python -m instascene_tpu_torch.scripts.align_coords --scene_dir <scene>
        [--degrees rx,ry,rz] [--rotate_colmap] [--ply <model.ply>]

Port of scripts/align_coords.py (`rotate_colmap`, `rotate_gaussians`,
`main`), through the port's COLMAP and PLY readers and writers. The
rotation comes from <scene_dir>/rotation_angles.txt (extrinsic x-y-z Euler
degrees, scipy's 'xyz' convention) or --degrees. --rotate_colmap writes
c2w' = R4 @ c2w for every image and points x' = R x to sparse/0_align/;
--ply writes xyz' = x Rᵀ, rotation' = q_R ⊗ q and the rest-SH
coefficients rotated per degree (utils/sh_rotation.py) to <ply>_align.ply.
The work is numpy on the host; nothing runs on the card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def rotate_colmap(scene_dir: str, R4: np.ndarray) -> str:
    from ..data.colmap import (ColmapImage, qvec2rotmat, read_cameras_binary,
                               read_images_binary, read_points3D_binary,
                               rotmat2qvec, write_cameras_binary,
                               write_images_binary, write_points3D_binary)
    sparse = os.path.join(scene_dir, "sparse", "0")
    cams = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    ims = read_images_binary(os.path.join(sparse, "images.bin"))
    xyz, rgb, _ = read_points3D_binary(os.path.join(sparse, "points3D.bin"))

    out = {}
    for k, im in ims.items():
        w2c = np.eye(4)
        w2c[:3, :3] = qvec2rotmat(im.qvec)
        w2c[:3, 3] = im.tvec
        w2c2 = np.linalg.inv(R4 @ np.linalg.inv(w2c))
        out[k] = ColmapImage(id=im.id, qvec=rotmat2qvec(w2c2[:3, :3]),
                             tvec=w2c2[:3, 3], camera_id=im.camera_id,
                             name=im.name, xys=im.xys,
                             point3D_ids=im.point3D_ids)

    save_dir = os.path.join(scene_dir, "sparse", "0_align")
    os.makedirs(save_dir, exist_ok=True)
    write_cameras_binary(cams, os.path.join(save_dir, "cameras.bin"))
    write_images_binary(out, os.path.join(save_dir, "images.bin"))
    write_points3D_binary(xyz @ R4[:3, :3].T, rgb,
                          os.path.join(save_dir, "points3D.bin"))
    return save_dir


def rotate_gaussians(ply_path: str, R: np.ndarray, seg_feat_dim: int = 16,
                     rotate_xyz=True, rotate_rot=True, rotate_sh=True) -> str:
    """The PLY (with its seg features when it has seg_feat_dim of them)
    rotated by R, written beside it as <ply>_align.ply."""
    from ..models.gaussians import load_ply, save_ply
    from ..utils.sh_rotation import (compose_quaternion, rotate_sh_rest,
                                     rotmat_to_quat)
    p = load_ply(ply_path, seg_feat_dim=seg_feat_dim, load_seg_feat=True,
                 device="cpu")
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    if rotate_xyz:
        p = p.replace(xyz=f32(p.xyz.numpy() @ R.T))
    if rotate_rot:
        q = p.rotation.numpy()
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        p = p.replace(rotation=f32(compose_quaternion(rotmat_to_quat(R), q)))
    if rotate_sh:
        p = p.replace(features_rest=f32(rotate_sh_rest(
            p.features_rest.numpy(), R)))
    out_path = os.path.splitext(ply_path)[0] + "_align.ply"
    save_ply(p, out_path)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene_dir", required=True)
    ap.add_argument("--degrees", default="",
                    help="rx,ry,rz extrinsic Euler degrees; default: read "
                         "<scene_dir>/rotation_angles.txt")
    ap.add_argument("--rotate_colmap", action="store_true")
    ap.add_argument("--ply", default="",
                    help="gaussian PLY to rotate (xyz+rotation+SH) → "
                         "<ply>_align.ply")
    ap.add_argument("--seg_feat_dim", type=int, default=16)
    ap.add_argument("--no_xyz", action="store_true")
    ap.add_argument("--no_rotation", action="store_true")
    ap.add_argument("--no_sh", action="store_true")
    args = ap.parse_args(argv)

    from ..utils.sh_rotation import euler_deg_to_rotmat
    if args.degrees:
        deg = [float(x) for x in args.degrees.split(",")]
    else:
        deg = np.loadtxt(os.path.join(args.scene_dir,
                                      "rotation_angles.txt")).reshape(-1)
    R = euler_deg_to_rotmat(deg)
    R4 = np.eye(4)
    R4[:3, :3] = R
    outs = {}
    if args.rotate_colmap:
        outs["colmap"] = rotate_colmap(args.scene_dir, R4)
        print(f"aligned COLMAP model -> {outs['colmap']}")
    if args.ply:
        outs["ply"] = rotate_gaussians(
            args.ply, R, seg_feat_dim=args.seg_feat_dim,
            rotate_xyz=not args.no_xyz, rotate_rot=not args.no_rotation,
            rotate_sh=not args.no_sh)
        print(f"aligned gaussians -> {outs['ply']}")
    return outs


if __name__ == "__main__":
    main()
