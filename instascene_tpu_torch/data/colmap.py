"""COLMAP sparse-reconstruction readers and writers (binary and text).

Port of instascene_tpu/data/colmap.py:35-241: the same camera model table,
records and readers, numpy. points3D.bin goes through the native C++
walker (native/colmap_io.cpp via data/native.py) when it builds; otherwise
it is walked once in Python for its variable-length tracks and then read
as one structured array. The binary writers emit the same bytes as the JAX
package's.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# COLMAP camera model table: model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}

# one points3D.bin record before its track: id, xyz, rgb, error
_POINT = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                   ("error", "<f8"), ("track_len", "<u8")])


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z,
         2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x,
         1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R):
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, num_bytes, fmt):
    return struct.unpack("<" + fmt, f.read(num_bytes))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, 24, "iiQQ")
            model_name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            cameras[cam_id] = ColmapCamera(cam_id, model_name, int(width),
                                           int(height), params)
    return cameras


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        for _ in range(num):
            vals = _read(f, 64, "idddddddi")
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            num_pts = _read(f, 8, "Q")[0]
            rec = np.frombuffer(f.read(24 * num_pts),
                                dtype=[("x", "<f8"), ("y", "<f8"),
                                       ("id", "<i8")])
            images[vals[0]] = ColmapImage(
                vals[0], np.array(vals[1:5]), np.array(vals[5:8]), vals[8],
                name.decode("utf-8"), np.stack([rec["x"], rec["y"]], -1),
                rec["id"].copy())
    return images


def read_points3D_binary(path: str):
    """Returns (xyz [N,3] f64, rgb [N,3] u8, errors [N,1] f64). The
    records are variable-length (each carries its track), so the walk is
    sequential: native/colmap_io.cpp does it when it builds
    (data/native.py), parse_points3D otherwise."""
    with open(path, "rb") as f:
        data = f.read()
    from .native import points3d_parse_native
    parsed = points3d_parse_native(data)
    return parsed if parsed is not None else parse_points3D(data)


def parse_points3D(data: bytes):
    """A points3D.bin buffer parsed in Python: one walk over the records'
    track lengths, then one structured read."""
    (num,) = struct.unpack_from("<Q", data, 0)
    offsets = np.empty(num, np.int64)
    pos = 8
    for i in range(num):          # the tracks make records variable-length
        offsets[i] = pos
        (track_len,) = struct.unpack_from("<Q", data, pos + 43)
        pos += _POINT.itemsize + 8 * track_len
    buf = np.frombuffer(data, np.uint8)
    rec = buf[offsets[:, None] + np.arange(_POINT.itemsize)].view(_POINT)[:, 0]
    return (rec["xyz"].astype(np.float64), rec["rgb"].copy(),
            rec["error"].astype(np.float64)[:, None])


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cam_id = int(elems[0])
            cameras[cam_id] = ColmapCamera(
                cam_id, elems[1], int(elems[2]), int(elems[3]),
                np.array([float(x) for x in elems[4:]]))
    return cameras


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.strip().startswith("#")]
    for i in range(0, len(lines), 2):
        elems = lines[i].split()
        image_id = int(elems[0])
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(x) for j, x in enumerate(pts) if j % 3 != 2],
                       dtype=np.float64).reshape(-1, 2)
        p3d_ids = np.array([int(x) for j, x in enumerate(pts) if j % 3 == 2],
                           dtype=np.int64)
        images[image_id] = ColmapImage(
            image_id, np.array([float(x) for x in elems[1:5]]),
            np.array([float(x) for x in elems[5:8]]), int(elems[8]),
            elems[9], xys, p3d_ids)
    return images


def read_points3D_text(path: str):
    xyz_l, rgb_l, err_l = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            xyz_l.append([float(x) for x in elems[1:4]])
            rgb_l.append([int(x) for x in elems[4:7]])
            err_l.append([float(elems[7])])
    return (np.array(xyz_l), np.array(rgb_l, dtype=np.uint8),
            np.array(err_l))


def write_cameras_binary(cameras: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            f.write(struct.pack("<iiQQ", cam.id, CAMERA_MODEL_IDS[cam.model],
                                cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_images_binary(images: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.point3D_ids)))
            rec = np.empty(len(im.point3D_ids), [("x", "<f8"), ("y", "<f8"),
                                                 ("id", "<i8")])
            if len(rec):
                rec["x"], rec["y"] = im.xys[:, 0], im.xys[:, 1]
                rec["id"] = im.point3D_ids
            f.write(rec.tobytes())


def write_points3D_binary(xyz: np.ndarray, rgb: np.ndarray, path: str) -> None:
    """Points with ids 1..N, error 0 and empty tracks."""
    rec = np.zeros(len(xyz), _POINT)
    rec["id"] = np.arange(1, len(xyz) + 1)
    rec["xyz"] = xyz
    rec["rgb"] = np.asarray(rgb).astype(np.int64)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        f.write(rec.tobytes())


def load_sparse_model(scene_dir: str):
    """Cameras and images of a COLMAP sparse dir (binary, text fallback)."""
    bin_cams = os.path.join(scene_dir, "cameras.bin")
    if os.path.exists(bin_cams):
        return (read_cameras_binary(bin_cams),
                read_images_binary(os.path.join(scene_dir, "images.bin")))
    return (read_cameras_text(os.path.join(scene_dir, "cameras.txt")),
            read_images_text(os.path.join(scene_dir, "images.txt")))
