"""Minimal PLY reader/writer (binary_little_endian + ascii), no external deps.

Port of instascene_tpu/data/ply.py:32-158 (read_ply, write_ply,
read_point_cloud, write_point_cloud). Produces
files byte-compatible with the reference's plyfile output
(scene/gaussian_model.py:285-313 writes a single 'vertex' element of f4 fields;
scene/dataset_readers.py:124-139 writes xyz/normal f4 + rgb u1). The Gaussian
attribute ordering contract (x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,scale_*,
rot_*,segfeat_*) lives in models/gaussians.py.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY file. Returns {element_name: structured array}.

    Supports binary_little_endian and ascii, scalar properties only (list
    properties — e.g. face indices — are skipped for non-vertex elements and
    unsupported for binary files containing them before scalar data)."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(("__list__", parts[-1]))
                else:
                    elements[-1][2].append((parts[2], _PLY_TO_NP[parts[1]]))

        out = {}
        if fmt == "binary_little_endian":
            for name, count, props in elements:
                if any(p[0] == "__list__" for p in props):
                    break  # variable-length records: stop (vertex data already read)
                dtype = np.dtype([(p, "<" + t) for p, t in props])
                out[name] = np.frombuffer(f.read(dtype.itemsize * count),
                                          dtype=dtype).copy()
        elif fmt == "ascii":
            text = f.read().decode("ascii").split("\n")
            row = 0
            for name, count, props in elements:
                if any(p[0] == "__list__" for p in props):
                    break
                dtype = np.dtype([(p, t) for p, t in props])
                arr = np.empty(count, dtype=dtype)
                for i in range(count):
                    vals = text[row].split()
                    row += 1
                    for (p, t), v in zip(props, vals):
                        arr[p][i] = np.dtype(t).type(float(v))
                out[name] = arr
        else:
            raise ValueError(f"unsupported PLY format: {fmt}")
    return out


def write_ply(path: str, vertex: np.ndarray,
              element_name: str = "vertex") -> None:
    """Write a structured array as a single-element binary little-endian
    PLY file. Field order and dtypes are taken from `vertex.dtype`
    verbatim, so callers control the on-disk attribute contract."""
    header = ["ply", "format binary_little_endian 1.0",
              f"element {element_name} {len(vertex)}"]
    for name in vertex.dtype.names:
        base = vertex.dtype[name].str.lstrip("<>|=")
        header.append(f"property {_NP_TO_PLY[base]} {name}")
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        # plyfile writes little-endian packed records; match exactly.
        le = np.dtype([(n, vertex.dtype[n].str.replace(">", "<")
                        .replace("=", "<")) for n in vertex.dtype.names])
        f.write(vertex.astype(le, copy=False).tobytes())


def read_point_cloud(path: str):
    """A point cloud PLY → (points [N,3] f64, colors [N,3] f64 in [0,1],
    normals [N,3]); missing colors or normals are zeros."""
    data = read_ply(path)["vertex"]
    pts = np.stack([data["x"], data["y"], data["z"]],
                   axis=-1).astype(np.float64)
    names = data.dtype.names
    if "red" in names:
        colors = np.stack([data["red"], data["green"], data["blue"]],
                          axis=-1).astype(np.float64) / 255.0
    else:
        colors = np.zeros_like(pts)
    if "nx" in names:
        normals = np.stack([data["nx"], data["ny"], data["nz"]], axis=-1)
    else:
        normals = np.zeros_like(pts)
    return pts, colors, normals


def write_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray = None,
                      normals: np.ndarray = None) -> None:
    """Write xyz, normals (zeros if none) and, given rgb, uint8 colors:
    x,y,z,nx,ny,nz f4 + red,green,blue u1 (the reference's storePly
    layout). Float rgb in [0, 1] is scaled to 0-255."""
    n = len(xyz)
    fields = [("x", "f4"), ("y", "f4"), ("z", "f4"), ("nx", "f4"),
              ("ny", "f4"), ("nz", "f4")]
    if normals is None:
        normals = np.zeros_like(xyz)
    if rgb is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    arr = np.empty(n, dtype=fields)
    arr["x"], arr["y"], arr["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    arr["nx"], arr["ny"], arr["nz"] = (normals[:, 0], normals[:, 1],
                                       normals[:, 2])
    if rgb is not None:
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb * 255.0 if rgb.max() <= 1.0 + 1e-6 else rgb,
                          0, 255).astype(np.uint8)
        arr["red"], arr["green"], arr["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    write_ply(path, arr)
