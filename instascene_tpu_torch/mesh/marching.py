"""Marching tetrahedra iso-surface extraction, in torch on the field's
device.

Port of instascene_tpu/mesh/marching.py:31-131, which runs in numpy on the
host. Each grid cube is split into the same 6 tetrahedra; each tetrahedron
with a sign change emits 1-2 triangles from the same table, in the same
order (by sign code in the table's order, then by triangle, then by
tetrahedron), with vertices interpolated on the edges in float64 and
deduplicated per shared edge by a sorted unique of the edge keys. The
output equals the JAX package's: the same faces in the same order and the
same vertex bits, on the CPU and on the card (the interpolation is written
as separate operations, so no multiply-add is contracted).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

# 6-tetrahedra decomposition of a cube (corner ids 0..7, corner = x + 2y + 4z)
_TETS = [[0, 5, 1, 3], [0, 5, 3, 7], [0, 5, 7, 4],
         [0, 7, 3, 2], [0, 7, 2, 6], [0, 7, 6, 4]]
_CORNER_OFFSETS = [[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)]
# the edges of a tetrahedron, as pairs of its local corners
_EDGES = [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]]
# triangle edge-id triples per sign code, in the JAX package's dict order
# (its faces come out grouped by code in this order)
TRI_TABLE = {
    1: [[0, 1, 2]], 14: [[0, 2, 1]],
    2: [[0, 4, 3]], 13: [[0, 3, 4]],
    4: [[1, 3, 5]], 11: [[1, 5, 3]],
    8: [[2, 5, 4]], 7: [[2, 4, 5]],
    3: [[1, 2, 4], [1, 4, 3]], 12: [[1, 4, 2], [1, 3, 4]],
    5: [[0, 3, 5], [0, 5, 2]], 10: [[0, 5, 3], [0, 2, 5]],
    6: [[0, 4, 5], [0, 5, 1]], 9: [[0, 5, 4], [0, 1, 5]],
}


def _tables():
    """Per sign code: its rank in TRI_TABLE's order, its triangle count,
    and its (up to two) triangles' edge ids."""
    rank = np.zeros(16, np.int64)
    n_tris = np.zeros(16, np.int64)
    tris = np.zeros((16, 2, 3), np.int64)
    for r, (c, ts) in enumerate(TRI_TABLE.items()):
        rank[c], n_tris[c] = r, len(ts)
        tris[c, :len(ts)] = ts
    return rank, n_tris, tris


_RANK, _N_TRIS, _TRIS = _tables()


def _empty(dev):
    return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
            torch.zeros((0, 3), dtype=torch.int32, device=dev))


def marching_tetrahedra(values, level: float = 0.0, origin=(0.0, 0.0, 0.0),
                        spacing: float = 1.0, device=None):
    """values: [X,Y,Z] scalar field (a tensor, or a numpy array moved to
    `device`; None → CUDA), taken as float64 as every caller passes it.
    Returns (verts [V,3], faces [F,3] int32) on its device. Vertices are
    deduplicated per shared edge; where an edge is met more than once the
    last interpolation in face order gives its bits, as numpy's fancy
    assignment does. verts are float32, or float64 where numpy would promote
    `verts * spacing` (a numpy float64 spacing)."""
    if isinstance(values, torch.Tensor):
        dev = values.device
    else:
        dev = resolve_device(device)
        values = torch.as_tensor(np.asarray(values), device=dev)
    X, Y, Z = values.shape
    if min(X, Y, Z) < 2:
        return _empty(dev)
    v = values.to(torch.float64) - level

    # cube corner values [C, 8] over the cubes in C order, then only the
    # cubes crossing the level
    cv = torch.stack([v[dx:dx + X - 1, dy:dy + Y - 1, dz:dz + Z - 1]
                      for dx, dy, dz in _CORNER_OFFSETS], dim=-1)
    cv = cv.reshape(-1, 8)
    cross = (cv.amin(dim=1) < 0) & (cv.amax(dim=1) >= 0)
    cube = torch.nonzero(cross)[:, 0]
    if cube.numel() == 0:
        return _empty(dev)
    cv = cv[cube]
    cube_pos = torch.stack([cube // ((Y - 1) * (Z - 1)),
                            (cube // (Z - 1)) % (Y - 1), cube % (Z - 1)], 1)

    tets = torch.as_tensor(_TETS, device=dev)
    tv = cv[:, tets].reshape(-1, 4)                     # [C*6, 4]
    code = ((tv < 0).long() * torch.tensor([1, 2, 4, 8], device=dev)).sum(1)
    active = torch.nonzero((code > 0) & (code < 15))[:, 0]
    code = code[active]

    # every (tetrahedron, triangle) the table emits, ordered as the JAX
    # package concatenates them: by the code's rank, then the triangle,
    # then the tetrahedron (a stable sort keeps the tetrahedra in order)
    n_tris = torch.as_tensor(_N_TRIS, device=dev)[code]
    tet_of = torch.repeat_interleave(torch.arange(len(code), device=dev),
                                     n_tris)
    first = torch.cumsum(n_tris, 0) - n_tris
    tri_of = torch.arange(len(tet_of), device=dev) - first[tet_of]
    rank = torch.as_tensor(_RANK, device=dev)[code[tet_of]]
    order = torch.sort(rank * 2 + tri_of, stable=True).indices
    tet_of, tri_of = tet_of[order], tri_of[order]
    if len(tet_of) == 0:
        return _empty(dev)
    edge_ids = torch.as_tensor(_TRIS, device=dev)[code[tet_of], tri_of]
    edges = torch.as_tensor(_EDGES, device=dev)[edge_ids]    # [F, 3, 2]
    ea, eb = edges[..., 0], edges[..., 1]                    # tet-local

    tet = active[tet_of]                                     # into tv
    tcorn = tets[tet % 6]                                    # [F, 4]
    ca = torch.gather(tcorn, 1, ea)                          # cube corners
    cb = torch.gather(tcorn, 1, eb)
    va = torch.gather(tv[tet], 1, ea)
    vb = torch.gather(tv[tet], 1, eb)
    base = cube_pos[tet // 6][:, None, :]                    # [F, 1, 3]
    off = torch.as_tensor(_CORNER_OFFSETS, device=dev)
    pa = base + off[ca]                                      # [F, 3, 3]
    pb = base + off[cb]
    t = va / ((va - vb) + 1e-12)
    pts = pa.double() + t[..., None] * (pb - pa).double()

    # dedup shared-edge vertices on the key (lower corner, higher corner)
    stride = torch.tensor([Y * Z, Z, 1], device=dev)
    ka = (pa * stride).sum(-1)
    kb = (pb * stride).sum(-1)
    ekey = torch.minimum(ka, kb) * (X * Y * Z) + torch.maximum(ka, kb)
    uniq, inv = torch.unique(ekey.reshape(-1), sorted=True,
                             return_inverse=True)
    last = torch.zeros(len(uniq), dtype=torch.long, device=dev)
    last.scatter_reduce_(0, inv, torch.arange(inv.numel(), device=dev),
                         reduce="amax", include_self=False)
    verts = pts.reshape(-1, 3)[last].to(torch.float32)
    faces = inv.reshape(-1, 3).to(torch.int32)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    faces = faces[good]
    # verts * spacing + origin in numpy's types: the spacing is a float32
    # operand, or float64 where numpy promotes (a numpy float64 scalar)
    dt = np.result_type(np.zeros(1, np.float32), spacing)
    tdt = torch.float64 if dt == np.float64 else torch.float32
    sp = torch.tensor(np.asarray(spacing, dt), device=dev)
    org = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    return verts.to(tdt) * sp + org.to(tdt), faces
