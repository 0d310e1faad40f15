"""Rigid rotation of gaussian-splat scenes: SH coefficients, quaternions.

Port of instascene_tpu/utils/sh_rotation.py:1-128, numpy in float64 with
the same calls in the same order, so the blocks and rotations equal the
JAX package's. The per-degree real-SH rotation blocks are derived
numerically from the package's own basis (ops/sh.eval_sh_np): each
degree-l subspace is closed under rotation, so sampling 64 directions d_i
gives an overdetermined system whose least-squares solution D_l satisfies
Y_l(d)·D_l = Y_l(Rᵀd) exactly up to float64 round-off, for whatever sign
and order convention the basis uses.
"""

from __future__ import annotations

import numpy as np

from ..ops.sh import eval_sh_np

_L_SLICES = {1: slice(1, 4), 2: slice(4, 9), 3: slice(9, 16)}


def _basis_matrix(dirs: np.ndarray) -> np.ndarray:
    """[M, 16] real-SH basis values in the framework's own convention:
    evaluate eval_sh with one-hot coefficient vectors."""
    M = dirs.shape[0]
    out = np.empty((M, 16))
    for j in range(16):
        c = np.zeros((16, 1))
        c[j, 0] = 1.0
        out[:, j] = eval_sh_np(3, c, dirs)[:, 0]
    return out


def sh_rotation_blocks(R: np.ndarray, rng_seed: int = 0) -> dict:
    """Per-degree real-SH rotation blocks {l: [2l+1, 2l+1]} for a 3x3
    world rotation R (degree 0 is rotation-invariant)."""
    rng = np.random.default_rng(rng_seed)
    dirs = rng.standard_normal((64, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    B = _basis_matrix(dirs)
    Bt = _basis_matrix(dirs @ R)          # rows: Y(Rᵀ d_i)  (d @ R = Rᵀ·d)
    blocks = {}
    for l, sl in _L_SLICES.items():
        D, *_ = np.linalg.lstsq(B[:, sl], Bt[:, sl], rcond=None)
        blocks[l] = D
    return blocks


def rotate_sh_rest(features_rest: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Rotate [N, 15, 3] rest-SH coefficients (degrees 1..3; the DC term is
    rotation-invariant) by the world rotation R, per color channel."""
    blocks = sh_rotation_blocks(R)
    out = np.array(features_rest, dtype=np.float64, copy=True)
    for l, sl in _L_SLICES.items():
        lo, hi = sl.start - 1, sl.stop - 1   # rest array starts at degree 1
        # coefficients transform with the block's transpose-inverse; for the
        # orthonormal real-SH basis the block is orthogonal, and lstsq gives
        # the VALUE-space map Y(d)·D = Y(Rᵀd), so c' = D c reproduces
        # f'(d) = f(Rᵀ d) — the rotated scene's radiance
        out[:, lo:hi] = np.einsum("ij,njc->nic", blocks[l],
                                  features_rest[:, lo:hi].astype(np.float64))
    return out.astype(features_rest.dtype)


def compose_quaternion(q_r: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Left-multiply [N, 4] (w,x,y,z) quaternions by a single rotation
    quaternion q_r: rotmat(q') = rotmat(q_r) @ rotmat(q)."""
    w1, x1, y1, z1 = q_r
    w2, x2, y2, z2 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
    ], axis=1)


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix → (w,x,y,z) unit quaternion (Shepperd's method:
    branch on the largest diagonal combination for numerical safety)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def euler_deg_to_rotmat(degrees_xyz) -> np.ndarray:
    """Extrinsic x-y-z Euler angles in degrees → 3x3 rotation matrix
    (matches scipy's Rotation.from_euler('xyz', ..., degrees=True), the
    reference's convention at align_coords.py:94)."""
    rx, ry, rz = np.radians(np.asarray(degrees_xyz, dtype=np.float64))
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx            # extrinsic xyz = Rz·Ry·Rx
