"""Per-gaussian preprocessing: splat→pixel homography, view normals, screen
AABB and tile rect.

Port of instascene_tpu/ops/preprocess.py:25-280 (`quat_to_rotmat`,
`ndc2pix_rows`, `preprocess_gaussians` with the default-on opacity-aware
rect shrink and the opt-in exact conic culling), :283-455
(`conic_cull_masks`, `_mask_below`, `_mask_range`) and :457
(`mark_visible`), with the slab origin (`y_offset`, `full_height`) that
the tile-slab sharded render folds into the homography.

Two paths, chosen by the device. CPU tensors run `preprocess_plain`, the
eager chain in torch ops (~456 launches a view), differentiable in every
input, the camera included: the kernels' plain version. A CUDA call that
needs no graph (viewer frames, the tracker, the semantic step's frozen
geometry, binning caches, mesh export) launches csrc/preprocess.cu
(`preprocess_kernel`): the same outputs bit for bit in one launch. A CUDA
call under autograd whose geometry or SH require grad (the geometry
training steps) takes the same launch inside `PreprocessFunction`, whose
backward is csrc/preprocess.cu's second kernel (`preprocess_bwd_kernel`);
a CUDA call whose camera requires grad is refused (no path takes camera
gradients on the card). `cuda_build.LAUNCHES` counts "preprocess" and
"preprocess_bwd". `fma`, `fma_rows` and `cross` are the rounding below,
shared with the blend's plain versions and mesh/tsdf.py.

Convention: T[n] is a 3x3 matrix whose rows (Tu, Tv, Tw) map splat-tangent
homogeneous coords (u, v, 1) to (x_pix·w, y_pix·w, w):
    T[n] = ndc2pix(3x4) @ full_proj(4x4) @ splat2world[n](4x3)

Rounding. The affine ray-splat form the blend evaluates (p = x·A + y·B + C,
A/B/C cross products of T's rows) cancels heavily, so a last-bit change in T
moves alpha across the 1/255 mask now and then. The contractions here are
therefore written out as fused multiply-add chains, in the order XLA's dot
rounds them (acc = x0·m0, then acc = fma(xk, mk, acc)): the CPU, the GPU and
the JAX package then agree on T to the bit, and no matmul (or TF32) path is
taken.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..cuda_build import LAUNCHES, F, I, P, lib_fn, operand, ptr, stream
from .sh import num_sh_coeffs, sh_to_color
from ..utils.profiling import span

NEAR_N = 0.2
FAR_N = 100.0
FILTER_SIZE = 0.707106  # sqrt(2)/2 low-pass radius
FILTER_INV_SQUARE = 2.0
CUTOFF = 3.0  # 3-sigma splat extent
TILE = 16     # screen tile edge in pixels (the blend kernel's block)


class PreprocessOut(NamedTuple):
    T: torch.Tensor             # [N,3,3] rows (Tu,Tv,Tw)
    normal_view: torch.Tensor   # [N,3] view-space normal, dual-visibility signed
    depth: torch.Tensor         # [N] view-space z (sorting key)
    xy: torch.Tensor            # [N,2] AABB / low-pass filter center (pixels)
    radius: torch.Tensor        # [N] f32 screen radius (0 when invalid)
    rect_min: torch.Tensor      # [N,2] int32 (tile_x, tile_y) inclusive
    rect_max: torch.Tensor      # [N,2] int32 exclusive
    tiles_touched: torch.Tensor  # [N] int32
    valid: torch.Tensor         # [N] bool
    color: torch.Tensor         # [N,3]
    # conic pair-culling bitmasks (conic_cull_masks): bit k set ⟺ row-major
    # rect offset k is kept; the 64-bit mask as two int32 words holding the
    # JAX package's uint32 bits. None without conic culling.
    cull_lo: Optional[torch.Tensor] = None   # [N] offsets 0..31
    cull_hi: Optional[torch.Tensor] = None   # [N] offsets 32..63


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once to f32 (the product of two f32 is exact in f64;
    the f64 sum then rounds, and the f32 cast rounds again — equal to a true
    fused multiply-add but for ties of that double rounding)."""
    return (a.double() * b.double() + c.double()).float()


def _sum3(a: torch.Tensor) -> torch.Tensor:
    return a[..., 0] + a[..., 1] + a[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b [N,3] with each component fma(a_i, b_j, −a_j·b_i), the
    rounding the JAX package's jnp.cross gets."""
    return torch.stack([fma(a[:, 1], b[:, 2], -(a[:, 2] * b[:, 1])),
                        fma(a[:, 2], b[:, 0], -(a[:, 0] * b[:, 2])),
                        fma(a[:, 0], b[:, 1], -(a[:, 1] * b[:, 0]))], dim=1)


def fma_rows(x: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """einsum('nk,jk->nj', x, M), k = 3, as an fma chain."""
    acc = x[:, 0:1] * M[None, :, 0]
    acc = fma(x[:, 1:2], M[None, :, 1], acc)
    return fma(x[:, 2:3], M[None, :, 2], acc)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[N,4] (w,x,y,z) quaternion (unnormalized ok) → [N,3,3]."""
    q = q * torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=1)


def ndc2pix_rows(width: int, height: int, device=None,
                 y_offset=None) -> torch.Tensor:
    """NDC→pixel rows, [3,4]. `y_offset` shifts the pixel-y origin: the
    horizontal slab [y_offset, y_offset + h) of a `height`-tall image then
    renders in local rows (a float32 subtraction, as the JAX package's)."""
    m = torch.tensor([
        [width / 2.0, 0, 0, (width - 1) / 2.0],
        [0, height / 2.0, 0, (height - 1) / 2.0],
        [0, 0, 0, 1.0]], dtype=torch.float32, device=device)
    if y_offset is not None:
        m[1, 3] = m[1, 3] - torch.as_tensor(y_offset, dtype=torch.float32,
                                            device=device)
    return m


def _conic_box(t_vec: torch.Tensor, T: torch.Tensor, d_scale: torch.Tensor):
    """Screen AABB of the level set {rho3d <= t} (forward.cu:119-145 with
    cutoff² = t): returns (ok, center_x, center_y, h0x, h0y, d)."""
    Tw = T[:, 2, :]
    d = _sum3(t_vec * Tw * Tw)
    d_ok = (torch.abs(d) > 1e-7 * d_scale) & (d_scale > 0)
    f_vec = t_vec / torch.where(d_ok, d, torch.ones_like(d))[:, None]
    cx = torch.clamp(_sum3(f_vec * T[:, 0, :] * Tw), -1e7, 1e7)
    cy = torch.clamp(_sum3(f_vec * T[:, 1, :] * Tw), -1e7, 1e7)
    h0x = cx * cx - _sum3(f_vec * T[:, 0, :] * T[:, 0, :])
    h0y = cy * cy - _sum3(f_vec * T[:, 1, :] * T[:, 1, :])
    return d_ok, cx, cy, h0x, h0y


def preprocess_gaussians(
        xyz: torch.Tensor,          # [N,3]
        scaling: torch.Tensor,      # [N,2] activated (exp) scales
        rotation: torch.Tensor,     # [N,4] quaternion (w,x,y,z)
        w2v: torch.Tensor,          # [4,4]
        full_proj: torch.Tensor,    # [4,4]
        campos: torch.Tensor,       # [3]
        width: int, height: int,
        opacity: torch.Tensor,                  # [N] or [N,1] activated
        color: Optional[torch.Tensor] = None,   # [N,3] precomputed colors
        shs: Optional[torch.Tensor] = None,     # [N,K,3]
        sh_degree: int = 0,
        alive: Optional[torch.Tensor] = None,
        conic_cull: bool = False, y_offset=None,
        full_height: Optional[int] = None) -> PreprocessOut:
    """Opacity-aware tile rect (the JAX default, opacity_cull=True): a
    gaussian of opacity o can only reach alpha >= 1/255 where
    rho <= thr(o) = 2·ln(255·o), so its rect shrinks to the thr-level conic
    AABB ∪ the thr-level low-pass disk. The blend masks alpha < 1/255
    exactly, so the output is unchanged with fewer pairs; radius / valid
    keep the opacity-blind 3σ semantics.

    conic_cull: also drop the rect tiles the conic cannot reach
    (conic_cull_masks): tiles_touched counts the kept offsets and
    cull_lo / cull_hi carry the keep-masks binning expands by.

    y_offset / full_height: render the rows [y_offset, y_offset + height)
    of a full_height-tall image into local rows [0, height): the NDC
    mapping uses the full image, the rect and tile clamps the slab. None
    leaves every other path as it was, bit for bit.

    CPU tensors run preprocess_plain. CUDA tensors launch
    csrc/preprocess.cu (preprocess_kernel) where autograd needs no graph;
    under grad mode, where xyz, scaling, rotation, opacity or shs (shs
    only without a given color) require grad, the same launch inside
    PreprocessFunction, differentiable by its backward kernel; where
    w2v, full_proj or campos require grad, a ValueError: camera gradients
    are taken on the CPU. A given color is returned as preprocess_plain
    returns it, color.to(float32), on every path."""
    args = (xyz, scaling, rotation, w2v, full_proj, campos, width, height,
            opacity, color, shs, sh_degree, alive, y_offset, full_height)
    with span("preprocess"):
        if not _on_card(xyz):
            pre = preprocess_plain(*args)
        elif not torch.is_grad_enabled():
            pre = preprocess_kernel(*args)
        elif any(_needs_grad(t) for t in (w2v, full_proj, campos)):
            raise ValueError("preprocess_gaussians: camera gradients are "
                             "taken on the CPU path (preprocess_plain); "
                             "on CUDA w2v, full_proj and campos must not "
                             "require grad")
        elif any(_needs_grad(t) for t in (
                xyz, scaling, rotation, opacity,
                shs if color is None else None)):
            pre = preprocess_graph(*args)
        else:
            pre = preprocess_kernel(*args)
        if conic_cull:
            cull_lo, cull_hi, tiles_touched = conic_cull_masks(
                pre.T, pre.xy, opacity, pre.rect_min, pre.rect_max,
                pre.tiles_touched)
            pre = pre._replace(tiles_touched=tiles_touched, cull_lo=cull_lo,
                               cull_hi=cull_hi)
        return pre


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _needs_grad(t) -> bool:
    return isinstance(t, torch.Tensor) and t.requires_grad


def preprocess_plain(xyz, scaling, rotation, w2v, full_proj, campos, width,
                     height, opacity, color=None, shs=None, sh_degree=0,
                     alive=None, y_offset=None,
                     full_height=None) -> PreprocessOut:
    """preprocess_gaussians without conic culling, in eager torch ops:
    differentiable, any device; the kernel's plain version."""
    f32 = torch.float32
    dev = xyz.device
    xyz = xyz.to(f32)
    w2v = w2v.to(f32)

    p_view = fma_rows(xyz, w2v[:3, :3]) + w2v[:3, 3]
    in_frustum = p_view[:, 2] > 0.2

    R = quat_to_rotmat(rotation.to(f32))
    su = scaling[:, 0:1].to(f32)
    sv = scaling[:, 1:2].to(f32)
    axis_u = R[:, :, 0] * su
    axis_v = R[:, :, 1] * sv
    normal_world = R[:, :, 2]

    n2p = ndc2pix_rows(width, full_height or height, dev, y_offset)
    fp = full_proj.to(f32)
    n2p_full = n2p[:, 0:1] * fp[0:1]                          # [3,4]
    for k in range(1, 4):
        n2p_full = fma(n2p[:, k:k + 1], fp[k:k + 1], n2p_full)
    Tu_col = fma_rows(axis_u, n2p_full[:, :3])
    Tv_col = fma_rows(axis_v, n2p_full[:, :3])
    Tc_col = fma_rows(xyz, n2p_full[:, :3]) + n2p_full[:, 3]
    T = torch.stack([Tu_col, Tv_col, Tc_col], dim=-1)          # [N,3,3]

    normal_view = fma_rows(normal_world, w2v[:3, :3])
    cos = -_sum3(p_view * normal_view)
    multiplier = torch.where(cos > 0, 1.0, -1.0)
    normal_view = normal_view * multiplier[:, None]

    # 3σ AABB and low-pass center; near-degenerate d is culled relative to
    # the magnitude of Tw and the center clamped into a finite range
    t_vec = torch.tensor([CUTOFF * CUTOFF, CUTOFF * CUTOFF, -1.0],
                         dtype=f32, device=dev)
    Tw = T[:, 2, :]
    d_scale = _sum3(torch.abs(t_vec) * Tw * Tw)
    d_ok, center_x, center_y, h0x, h0y = _conic_box(t_vec, T, d_scale)
    ext_x = torch.sqrt(torch.clamp(h0x, 1e-4, 1e14))
    ext_y = torch.sqrt(torch.clamp(h0y, 1e-4, 1e14))
    finite = (torch.isfinite(center_x) & torch.isfinite(center_y)
              & torch.isfinite(ext_x) & torch.isfinite(ext_y))
    zero = torch.zeros_like(center_x)
    center_x = torch.where(finite, center_x, zero)
    center_y = torch.where(finite, center_y, zero)
    ext_x = torch.where(finite, ext_x, zero)
    ext_y = torch.where(finite, ext_y, zero)
    xy = torch.stack([center_x, center_y], dim=-1)
    radius = torch.ceil(torch.clamp(torch.maximum(ext_x, ext_y),
                                    min=CUTOFF * FILTER_SIZE))

    # tight per-axis tile rect of the 3σ ellipse
    rx = torch.ceil(torch.clamp(ext_x, min=CUTOFF * FILTER_SIZE))
    ry = torch.ceil(torch.clamp(ext_y, min=CUTOFF * FILTER_SIZE))
    tile = TILE
    grid_x = (width + tile - 1) // tile
    grid_y = (height + tile - 1) // tile
    rmin_x = torch.clamp(torch.floor((xy[:, 0] - rx) / tile), 0, grid_x)
    rmin_y = torch.clamp(torch.floor((xy[:, 1] - ry) / tile), 0, grid_y)
    rmax_x = torch.clamp(torch.floor((xy[:, 0] + rx + tile - 1) / tile),
                         0, grid_x)
    rmax_y = torch.clamp(torch.floor((xy[:, 1] + ry + tile - 1) / tile),
                         0, grid_y)

    opa = torch.clamp(torch.reshape(opacity, (-1,)).to(f32), 1e-12, 1.0)
    thr = torch.clamp(2.0 * torch.log(255.0 * opa), 0.72, CUTOFF * CUTOFF)
    t_thr = torch.stack([thr, thr, -torch.ones_like(thr)], -1)
    dt_ok, ctx, cty, h0x_t, h0y_t = _conic_box(t_thr, T, d_scale)
    ext_tx = torch.sqrt(torch.clamp(h0x_t, 1e-4, 1e14))
    ext_ty = torch.sqrt(torch.clamp(h0y_t, 1e-4, 1e14))
    ok_t = (dt_ok & torch.isfinite(ctx) & torch.isfinite(cty)
            & torch.isfinite(ext_tx) & torch.isfinite(ext_ty)
            & (thr < 8.99))
    r2d = torch.sqrt(thr / FILTER_INV_SQUARE)
    # 0.5-px guard for f32 rounding; the tile-floor conversion of the
    # fractional upper bound is a true ceil (floor(hi / tile) + 1)
    pad = 0.5
    lo_x = torch.minimum(ctx - ext_tx, xy[:, 0] - r2d) - pad
    hi_x = torch.maximum(ctx + ext_tx, xy[:, 0] + r2d) + pad
    lo_y = torch.minimum(cty - ext_ty, xy[:, 1] - r2d) - pad
    hi_y = torch.maximum(cty + ext_ty, xy[:, 1] + r2d) + pad
    cmin_x = torch.maximum(rmin_x, torch.clamp(torch.floor(lo_x / tile),
                                               0, grid_x))
    cmin_y = torch.maximum(rmin_y, torch.clamp(torch.floor(lo_y / tile),
                                               0, grid_y))
    cmax_x = torch.minimum(rmax_x, torch.clamp(
        torch.floor(hi_x / tile) + 1, 0, grid_x))
    cmax_y = torch.minimum(rmax_y, torch.clamp(
        torch.floor(hi_y / tile) + 1, 0, grid_y))
    b_rmin_x = torch.where(ok_t, cmin_x, rmin_x)
    b_rmin_y = torch.where(ok_t, cmin_y, rmin_y)
    b_rmax_x = torch.where(ok_t, torch.maximum(cmax_x, cmin_x), rmax_x)
    b_rmax_y = torch.where(ok_t, torch.maximum(cmax_y, cmin_y), rmax_y)

    rect_min = torch.stack([b_rmin_x, b_rmin_y], dim=-1).to(torch.int32)
    rect_max = torch.stack([b_rmax_x, b_rmax_y], dim=-1).to(torch.int32)
    tiles = ((rect_max[:, 0] - rect_min[:, 0])
             * (rect_max[:, 1] - rect_min[:, 1]))
    # visibility keeps the opacity-blind 3σ box's tile count
    tiles9 = (rmax_x - rmin_x) * (rmax_y - rmin_y)

    valid = in_frustum & d_ok & finite & (tiles9 > 0)
    if alive is not None:
        valid = valid & alive
    tiles_touched = torch.where(valid, tiles, 0).to(torch.int32)
    radius = torch.where(valid, radius, 0.0)

    if color is None:
        color = sh_to_color(sh_degree, shs.to(f32), xyz, campos.to(f32))
    else:
        color = color.to(f32)

    return PreprocessOut(T=T, normal_view=normal_view, depth=p_view[:, 2],
                         xy=xy, radius=radius, rect_min=rect_min,
                         rect_max=rect_max, tiles_touched=tiles_touched,
                         valid=valid, color=color)


def _sh_operand(shs, sh_degree, n, dev):
    """(shs [n, K, 3] as the kernels take it, K); raises unless the degree
    is 0-3 and shs holds its coefficients."""
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"preprocess kernel: SH degree {sh_degree} is not "
                         f"in 0-3")
    k = shs.shape[1] if shs.dim() == 3 else 0
    shs = operand("shs", shs, (n, k, 3), dev, cast=True)
    if k < num_sh_coeffs(sh_degree):
        raise ValueError(f"preprocess kernel: SH degree {sh_degree} needs "
                         f"{num_sh_coeffs(sh_degree)} coefficients, shs has "
                         f"{k}")
    return shs, k


def _camera(w2v, full_proj, campos, width, height, y_offset, full_height,
            dev):
    """The camera as the kernels take it: w2v, full_proj and campos on the
    device, and ndc2pix_rows' four nonzero entries, rounded to float32 as
    it rounds them (y_offset, a number, folded into the y origin)."""
    full_h = full_height or height
    oy = np.float32((full_h - 1) / 2.0)
    if y_offset is not None:
        oy = oy - np.float32(y_offset)
    n2p = [float(np.float32(v)) for v in (width / 2.0, (width - 1) / 2.0,
                                          full_h / 2.0, oy)]
    return (operand("w2v", w2v, (4, 4), dev, cast=True),
            operand("full_proj", full_proj, (4, 4), dev, cast=True),
            operand("campos", campos, (3,), dev, cast=True), n2p)


def preprocess_kernel(xyz, scaling, rotation, w2v, full_proj, campos, width,
                      height, opacity, color=None, shs=None, sh_degree=0,
                      alive=None, y_offset=None,
                      full_height=None) -> PreprocessOut:
    """preprocess_plain's outputs from one launch of csrc/preprocess.cu,
    bit for bit, without an autograd graph. CUDA tensors only; raises on
    what the kernel does not take. A given color is returned as
    preprocess_plain returns it (color.to(float32)) and the kernel writes
    none; otherwise it evaluates SH of sh_degree from shs. The camera stays
    on the device. Each launch counts one in LAUNCHES["preprocess"]; with
    no gaussians nothing is launched or counted."""
    f32 = torch.float32
    dev = xyz.device
    n = xyz.shape[0]
    xyz = operand("xyz", xyz, (n, 3), dev, cast=True)
    scaling = operand("scaling", scaling, (n, 2), dev, cast=True)
    rotation = operand("rotation", rotation, (n, 4), dev, cast=True)
    opacity = operand("opacity", torch.reshape(opacity, (-1,)), (n,), dev,
                      cast=True)
    cam = _camera(w2v, full_proj, campos, width, height, y_offset,
                  full_height, dev)
    if alive is not None:
        alive = operand("alive", alive, (n,), dev, torch.bool, cast=True)
    if color is not None:
        color = operand("color", color, (n, 3), dev, cast=True)
        degree, k, shs = -1, 0, None
    elif shs is None:
        raise ValueError("preprocess_kernel: give color or shs")
    else:
        shs, k = _sh_operand(shs, sh_degree, n, dev)
        degree = sh_degree

    out = PreprocessOut(
        T=torch.empty((n, 3, 3), dtype=f32, device=dev),
        normal_view=torch.empty((n, 3), dtype=f32, device=dev),
        depth=torch.empty((n,), dtype=f32, device=dev),
        xy=torch.empty((n, 2), dtype=f32, device=dev),
        radius=torch.empty((n,), dtype=f32, device=dev),
        rect_min=torch.empty((n, 2), dtype=torch.int32, device=dev),
        rect_max=torch.empty((n, 2), dtype=torch.int32, device=dev),
        tiles_touched=torch.empty((n,), dtype=torch.int32, device=dev),
        valid=torch.empty((n,), dtype=torch.bool, device=dev),
        color=(color if color is not None
               else torch.empty((n, 3), dtype=f32, device=dev)))
    if n == 0:
        return out      # no gaussians: nothing to launch
    fn = lib_fn("preprocess.cu", "preprocess_launch",
                [P] * 9 + [I] * 5 + [F] * 4 + [P] * 11)
    with torch.cuda.device(dev):
        err = fn(xyz.data_ptr(), scaling.data_ptr(), rotation.data_ptr(),
                 opacity.data_ptr(), ptr(alive), ptr(shs),
                 *[t.data_ptr() for t in cam[:3]], n, degree, k,
                 (width + TILE - 1) // TILE, (height + TILE - 1) // TILE,
                 *cam[3], *[t.data_ptr() for t in out[:9]],
                 None if color is not None else out.color.data_ptr(),
                 stream(dev))
    if err != 0:
        raise RuntimeError(f"preprocess kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES["preprocess"] += 1
    return out


def preprocess_bwd_kernel(args, grads):
    """The backward of preprocess_kernel in one launch of
    csrc/preprocess.cu's second kernel: args are preprocess_plain's
    arguments as the forward took them (color None), grads the gradients
    of T, normal_view, depth, xy and color (each None where that output
    took none; without shs the colour's is not read). Returns the
    gradients of xyz, scaling, rotation and shs (None without shs),
    float32 on the device; autograd's of
    preprocess_plain but for float rounding. Raises on what the kernel
    does not take. Each launch counts one in LAUNCHES["preprocess_bwd"];
    with no gaussians nothing is launched or counted."""
    (xyz, scaling, rotation, w2v, full_proj, campos, width, height, _, _,
     shs, sh_degree, _, y_offset, full_height) = args
    f32 = torch.float32
    dev = xyz.device
    n = xyz.shape[0]
    xyz = operand("xyz", xyz, (n, 3), dev, cast=True)
    scaling = operand("scaling", scaling, (n, 2), dev, cast=True)
    rotation = operand("rotation", rotation, (n, 4), dev, cast=True)
    cam = _camera(w2v, full_proj, campos, width, height, y_offset,
                  full_height, dev)
    if shs is not None:
        shs, k = _sh_operand(shs, sh_degree, n, dev)
        degree = sh_degree
    else:
        degree, k = -1, 0
    dT, dnormal, ddepth, dxy, dcolor = [
        None if g is None else operand(name, g, shape, dev, cast=True)
        for name, g, shape in zip(
            ("dT", "dnormal", "ddepth", "dxy", "dcolor"), grads,
            ((n, 3, 3), (n, 3), (n,), (n, 2), (n, 3)))]
    out = (torch.empty((n, 3), dtype=f32, device=dev),
           torch.empty((n, 2), dtype=f32, device=dev),
           torch.empty((n, 4), dtype=f32, device=dev),
           None if shs is None else torch.empty((n, k, 3), dtype=f32,
                                                device=dev))
    if n == 0:
        return out      # no gaussians: nothing to launch
    fn = lib_fn("preprocess.cu", "preprocess_bwd_launch",
                [P] * 7 + [I] * 3 + [F] * 4 + [P] * 10)
    with torch.cuda.device(dev):
        err = fn(xyz.data_ptr(), scaling.data_ptr(), rotation.data_ptr(),
                 ptr(shs), *[t.data_ptr() for t in cam[:3]], n, degree, k,
                 *cam[3], ptr(dT), ptr(dnormal), ptr(ddepth), ptr(dxy),
                 ptr(dcolor), *[ptr(t) for t in out], stream(dev))
    if err != 0:
        raise RuntimeError(f"preprocess backward kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["preprocess_bwd"] += 1
    return out


class PreprocessFunction(torch.autograd.Function):
    """preprocess_kernel with a graph: its forward launch, and a backward
    that launches preprocess_bwd_kernel. Differentiable in xyz, scaling,
    rotation and shs; opacity reaches the outputs only through the integer
    rects, so it gets None, as autograd gives it on the eager chain. The
    camera and the other arguments pass in `rest`, where autograd does not
    look: the call is made only where none of them requires grad. Returns
    the first nine fields of PreprocessOut, then the colour with shs."""

    @staticmethod
    def forward(ctx, xyz, scaling, rotation, opacity, shs, rest):
        (w2v, full_proj, campos, width, height, color, sh_degree, alive,
         y_offset, full_height) = rest
        out = preprocess_kernel(xyz, scaling, rotation, w2v, full_proj,
                                campos, width, height, opacity, color, shs,
                                sh_degree, alive, y_offset, full_height)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xyz, scaling, rotation, opacity, shs, w2v,
                              full_proj, campos)
        ctx.meta = (width, height, sh_degree, y_offset, full_height)
        ctx.mark_non_differentiable(out.radius, out.rect_min, out.rect_max,
                                    out.tiles_touched, out.valid)
        return tuple(out[:9]) + ((out.color,) if shs is not None else ())

    @staticmethod
    def backward(ctx, dT, dnormal, ddepth, dxy, *rest):
        xyz, scaling, rotation, opacity, shs, w2v, full_proj, campos = \
            ctx.saved_tensors
        width, height, sh_degree, y_offset, full_height = ctx.meta
        dcolor = rest[5] if shs is not None else None
        args = (xyz, scaling, rotation, w2v, full_proj, campos, width,
                height, opacity, None, shs, sh_degree, None, y_offset,
                full_height)
        dxyz, dscaling, drotation, dshs = preprocess_bwd_kernel(
            args, (dT, dnormal, ddepth, dxy, dcolor))
        return dxyz, dscaling, drotation, None, dshs, None


def preprocess_graph(xyz, scaling, rotation, w2v, full_proj, campos, width,
                     height, opacity, color=None, shs=None, sh_degree=0,
                     alive=None, y_offset=None,
                     full_height=None) -> PreprocessOut:
    """preprocess_kernel's outputs with autograd's graph through the
    geometry and SH (PreprocessFunction); a given color bypasses the
    Function as color.to(float32), so autograd carries its gradient as on
    the eager chain."""
    if color is not None:
        shs = None
    outs = PreprocessFunction.apply(
        xyz, scaling, rotation, opacity, shs,
        (w2v, full_proj, campos, width, height,
         None if color is None else color.detach(), sh_degree, alive,
         y_offset, full_height))
    return PreprocessOut(*outs[:9], color=(
        outs[9] if color is None else color.to(torch.float32)))


CULL_WINDOW = 64   # row-major tile offsets representable in the cull bitmask
CULL_ROWS = 8      # rect rows solved exactly; later rows keep all their tiles
_WORD = 1 << 32


def _mask_below(k: torch.Tensor):
    """64-bit mask of bits [0, k) as two words (int64 holding uint32 bits);
    k in [0, 64]."""
    one = torch.ones_like(k, dtype=torch.int64)
    lo = (one << torch.clamp(k, 0, 32).to(torch.int64)) - 1
    hi = (one << torch.clamp(k - 32, 0, 32).to(torch.int64)) - 1
    return lo, hi


def _mask_range(s: torch.Tensor, e: torch.Tensor):
    """64-bit mask of bits [s, e) (clamped to [0, 64]) as two words."""
    elo, ehi = _mask_below(torch.clamp(e, min=0))
    slo, shi = _mask_below(torch.clamp(s, min=0))
    return elo & ~slo, ehi & ~shi


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each word (int64 holding uint32 bits), int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def word_to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 bits in int64 → the int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - _WORD, x).to(torch.int32)


def word_of_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 → its uint32 bits in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def conic_cull_masks(T: torch.Tensor, xy: torch.Tensor,
                     opacity: torch.Tensor, rect_min: torch.Tensor,
                     rect_max: torch.Tensor, tiles_touched: torch.Tensor,
                     tile: int = TILE):
    """Exact conic-vs-tile pair culling over a 64-offset window (the JAX
    package's conic_cull_masks, same arithmetic in the same order).

    A (gaussian, tile) pair contributes iff some pixel of the tile reaches
    alpha >= 1/255, i.e. rho = min(rho3d, rho2d) <= thr = 2·ln(255·o). With
    p = x·A + y·B + C, rho3d <= thr is the conic Q(x, y) = p0² + p1² −
    thr·p2² <= 0; where it is an ellipse, its x-extent over a horizontal
    strip of pixels is a closed-form interval, and the rho2d region is a
    disk of radius sqrt(thr/2) around the low-pass center. Each of the
    first CULL_ROWS rect rows keeps only the tile columns either interval
    reaches; offsets past the CULL_WINDOW-bit mask, rows past CULL_ROWS and
    non-elliptic or non-finite gaussians keep every tile. Bounds are padded
    by 1 px and thr inflated 1e-4 relative, so rounding never culls a pair
    the blend's mask would keep: culling leaves the output unchanged.

    Returns (mask_lo, mask_hi, tiles_kept): [N] int32 words holding the
    JAX package's uint32 bits, and the kept-offset count per gaussian (0
    where tiles_touched is 0). Index data: no gradient."""
    f32 = torch.float32
    f64 = torch.float64
    pad = 1.0
    tile_f = float(tile)
    opa = torch.clamp(torch.reshape(opacity.detach(), (-1,)).to(f32),
                      1e-12, 1.0)
    thr = 2.0 * torch.log(255.0 * opa)
    thr = (thr * (1.0 + 1e-4) + 1e-4).to(f64)  # strictly more than the blend
    # the conic's coefficients in float64: at 1080p they are products of
    # T's ~1e3-pixel-scale entries, and the recentred constant term sums
    # ~1e12-sized terms that cancel, so in float32 its roots move by
    # whole tiles (JAX's float32 version culls 1,680 live pairs on
    # camera 0 of the 300k benchmark scene at 1920x1080)
    T = T.detach().to(f64)
    xy = xy.detach().to(f64)
    Tu, Tv, Tw = T[:, 0, :], T[:, 1, :], T[:, 2, :]
    A = torch.linalg.cross(Tv, Tw)
    B = torch.linalg.cross(Tw, Tu)
    C = torch.linalg.cross(Tu, Tv)
    qa = A[:, 0] * A[:, 0] + A[:, 1] * A[:, 1] - thr * (A[:, 2] * A[:, 2])
    qb = B[:, 0] * B[:, 0] + B[:, 1] * B[:, 1] - thr * (B[:, 2] * B[:, 2])
    qc = 2.0 * (A[:, 0] * B[:, 0] + A[:, 1] * B[:, 1]
                - thr * A[:, 2] * B[:, 2])
    qd = 2.0 * (A[:, 0] * C[:, 0] + A[:, 1] * C[:, 1]
                - thr * A[:, 2] * C[:, 2])
    qe = 2.0 * (B[:, 0] * C[:, 0] + B[:, 1] * C[:, 1]
                - thr * B[:, 2] * C[:, 2])
    qf = C[:, 0] * C[:, 0] + C[:, 1] * C[:, 1] - thr * (C[:, 2] * C[:, 2])
    # recentred on the low-pass center: root magnitudes ~ splat extent
    cx, cy = xy[:, 0], xy[:, 1]
    qd_l = 2.0 * qa * cx + qc * cy + qd
    qe_l = qc * cx + 2.0 * qb * cy + qe
    qf_l = (qa * cx + qc * cy + qd) * cx + (qb * cy + qe) * cy + qf
    det4 = 4.0 * qa * qb - qc * qc
    fin = (torch.isfinite(qa) & torch.isfinite(qb) & torch.isfinite(qc)
           & torch.isfinite(qd_l) & torch.isfinite(qe_l)
           & torch.isfinite(qf_l))
    ok_ell = fin & (qa > 0.0) & (qb > 0.0) & (det4 > 1e-9 * (4.0 * qa * qb))
    one = torch.ones_like(qa)
    qa_s = torch.where(qa > 0, qa, one)
    qb_s = torch.where(qb > 0, qb, one)
    inv2a = 0.5 / qa_s

    # the ellipse's global x-extremes (dQ/dy = 0 substituted)
    aa = det4 / (4.0 * qb_s)
    bb_g = qd_l - qc * qe_l / (2.0 * qb_s)
    cc_g = qf_l - qe_l * qe_l / (4.0 * qb_s)
    disc_g = bb_g * bb_g - 4.0 * aa * cc_g
    aa_s = torch.where(aa > 0, aa, one)
    ok_g = ok_ell & (disc_g >= 0.0) & (aa > 0.0)
    sq_g = torch.sqrt(torch.clamp(disc_g, min=0.0))
    xg_lo = (-bb_g - sq_g) / (2.0 * aa_s)
    xg_hi = (-bb_g + sq_g) / (2.0 * aa_s)
    yg_lo = -(qc * xg_lo + qe_l) / (2.0 * qb_s)
    yg_hi = -(qc * xg_hi + qe_l) / (2.0 * qb_s)

    r2d2 = torch.clamp(thr, min=0.0) / FILTER_INV_SQUARE  # disk radius²

    rmin_x = rect_min[:, 0].to(torch.int64)
    rw = torch.clamp(rect_max[:, 0] - rect_min[:, 0], min=1).to(torch.int64)
    rh = torch.clamp(rect_max[:, 1] - rect_min[:, 1], min=0).to(torch.int64)
    big = torch.full_like(qa, 3e38)

    def roots_at(yv):
        bb = qc * yv + qd_l
        cc = (qb * yv + qe_l) * yv + qf_l
        disc = bb * bb - 4.0 * qa * cc
        ok = ok_ell & (disc >= 0.0)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        return ok, (-bb - sq) * inv2a, (-bb + sq) * inv2a

    mlo = torch.zeros_like(rw)
    mhi = torch.zeros_like(rw)
    for dy in range(CULL_ROWS):
        ty = (rect_min[:, 1] + dy).to(f64)
        a0 = ty * tile_f - cy                  # local strip [a0, b0], pixels
        b0 = a0 + (tile_f - 1.0)
        a, b = a0 - pad, b0 + pad
        okA, loA, hiA = roots_at(a)
        okB, loB, hiB = roots_at(b)
        okGl = ok_g & (yg_lo >= a) & (yg_lo <= b)
        okGh = ok_g & (yg_hi >= a) & (yg_hi <= b)
        xlo_e = torch.minimum(torch.minimum(torch.where(okA, loA, big),
                                            torch.where(okB, loB, big)),
                              torch.where(okGl, xg_lo, big))
        xhi_e = torch.maximum(torch.maximum(torch.where(okA, hiA, -big),
                                            torch.where(okB, hiB, -big)),
                              torch.where(okGh, xg_hi, -big))
        dyd = torch.clamp(torch.maximum(a0, -b0), min=0.0)
        disk_ok = r2d2 >= dyd * dyd
        s_d = torch.sqrt(torch.clamp(r2d2 - dyd * dyd, min=0.0))
        xlo = torch.minimum(xlo_e, torch.where(disk_ok, -s_d, big)) - pad
        xhi = torch.maximum(xhi_e, torch.where(disk_ok, s_d, -big)) + pad
        empty = xlo > xhi
        clo = torch.floor(torch.clamp((xlo + cx) / tile_f, -1e9, 1e9)
                          ).to(torch.int64)
        chi = torch.floor(torch.clamp((xhi + cx) / tile_f, -1e9, 1e9)
                          ).to(torch.int64)
        dxlo = torch.minimum(torch.clamp(clo - rmin_x, min=0), rw)
        dxhi = torch.minimum(torch.clamp(chi + 1 - rmin_x, min=0), rw)
        row_on = (dy < rh) & ~empty & (dxhi > dxlo)
        base = dy * rw
        s_bit = torch.where(row_on, base + dxlo, 0)
        e_bit = torch.where(row_on, base + dxhi, 0)
        rlo, rhi = _mask_range(torch.clamp(s_bit, max=CULL_WINDOW),
                               torch.clamp(e_bit, max=CULL_WINDOW))
        mlo = mlo | rlo
        mhi = mhi | rhi

    # rows past CULL_ROWS keep all their in-window offsets
    s_late = torch.clamp(torch.clamp(rh, max=CULL_ROWS) * rw,
                         max=CULL_WINDOW)
    e_late = torch.clamp(rh * rw, max=CULL_WINDOW)
    llo, lhi = _mask_range(s_late, e_late)
    mlo = mlo | llo
    mhi = mhi | lhi

    # non-elliptic / non-finite gaussians keep everything
    alo, ahi = _mask_below(torch.clamp(rh * rw, max=CULL_WINDOW))
    mlo = torch.where(ok_ell, mlo, alo)
    mhi = torch.where(ok_ell, mhi, ahi)

    n_beyond = torch.clamp(rh * rw - CULL_WINDOW, min=0)
    kept = popcount32(mlo) + popcount32(mhi) + n_beyond
    tiles_kept = torch.where(tiles_touched > 0, kept, 0).to(torch.int32)
    return word_to_i32(mlo), word_to_i32(mhi), tiles_kept


def mark_visible(xyz: torch.Tensor, w2v: torch.Tensor) -> torch.Tensor:
    """Frustum visibility test: view z > 0.2."""
    p_view = fma_rows(xyz, w2v[:3, :3]) + w2v[:3, 3]
    return p_view[:, 2] > 0.2
