"""The plain reference of the render: preprocess, SH colour, binning, pack
and the blend, in plain PyTorch, in the dtype of its inputs.

Preprocess, SH, binning and pack are frozen copies of the program's plain
arithmetic at commit e06f678 (instascene_tpu_torch/ops/preprocess.py
`preprocess_gaussians` without conic culling or slabs, ops/sh.py
`sh_to_color`, ops/binning.py `bin_gaussians` without dilation,
ops/blend_visits.py `pack_flat_cols`). The blend is written anew, in the
reference's own form: each tile's depth-sorted slots against its 256 pixels
as one dense [tiles, 256, slots] block, transmittance by a cumulative
product, the done latch (T < 1e-4) by a cumulative count, so autograd
differentiates it; the program walks the slots one at a time (K1) and
differentiates by hand (K2). It keeps the program's blend semantics: a
slot takes part where its splat passes the mask (z != 0, ray depth >= the
near plane, rho within the level set, alpha >= 1/255), alpha is clamped at
0.99 and sx, sy at ±3e4 with the gradient passed straight through, as the
reference CUDA backward passes it.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

NEAR_N = 0.2
FAR_N = 100.0
FILTER_SIZE = 0.707106
FILTER_INV_SQUARE = 2.0
CUTOFF = 3.0
TILE = 16
P2 = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
T_DONE = 1e-4
MD_SCALE = FAR_N / (FAR_N - NEAR_N)
# the packed table's columns (the program's layout, which the
# counts of benchmark/counts.py read)
_TW, _XY, _NRM, _OPA, _COL, _EXT = 9, 12, 14, 17, 18, 21
# elements of one dense block, with and without autograd
BLOCK = 1 << 25
BLOCK_GRAD = 1 << 24

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def fma(a, b, c):
    """a·b + c rounded once (through float64), in a's dtype."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _sum3(a):
    return a[..., 0] + a[..., 1] + a[..., 2]


def cross(a, b):
    return torch.stack([fma(a[:, 1], b[:, 2], -(a[:, 2] * b[:, 1])),
                        fma(a[:, 2], b[:, 0], -(a[:, 0] * b[:, 2])),
                        fma(a[:, 0], b[:, 1], -(a[:, 1] * b[:, 0]))], dim=1)


def _rows(x, M):
    acc = x[:, 0:1] * M[None, :, 0]
    acc = fma(x[:, 1:2], M[None, :, 1], acc)
    return fma(x[:, 2:3], M[None, :, 2], acc)


def quat_to_rotmat(q):
    q = q * torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], dim=1)


def eval_sh3(sh, d):
    """Degree-3 SH colour, sh [N,16,3], unit directions d [N,3]."""
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    r = SH_C0 * sh[:, 0]
    r = r - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    r = (r + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
         + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
         + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    return (r + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
            + SH_C3[1] * xy * z * sh[:, 10]
            + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
            + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
            + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
            + SH_C3[5] * z * (xx - yy) * sh[:, 14]
            + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])


def sh_color(shs, xyz, campos):
    d = xyz - campos[None, :]
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                        min=1e-12)
    return torch.clamp(eval_sh3(shs, d) + 0.5, min=0.0)


class Pre(NamedTuple):
    T: torch.Tensor
    normal_view: torch.Tensor
    depth: torch.Tensor
    xy: torch.Tensor
    radius: torch.Tensor
    rect_min: torch.Tensor
    rect_max: torch.Tensor
    tiles_touched: torch.Tensor
    valid: torch.Tensor
    color: torch.Tensor


def _conic_box(t_vec, T, d_scale):
    Tw = T[:, 2, :]
    d = _sum3(t_vec * Tw * Tw)
    d_ok = (torch.abs(d) > 1e-7 * d_scale) & (d_scale > 0)
    f_vec = t_vec / torch.where(d_ok, d, torch.ones_like(d))[:, None]
    cx = torch.clamp(_sum3(f_vec * T[:, 0, :] * Tw), -1e7, 1e7)
    cy = torch.clamp(_sum3(f_vec * T[:, 1, :] * Tw), -1e7, 1e7)
    h0x = cx * cx - _sum3(f_vec * T[:, 0, :] * T[:, 0, :])
    h0y = cy * cy - _sum3(f_vec * T[:, 1, :] * T[:, 1, :])
    return d_ok, cx, cy, h0x, h0y


def preprocess(xyz, scaling, rotation, w2v, full_proj, campos, width: int,
               height: int, opacity, shs=None, color=None) -> Pre:
    """Splat→pixel transforms T [N,3,3], view normals, depths, the
    opacity-aware tile rects and the SH colour (degree 3)."""
    dt = xyz.dtype
    dev = xyz.device
    p_view = _rows(xyz, w2v[:3, :3]) + w2v[:3, 3]
    in_frustum = p_view[:, 2] > 0.2
    R = quat_to_rotmat(rotation)
    axis_u = R[:, :, 0] * scaling[:, 0:1]
    axis_v = R[:, :, 1] * scaling[:, 1:2]
    n2p = torch.tensor([[width / 2.0, 0, 0, (width - 1) / 2.0],
                        [0, height / 2.0, 0, (height - 1) / 2.0],
                        [0, 0, 0, 1.0]], dtype=dt, device=dev)
    n2p_full = n2p[:, 0:1] * full_proj[0:1]
    for k in range(1, 4):
        n2p_full = fma(n2p[:, k:k + 1], full_proj[k:k + 1], n2p_full)
    T = torch.stack([_rows(axis_u, n2p_full[:, :3]),
                     _rows(axis_v, n2p_full[:, :3]),
                     _rows(xyz, n2p_full[:, :3]) + n2p_full[:, 3]], dim=-1)
    normal_view = _rows(R[:, :, 2], w2v[:3, :3])
    cos = -_sum3(p_view * normal_view)
    normal_view = normal_view * torch.where(cos > 0, 1.0, -1.0).to(dt)[:, None]
    t_vec = torch.tensor([CUTOFF * CUTOFF, CUTOFF * CUTOFF, -1.0], dtype=dt,
                         device=dev)
    Tw = T[:, 2, :]
    d_scale = _sum3(torch.abs(t_vec) * Tw * Tw)
    d_ok, cx, cy, h0x, h0y = _conic_box(t_vec, T, d_scale)
    ext_x = torch.sqrt(torch.clamp(h0x, 1e-4, 1e14))
    ext_y = torch.sqrt(torch.clamp(h0y, 1e-4, 1e14))
    finite = (torch.isfinite(cx) & torch.isfinite(cy)
              & torch.isfinite(ext_x) & torch.isfinite(ext_y))
    zero = torch.zeros_like(cx)
    cx, cy = torch.where(finite, cx, zero), torch.where(finite, cy, zero)
    ext_x = torch.where(finite, ext_x, zero)
    ext_y = torch.where(finite, ext_y, zero)
    xy = torch.stack([cx, cy], dim=-1)
    radius = torch.ceil(torch.clamp(torch.maximum(ext_x, ext_y),
                                    min=CUTOFF * FILTER_SIZE))
    rx = torch.ceil(torch.clamp(ext_x, min=CUTOFF * FILTER_SIZE))
    ry = torch.ceil(torch.clamp(ext_y, min=CUTOFF * FILTER_SIZE))
    gx, gy = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    rmin_x = torch.clamp(torch.floor((xy[:, 0] - rx) / TILE), 0, gx)
    rmin_y = torch.clamp(torch.floor((xy[:, 1] - ry) / TILE), 0, gy)
    rmax_x = torch.clamp(torch.floor((xy[:, 0] + rx + TILE - 1) / TILE),
                         0, gx)
    rmax_y = torch.clamp(torch.floor((xy[:, 1] + ry + TILE - 1) / TILE),
                         0, gy)
    opa = torch.clamp(torch.reshape(opacity, (-1,)), 1e-12, 1.0)
    thr = torch.clamp(2.0 * torch.log(255.0 * opa), 0.72, CUTOFF * CUTOFF)
    t_thr = torch.stack([thr, thr, -torch.ones_like(thr)], -1)
    dt_ok, ctx, cty, h0x_t, h0y_t = _conic_box(t_thr, T, d_scale)
    ext_tx = torch.sqrt(torch.clamp(h0x_t, 1e-4, 1e14))
    ext_ty = torch.sqrt(torch.clamp(h0y_t, 1e-4, 1e14))
    ok_t = (dt_ok & torch.isfinite(ctx) & torch.isfinite(cty)
            & torch.isfinite(ext_tx) & torch.isfinite(ext_ty)
            & (thr < 8.99))
    r2d = torch.sqrt(thr / FILTER_INV_SQUARE)
    pad = 0.5
    lo_x = torch.minimum(ctx - ext_tx, xy[:, 0] - r2d) - pad
    hi_x = torch.maximum(ctx + ext_tx, xy[:, 0] + r2d) + pad
    lo_y = torch.minimum(cty - ext_ty, xy[:, 1] - r2d) - pad
    hi_y = torch.maximum(cty + ext_ty, xy[:, 1] + r2d) + pad
    cmin_x = torch.maximum(rmin_x, torch.clamp(torch.floor(lo_x / TILE),
                                               0, gx))
    cmin_y = torch.maximum(rmin_y, torch.clamp(torch.floor(lo_y / TILE),
                                               0, gy))
    cmax_x = torch.minimum(rmax_x, torch.clamp(torch.floor(hi_x / TILE) + 1,
                                               0, gx))
    cmax_y = torch.minimum(rmax_y, torch.clamp(torch.floor(hi_y / TILE) + 1,
                                               0, gy))
    rect_min = torch.stack([torch.where(ok_t, cmin_x, rmin_x),
                            torch.where(ok_t, cmin_y, rmin_y)],
                           dim=-1).to(torch.int32)
    rect_max = torch.stack(
        [torch.where(ok_t, torch.maximum(cmax_x, cmin_x), rmax_x),
         torch.where(ok_t, torch.maximum(cmax_y, cmin_y), rmax_y)],
        dim=-1).to(torch.int32)
    tiles = ((rect_max[:, 0] - rect_min[:, 0])
             * (rect_max[:, 1] - rect_min[:, 1]))
    tiles9 = (rmax_x - rmin_x) * (rmax_y - rmin_y)
    valid = in_frustum & d_ok & finite & (tiles9 > 0)
    if color is None:
        color = sh_color(shs, xyz, campos)
    return Pre(T, normal_view, p_view[:, 2], xy,
               torch.where(valid, radius, 0.0), rect_min, rect_max,
               torch.where(valid, tiles, 0).to(torch.int32), valid, color)


class Bins(NamedTuple):
    sorted_gid: torch.Tensor     # [pairs] int64
    tile_start: torch.Tensor     # [tiles] int64
    tile_end: torch.Tensor
    total_pairs: int


def depth_bits_for(grid_x: int, grid_y: int) -> int:
    tile_bits = max(int(math.ceil(math.log2(grid_x * grid_y + 2))), 1)
    return min(22, 31 - tile_bits)


def bin_pairs(pre: Pre, width: int, height: int) -> Bins:
    """(gaussian, tile) pairs sorted by tile, then by quantised depth, then
    by gaussian id."""
    dev = pre.depth.device
    gx, gy = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    nt = gx * gy
    n = pre.depth.shape[0]
    counts = pre.tiles_touched.to(torch.int64)
    total = int(counts.sum())
    if total == 0:
        z = torch.zeros(nt, dtype=torch.int64, device=dev)
        return Bins(z[:0], z, z.clone(), 0)
    bits = depth_bits_for(gx, gy)
    depth = pre.depth.detach().float()
    g_valid = counts > 0
    inf = torch.tensor(float("inf"), device=dev)
    dmin = torch.min(torch.where(g_valid, depth, inf))
    dmax = torch.max(torch.where(g_valid, depth, -inf))
    dq = torch.clamp((depth - dmin) / torch.clamp(dmax - dmin, min=1e-12),
                     0.0, 1.0)
    dq = torch.clamp((dq * float((1 << bits) - 1)).to(torch.int32), 0,
                     (1 << bits) - 1)
    offsets = torch.cumsum(counts, 0) - counts
    gid = torch.repeat_interleave(torch.arange(n, device=dev), counts,
                                  output_size=total)
    rank = torch.arange(total, device=dev) - offsets[gid]
    rmin = pre.rect_min.to(torch.int64)[gid]
    rw = torch.clamp(pre.rect_max[:, 0] - pre.rect_min[:, 0],
                     min=1).to(torch.int64)[gid]
    dy = rank // rw
    tile = (rmin[:, 1] + dy) * gx + (rmin[:, 0] + rank - dy * rw)
    key = tile * (1 << bits) + dq.to(torch.int64)[gid]
    skey, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(skey >> bits, torch.arange(
        nt + 1, dtype=torch.int64, device=dev), side="left")
    return Bins(gid[order], bounds[:-1], bounds[1:], total)


def pack(T, xy, normal_view, opacity, color, extras=None):
    """The per-gaussian table [N, 21+E]: A = Tv×Tw, B = Tw×Tu, C = Tu×Tv,
    Tw, xy, view normal, opacity, colour, the E feature channels."""
    Tu, Tv, Tw = T[:, 0], T[:, 1], T[:, 2]
    cols = [cross(Tv, Tw), cross(Tw, Tu), cross(Tu, Tv), Tw, xy,
            normal_view, opacity.reshape(-1, 1), color]
    if extras is not None:
        cols.append(extras)
    return torch.cat(cols, dim=1)


def _straight(x, lo=None, hi=None):
    """x clamped, with the gradient of x itself."""
    return x + (torch.clamp(x, lo, hi) - x).detach()


def tile_blocks(bins: Bins, budget: int):
    """The tiles in blocks of similar slot counts: (tile ids, longest
    range) per block, each block's tiles × 256 × longest range at most
    `budget` elements (a longer tile alone makes its own block)."""
    n = (bins.tile_end - bins.tile_start)
    order = torch.argsort(n, descending=True).tolist()
    lens = n[order].tolist() if len(order) else []
    blocks, i = [], 0
    while i < len(order) and lens[i] > 0:
        L = lens[i]
        k = max(1, budget // (P2 * L))
        blocks.append((order[i:i + k], L))
        i += k
    return blocks


def blend_block(flat, bins: Bins, tiles, L: int, grid_x: int,
                need_dist: bool, pixels=None):
    """The blend of the listed tiles (python list) with range length <= L:
    per pixel (all 256 of each tile, or the within-tile indices `pixels`
    [tiles, P]) and slot: the weights w [B,P,L], the slots' gaussian ids
    [B,L], and the per-pixel outputs: colour, normal, features, depth sum,
    distortion, median depth, final T, n_contrib, and the work counts
    (slots evaluated until the pixel latches done, contributions)."""
    dev = flat.device
    dt = flat.dtype
    tl = torch.as_tensor(tiles, dtype=torch.int64, device=dev)
    start = bins.tile_start[tl]
    cnt = bins.tile_end[tl] - start
    k = torch.arange(L, device=dev)
    slot_ok = k[None, :] < cnt[:, None]                       # [B,L]
    pos = torch.clamp(start[:, None] + k[None, :], max=max(
        bins.total_pairs - 1, 0))
    gid = torch.where(slot_ok, bins.sorted_gid[pos], 0)
    g = flat[gid]                                             # [B,L,D]
    pix = (torch.arange(P2, device=dev)[None].expand(len(tiles), P2)
           if pixels is None else pixels.to(torch.int64))
    X = ((tl % grid_x) * TILE)[:, None] + pix % TILE
    Y = ((tl // grid_x) * TILE)[:, None] + pix // TILE
    X = X.to(dt)[:, :, None]                                  # [B,P,1]
    Y = Y.to(dt)[:, :, None]
    gc = lambda c: g[:, None, :, c]                           # [B,1,L]
    px = fma(X, gc(0), Y * gc(3)) + gc(6)
    py = fma(X, gc(1), Y * gc(4)) + gc(7)
    pz = fma(X, gc(2), Y * gc(5)) + gc(8)
    pz_ok = pz != 0.0
    inv_pz = 1.0 / torch.where(pz_ok, pz, 1.0)
    sx = _straight(px * inv_pz, -3e4, 3e4)
    sy = _straight(py * inv_pz, -3e4, 3e4)
    rho3d = sx * sx + sy * sy
    dx = gc(_XY) - X
    dy = gc(_XY + 1) - Y
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    use3d = rho3d <= rho2d
    rho = torch.where(use3d, rho3d, rho2d)
    depth_ray = torch.where(use3d, sx * gc(_TW) + sy * gc(_TW + 1)
                            + gc(_TW + 2), gc(_TW + 2))
    power = -0.5 * rho
    alpha = _straight(gc(_OPA) * torch.exp(power), None, 0.99)
    m = (pz_ok & (depth_ray >= NEAR_N) & (power <= 0.0)
         & (alpha >= ALPHA_MIN) & slot_ok[:, None, :])
    a_live = torch.where(m, alpha, 0.0)
    T_test = torch.cumprod(1.0 - a_live, dim=-1)
    done_at = m & (T_test < T_DONE)
    before_done = torch.cumsum(done_at.to(torch.int32), dim=-1) == 0
    contrib = m & before_done
    a_c = torch.where(contrib, alpha, 0.0)
    T_incl = torch.cumprod(1.0 - a_c, dim=-1)
    T_excl = torch.cat([torch.ones_like(T_incl[..., :1]),
                        T_incl[..., :-1]], dim=-1)
    w = a_c * T_excl
    out = {"w": w, "gid": gid, "contrib": contrib,
           "final_T": T_incl[..., -1]}
    wsum = lambda c0, c1: torch.einsum("bpl,bld->bpd", w, g[:, :, c0:c1])
    out["color"] = wsum(_COL, _COL + 3)
    out["normal"] = wsum(_NRM, _NRM + 3)
    E = flat.shape[1] - _EXT
    out["extra"] = wsum(_EXT, _EXT + E) if E else None
    ks = (k + 1)[None, None, :]
    out["n_contrib"] = torch.amax(torch.where(contrib, ks, 0), dim=-1)
    cand = contrib & (T_excl > 0.5)
    med_k = torch.amax(torch.where(cand, ks, 0), dim=-1)       # 1-based
    med = torch.gather(depth_ray, 2, (med_k - 1).clamp(min=0)[..., None])
    out["median_depth"] = torch.where(med_k > 0, med[..., 0], 0.0)
    if need_dist:
        out["depth"] = (w * depth_ray).sum(-1)
        d_safe = torch.where(contrib, depth_ray, 1.0)
        md = MD_SCALE * (1.0 - NEAR_N / d_safe)
        mw = md * w
        M1 = torch.cumsum(mw, -1) - mw
        M2 = torch.cumsum(md * mw, -1) - md * mw
        out["distortion"] = (w * (md * md * (1.0 - T_excl) + M2
                                  - 2.0 * md * M1)).sum(-1)
    # work: slots walked until the latch (the latching slot included)
    first_done = torch.where(done_at.any(-1), torch.argmax(
        done_at.to(torch.int32), dim=-1) + 1, cnt[:, None])
    out["n_eval"] = first_done
    out["n_hit"] = contrib.sum(-1)
    out["n_slots"] = int(contrib.any(1).sum())
    return out


MAP_KEYS = ("color", "normal", "extra", "depth", "distortion",
            "median_depth", "final_T", "n_contrib", "n_eval", "n_hit")


def blend_maps(flat, bins: Bins, width: int, height: int, need_dist: bool,
               grad_maps=None):
    """The whole frame's per-pixel outputs as [H, W, ·] maps (dict of
    MAP_KEYS present, and "n_slots": the slots some pixel contributes
    through). With grad_maps (dict key → [H, W, ·] cotangent), also
    returns d(Σ maps · grad_maps)/d(flat) [N, D], block by block."""
    dev = flat.device
    gx, gy = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    nt = gx * gy
    E = flat.shape[1] - _EXT
    widths = {"color": 3, "normal": 3, "extra": E, "depth": 1,
              "distortion": 1, "median_depth": 1, "final_T": 1,
              "n_contrib": 1, "n_eval": 1, "n_hit": 1}
    keys = [k for k in MAP_KEYS if widths[k] and (
        need_dist or k not in ("depth", "distortion"))]
    tiles = {k: torch.zeros((nt, P2, widths[k]), device=dev,
                            dtype=torch.int64 if k.startswith("n_")
                            else flat.dtype) for k in keys}
    tiles["final_T"].fill_(1.0)
    dflat = None
    leaf = flat.detach()
    if grad_maps is not None:
        leaf = leaf.clone().requires_grad_(True)
        gtiles = {k: map_to_tiles(v, width, height) for k, v in
                  grad_maps.items()}
    budget = BLOCK if grad_maps is None else BLOCK_GRAD
    n_slots = 0
    for tl, L in tile_blocks(bins, budget):
        idx = torch.as_tensor(tl, device=dev)
        with torch.set_grad_enabled(grad_maps is not None):
            o = blend_block(leaf, bins, tl, L, gx, need_dist)
            for k in keys:
                v = o[k]
                tiles[k][idx] = (v if v.dim() == 3 else v[..., None]).detach(
                    ).to(tiles[k].dtype)
            if grad_maps is not None:
                s = sum((o[k] if o[k].dim() == 3 else o[k][..., None]).mul(
                    gtiles[k][idx]).sum() for k in gtiles)
                s.backward()
        n_slots += o["n_slots"]
        del o
    if grad_maps is not None:
        dflat = leaf.grad
    maps = {k: tiles_to_map(v, width, height) for k, v in tiles.items()}
    maps["n_slots"] = n_slots
    return maps, dflat


def tiles_to_map(x, width: int, height: int):
    """[tiles, 256, C] → [H, W, C]."""
    gx, gy = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    c = x.shape[-1]
    x = x.reshape(gy, gx, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return x.reshape(gy * TILE, gx * TILE, c)[:height, :width]


def map_to_tiles(m, width: int, height: int):
    """[H, W, C] → [tiles, 256, C], zero beyond the image's edge."""
    gx, gy = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    c = m.shape[-1]
    full = m.new_zeros((gy * TILE, gx * TILE, c))
    full[:height, :width] = m
    return full.reshape(gy, TILE, gx, TILE, c).permute(0, 2, 1, 3, 4
                                                       ).reshape(-1, P2, c)


def activated(p: dict):
    """The model's activated attributes from its raw fields."""
    rot = p["rotation"]
    return dict(
        scaling=torch.exp(p["scaling"]),
        opacity=torch.sigmoid(p["opacity"])[:, 0],
        rotation=rot * torch.rsqrt(torch.sum(rot * rot, dim=-1,
                                             keepdim=True) + 1e-24),
        shs=torch.cat([p["features_dc"], p["features_rest"]], dim=1))


def normed(f, eps: float = 1e-6):
    return f / (torch.linalg.norm(f, dim=1, keepdim=True) + eps)
