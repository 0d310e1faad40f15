"""The blend: pack, the forward kernel K1, the backward kernel K2, the
per-gaussian reduction, their plain PyTorch versions and the autograd
Function that joins them.

Port of instascene_tpu/ops/blend_pallas.py:51-89 (`pack_flat_cols`),
:150-182 (`_splat_terms`) and instascene_tpu/ops/blend_visits.py:62-392
(`_fwd_kernel_visits`, the TPU kernel K1, in its `full`, `viewer`,
`no_dist`, `extras_only` (with the sampled-pixel done0 mask), `track`,
`clip_rect` and `tiles_per_view` modes), :395-607 (`_bwd_kernel_visits`,
the TPU kernel K2, in its `full`, `no_dist`, `extras_only`, `clip_rect`
and `tiles_per_view` modes), :612-751 (`blend_visits_track` and the custom
VJP with its per-gaussian scatter-add), and instascene_tpu/ops/blend_pallas.py:546-1083
(`_fwd_kernel_aligned` and `_bwd_kernel_aligned`, the TPU kernels K3 and
K4, with `blend_aligned_diff`, over a tile-subset mini bundle). The
kernels are csrc/blend_fwd.cu and csrc/blend_bwd.cu (CUDA C++ for sm_90a,
the walk in csrc/blend_walk.cuh): K3 and K4 are K1 and K2 given an
explicit tile list, in every mode but track. Their headers say what
bounds them on the H100 and how the design answers that. K1's and K2's
clip_rect mode (blend_visits.py:145-149, :458, :548) is a flag beside
full, viewer, no_dist and extras_only: flat then carries 4 trailing rect
columns (pack_flat_cols(rect=)) and a pair contributes only where its tile
lies in its gaussian's rect. The kernels take any feature width
0 <= E <= MAX_E (0 and 16 compiled as constants).

The TPU layout machinery (pair caps, the (chunk, tile) visit list and its
SMEM budget) is gone: the inputs are the per-gaussian packed table `flat`
[N, 21+E], the depth-sorted pair list `sorted_gid` [pairs] and the per-tile
ranges [tile_start, tile_end). Outputs keep K1's public layout:
out [num_tiles, 12+E, 256] f32 and iout [num_tiles, 2, 256] i32
(rows listed in csrc/blend_fwd.cu).

`blend_fwd`, `blend_bwd` and `reduce_per_gaussian` launch their kernels for
CUDA tensors (or raise) and run the plain versions for CPU tensors; each
adds one to its entry of `LAUNCHES` (by kernel and mode) where it launches.
`blend` is the differentiable entry (`BlendFunction`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_build
from .preprocess import FAR_N, FILTER_INV_SQUARE, NEAR_N, TILE, cross, fma

P2 = TILE * TILE
_TW, _XY, _NRM, _OPA, _COL, _EXT = 9, 12, 14, 17, 18, 21
MD_SCALE = FAR_N / (FAR_N - NEAR_N)
DMD_DD = FAR_N * NEAR_N / (FAR_N - NEAR_N)   # d(md)/d(depth) · depth²
ALPHA_MIN = 1.0 / 255.0
T_DONE = 1e-4
MAX_E = 256         # the widest feature width the kernels take
RECT = 4            # clip_rect's trailing rect columns
# K1's and K2's modes; their C entries take the index
MODES = ("full", "viewer", "no_dist", "extras_only", "track")
BWD_MODES = ("full", "no_dist", "extras_only")
TRACK_K = 10        # contributor slots per pixel (track mode)
TRACK_W = 0.1       # a contribution is tracked when its weight exceeds this


def _launch_keys():
    """K1/K2 by mode; K3/K4 (K1/K2 over a tile list) in every mode but
    track; a " clip_rect" twin of each mode that takes it; the merged
    multi-view mode; K5/K6 the sparse-pixel kernels (ops/blend_sparse.py),
    K7/K8 the padded-layout kernels (ops/blend_padded.py), the segment sum,
    and "sparse_fallback", the semantic steps that took the dense path on
    a slot overflow."""
    fwd = MODES[:4]
    keys = [f"K1 {m}" for m in MODES] + [f"K2 {m}" for m in BWD_MODES]
    keys += [f"K3 {m}" for m in fwd] + [f"K4 {m}" for m in BWD_MODES]
    keys += [f"{k} {m} clip_rect" for k in ("K1", "K3") for m in fwd]
    keys += [f"{k} {m} clip_rect" for k in ("K2", "K4") for m in BWD_MODES]
    return keys + ["K1 tiles_per_view", "K2 tiles_per_view", "K5", "K6",
                   "K7", "K8", "segment_sum", "sparse_fallback"]


# kernel launches, by kernel and mode (the plain versions launch nothing)
LAUNCHES = dict.fromkeys(_launch_keys(), 0)


def pack_flat_cols(T_used, xy, normal_view, opacities, color, extras=None,
                   rect=None):
    """Per-gaussian packed attribute table [N, 21+E]: affine ray
    coefficients A = Tv×Tw, B = Tw×Tu, C = Tu×Tv (so the ray-splat
    intersection is p = x·A + y·B + C), Tw, xy, view normal, opacity,
    color, E extra channels. Differentiable.

    rect = (rect_min, rect_max) [N, 2] int (clip_rect mode): 4 trailing
    columns rmin_x, rmax_x, rmin_y, rmax_y as f32 (exact small integers),
    without gradient: the kernels gate each pair by tile ∈ rect."""
    n = xy.shape[0]
    T = torch.reshape(T_used, (n, 3, 3))
    Tu, Tv, Tw = T[:, 0], T[:, 1], T[:, 2]
    cols = [cross(Tv, Tw), cross(Tw, Tu), cross(Tu, Tv), Tw, xy,
            normal_view, torch.reshape(opacities, (n, 1)), color]
    if extras is not None:
        cols.append(extras)
    if rect is not None:
        rmin, rmax = rect
        cols.append(torch.stack([rmin[:, 0], rmax[:, 0], rmin[:, 1],
                                 rmax[:, 1]], dim=1).detach().to(
                                     torch.float32))
    return torch.cat(cols, dim=1).to(torch.float32).contiguous()


def _splat(g, X, Y):
    """The splat terms of packed rows g [na, D, 1] at pixels X, Y [na, 256],
    with the kernels' arithmetic (p's x·A term fused, fma(x, A, y·B) + C, as
    the kernels and XLA round it; every other product and sum rounded
    alone). Both kernels evaluate this; K2 must reproduce K1's mask `m` to
    the bit."""
    px_ = fma(X, g[:, 0], Y * g[:, 3]) + g[:, 6]
    py_ = fma(X, g[:, 1], Y * g[:, 4]) + g[:, 7]
    pz_ = fma(X, g[:, 2], Y * g[:, 5]) + g[:, 8]
    pz_ok = pz_ != 0.0
    inv_pz = 1.0 / torch.where(pz_ok, pz_, 1.0)
    sx = torch.clamp(px_ * inv_pz, -3e4, 3e4)
    sy = torch.clamp(py_ * inv_pz, -3e4, 3e4)
    rho3d = sx * sx + sy * sy
    dx = g[:, _XY] - X
    dy = g[:, _XY + 1] - Y
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    use3d = rho3d <= rho2d
    rho = torch.where(use3d, rho3d, rho2d)
    depth_ray = torch.where(
        use3d, sx * g[:, _TW] + sy * g[:, _TW + 1] + g[:, _TW + 2],
        g[:, _TW + 2])
    power = -0.5 * rho
    G = torch.exp(power)
    alpha = torch.clamp(g[:, _OPA] * G, max=0.99)
    m = pz_ok & (depth_ray >= NEAR_N) & (power <= 0.0) & (alpha >= ALPHA_MIN)
    return dict(alpha=alpha, m=m, depth_ray=depth_ray, use3d=use3d, sx=sx,
                sy=sy, inv_pz=inv_pz, G=G, dx=dx, dy=dy)


def _in_rect(g, tiles, tiles_per_view, grid_x):
    """clip_rect's gate [na, 1]: the tile of each row lies in the rect of
    the packed rows g [na, D, 1] (their 4 trailing columns)."""
    tl = tiles % tiles_per_view if tiles_per_view else tiles
    tx = (tl % grid_x).to(torch.float32)[:, None]
    ty = (tl // grid_x).to(torch.float32)[:, None]
    return ((g[:, -4] <= tx) & (tx < g[:, -3])
            & (g[:, -2] <= ty) & (ty < g[:, -1]))


def _walk_order(tile_start, tile_end, grid_x, tile_ids=None,
                tiles_per_view=0, pixels=None):
    """The rows the plain versions walk — one per tile, or per listed tile
    (tile_ids) — longest-first, so step k touches only the first `na`
    rows, those with a slot k. Returns (order, their tiles, their first
    slots, the longest range, n_at(k), pixel x and y [rows, P]): the
    pixels are a tile's 256, or per row the within-tile indices `pixels`
    [rows, P]; with tiles_per_view the coordinates come from the view-local
    tile t % tiles_per_view."""
    dev = tile_start.device
    tiles = (torch.arange(tile_start.shape[0], device=dev)
             if tile_ids is None else tile_ids.to(torch.int64))
    counts = (tile_end - tile_start).to(torch.int64)[tiles]
    order = torch.argsort(counts, descending=True, stable=True)
    tiles = tiles[order]
    start = tile_start.to(torch.int64)[tiles]
    asc = counts[order].cpu().numpy()[::-1]
    tl = tiles % tiles_per_view if tiles_per_view else tiles
    pix = (torch.arange(P2, device=dev)[None] if pixels is None
           else pixels.to(torch.int64)[order])
    pxf = ((tl % grid_x) * TILE)[:, None].to(torch.float32) \
        + (pix % TILE).to(torch.float32)
    pyf = ((tl // grid_x) * TILE)[:, None].to(torch.float32) \
        + (pix // TILE).to(torch.float32)
    n_at = lambda k: order.shape[0] - int(np.searchsorted(asc, k,
                                                           side="right"))
    return (order, tiles, start, int(asc[-1]) if len(asc) else 0, n_at,
            pxf, pyf)


def blend_fwd_reference(flat, sorted_gid, tile_start, tile_end, grid_x: int,
                        n_extra: int, viewer: bool = False,
                        count_work: bool = False, no_dist: bool = False,
                        extras_only: bool = False, done0=None,
                        track: bool = False, tile_ids=None,
                        tiles_per_view: int = 0, pixels=None,
                        clip_rect: bool = False):
    """The plain PyTorch version of K1 (and K3): vectorised over tiles ×
    pixels, looping over the within-tile slot index in the kernel's order
    with the kernel's arithmetic (see _splat).

    no_dist: the depth sum, the distortion and the m1/m2 totals are skipped
    and their rows (3, 8, 10+E, 11+E) are exact zeros; every other row and
    iout are as `full` computes them. viewer: only color, final T, features
    and n_contrib are computed. extras_only: only final T, the features and
    n_contrib; done0 [T, 1, 256] (or [T, 256]) int, extras_only only,
    pre-latches every pixel where it is non-zero (T = 1, zero features,
    n_contrib 0). track: `full` plus the contributor buffer, returned after
    iout as ids [T, TRACK_K, 256] int32 (-1 empty) and w [T, TRACK_K, 256]
    f32 (0 empty): each contribution with w > TRACK_W, in blend order, while
    slots are free.

    tile_ids [K] int (K3): only the listed tiles are walked, and out/iout
    (and the other per-tile results) have one row per listed tile, in list
    order; done0 stays indexed by tile. tiles_per_view: the merged
    multi-view mode, pixel coordinates from t % tiles_per_view (see
    csrc/blend_fwd.cu). pixels [rows, P] int (extras_only; the sparse plain
    version): each row evaluates only these within-tile pixels (done0 is
    then [rows, P]), and the per-pixel axis has P entries. clip_rect: flat
    has 4 trailing rect columns and a slot contributes only where its tile
    lies in the rect (not with track).

    count_work=True also returns the work these inputs need, per pixel
    [T, 256] int32: the slots it must evaluate (up to and including the one
    that latches it done, else its tile's whole range; with clip_rect only
    those its rect gate lets through) and its contributions."""
    dev = flat.device
    E = n_extra
    OC = 12 + E
    f32 = torch.float32
    if done0 is not None and not extras_only:
        raise ValueError("done0 masks serve the extras_only mode only")
    color = not extras_only
    aux = not (viewer or extras_only)
    dist = aux and not no_dist
    order, tiles, start, max_count, n_at, pxf, pyf = _walk_order(
        tile_start, tile_end, grid_x, tile_ids, tiles_per_view, pixels)
    nt, npx = pxf.shape

    T = torch.ones((nt, npx), dtype=f32, device=dev)
    if done0 is None:
        done = torch.zeros((nt, npx), dtype=torch.bool, device=dev)
    elif pixels is None:
        done = done0.reshape(tile_start.shape[0], npx)[tiles] != 0
    else:
        done = done0.reshape(nt, npx)[order] != 0
    acc = torch.zeros((nt, OC, npx), dtype=f32, device=dev)
    last = torch.zeros((nt, npx), dtype=torch.int32, device=dev)
    med_slot = torch.zeros((nt, npx), dtype=torch.int32, device=dev)
    n_eval = torch.zeros((nt, npx), dtype=torch.int32, device=dev)
    n_hit = torch.zeros((nt, npx), dtype=torch.int32, device=dev)
    if track:
        ids = torch.full((nt, TRACK_K, npx), -1, dtype=torch.int32,
                         device=dev)
        tw = torch.zeros((nt, TRACK_K, npx), dtype=f32, device=dev)
        n_track = torch.zeros((nt, npx), dtype=torch.int32, device=dev)
    gid_l = sorted_gid.to(torch.int64)

    for k in range(max_count):
        na = n_at(k)
        gk = gid_l[start[:na] + k]
        g = flat[gk][:, :, None]                           # [na, D, 1]
        s = _splat(g, pxf[:na], pyf[:na])
        alpha, depth_ray = s["alpha"], s["depth_ray"]
        Tk = T[:na]
        walking = ~done[:na]
        live = s["m"] & walking
        if clip_rect:
            gate = _in_rect(g, tiles[:na], tiles_per_view, grid_x)
            live = live & gate
        test_T = Tk * (1.0 - alpha)
        newly = live & (test_T < T_DONE)
        done[:na] |= newly
        contrib = live & ~newly
        w = torch.where(contrib, alpha * Tk, 0.0)
        wc = w[:, None]
        a = acc[:na]
        if color:
            a[:, 0:3] = a[:, 0:3] + wc * g[:, _COL:_COL + 3]
        if E:
            a[:, 10:10 + E] = a[:, 10:10 + E] + wc * g[:, _EXT:_EXT + E]
        if aux:
            a[:, 4:7] = a[:, 4:7] + wc * g[:, _NRM:_NRM + 3]
            if dist:
                a[:, 3] = a[:, 3] + w * depth_ray
                d_safe = torch.where(contrib, depth_ray, 1.0)
                md = MD_SCALE * (1.0 - NEAR_N / d_safe)
                A = 1.0 - Tk
                M1 = a[:, 10 + E]
                M2 = a[:, 11 + E]
                a[:, 8] = a[:, 8] + w * (md * md * A + M2 - 2.0 * md * M1)
                a[:, 10 + E] = M1 + md * w
                a[:, 11 + E] = M2 + md * md * w
            cand = contrib & (Tk > 0.5)
            a[:, 7] = torch.where(cand, depth_ray, a[:, 7])
            med_slot[:na] = torch.where(cand, k + 1, med_slot[:na])
        if track:
            big = contrib & (w > TRACK_W)
            cnt = n_track[:na]
            for slot in range(TRACK_K):
                sel = big & (cnt == slot)
                ids[:na, slot] = torch.where(sel, gk[:, None].to(torch.int32),
                                             ids[:na, slot])
                tw[:na, slot] = torch.where(sel, w, tw[:na, slot])
            n_track[:na] = torch.clamp(cnt + big.to(torch.int32),
                                       max=TRACK_K)
        last[:na] = torch.where(contrib, k + 1, last[:na])
        T[:na] = torch.where(contrib, test_T, Tk)
        if count_work:
            # a gated slot (clip_rect) needs its rect test, not the splat
            n_eval[:na] += walking & gate if clip_rect else walking
            n_hit[:na] += contrib

    acc[:, 9] = T
    out = torch.empty_like(acc)
    out[order] = acc
    iout = torch.empty((nt, 2, npx), dtype=torch.int32, device=dev)
    iout[order] = torch.stack([last, med_slot], dim=1)
    res = (out, iout)
    if track:
        ids_out = torch.empty_like(ids)
        ids_out[order] = ids
        tw_out = torch.empty_like(tw)
        tw_out[order] = tw
        res += (ids_out, tw_out)
    if not count_work:
        return res
    work = torch.empty((nt, 2, npx), dtype=torch.int32, device=dev)
    work[order] = torch.stack([n_eval, n_hit], dim=1)
    return res + (work[:, 0], work[:, 1])


def blend_bwd_reference(flat, sorted_gid, tile_start, tile_end, grid_x: int,
                        n_extra: int, gout, saved, iout,
                        no_dist: bool = False, count_work: bool = False,
                        extras_only: bool = False, tile_ids=None,
                        tiles_per_view: int = 0, pixels=None,
                        clip_rect: bool = False):
    """The plain PyTorch version of K2 (and K4): per-slot gradients d_sorted
    [pairs, 21+E] of Σ gout·out with respect to each slot's packed row
    (extras_only: [pairs, E], the feature columns alone, w · gout[10+e]
    summed over the tile's pixels).

    gout [T, 12+E, 256] is the cotangent of K1's out; saved [T, 3, 256]
    holds out's final T, m1 and m2 rows; iout is K1's (n_contrib,
    med_slot). Vectorised over tiles × pixels, the slot index walks back to
    front from each tile's end with the kernel's arithmetic and order: a
    slot takes part where its splat passes K1's mask and it is at or before
    the pixel's n_contrib; T before it is recovered as T_after / (1 − α);
    the suffix sum S of dL/dw·w over later slots carries the transmittance
    chain. A slot's row is its contributions summed over its tile's 256
    pixels (each slot belongs to one tile). tile_ids, tiles_per_view and
    pixels as in blend_fwd_reference: gout, saved and iout then have one
    row per listed tile (and P pixels), and the rows of the slots of
    unlisted tiles are zero. clip_rect: flat's 4 trailing rect columns gate
    each slot as in K1, and the rows carry 4 zero columns for them (not in
    extras_only).

    count_work=True also returns (evaluations, contributions, slots reduced)
    these inputs need: each pixel evaluates its slots 1..n_contrib (with
    clip_rect those its rect gate lets through), and a slot is reduced
    when some pixel of its tile is at or before its n_contrib there."""
    dev = flat.device
    E = n_extra
    D = E if extras_only else 21 + E + (RECT if clip_rect else 0)
    f32 = torch.float32
    order, tiles, start, max_count, n_at, pxf, pyf = _walk_order(
        tile_start, tile_end, grid_x, tile_ids, tiles_per_view, pixels)
    go = gout[order]
    sv = saved[order]
    T_fin, m1tot, m2tot = sv[:, 0], sv[:, 1], sv[:, 2]
    a_fin = 1.0 - T_fin
    n_contrib, med = iout[order, 0], iout[order, 1]
    gcol, gD, gnrm = go[:, 0:3], go[:, 3], go[:, 4:7]
    gmed, gdist, gTfin = go[:, 7], go[:, 8], go[:, 9]
    gext = go[:, 10:10 + E]
    Tfin_g = gTfin * T_fin

    T = T_fin.clone()
    S = torch.zeros_like(T)
    d_sorted = torch.zeros((sorted_gid.shape[0], D), dtype=f32, device=dev)
    gid_l = sorted_gid.to(torch.int64)
    n_hits = n_slots = n_evals = 0
    for k in range(max_count - 1, -1, -1):
        na = n_at(k)
        g = flat[gid_l[start[:na] + k]][:, :, None]        # [na, D, 1]
        X, Y = pxf[:na], pyf[:na]
        s = _splat(g, X, Y)
        alpha, depth_ray, G = s["alpha"], s["depth_ray"], s["G"]
        cm = s["m"] & (k + 1 <= n_contrib[:na])
        if clip_rect:
            gate = _in_rect(g, tiles[:na], tiles_per_view, grid_x)
            cm = cm & gate
            if count_work:
                n_evals += int(((k + 1 <= n_contrib[:na]) & gate).sum())
        one_minus = torch.where(cm, 1.0 - alpha, 1.0)
        Ta = T[:na]
        Ti = Ta / one_minus
        w = torch.where(cm, alpha * Ti, 0.0)
        if extras_only:
            d_sorted[start[:na] + k] = torch.stack(
                [w * gext[:na, e] for e in range(E)], dim=1).sum(dim=2)
            T[:na] = torch.where(cm, Ti, Ta)
            if count_work:
                n_hits += int(cm.sum())
                n_slots += int(cm.any(dim=1).sum())
            continue
        dLdw = g[:, _NRM] * gnrm[:na, 0]
        for c, gc in ((_NRM + 1, gnrm[:na, 1]), (_NRM + 2, gnrm[:na, 2]),
                      (_COL, gcol[:na, 0]), (_COL + 1, gcol[:na, 1]),
                      (_COL + 2, gcol[:na, 2])):
            dLdw = dLdw + g[:, c] * gc
        for e in range(E):
            dLdw = dLdw + g[:, _EXT + e] * gext[:na, e]
        is_med = torch.where(k + 1 == med[:na], gmed[:na], 0.0)
        if no_dist:
            dLdd = is_med
        else:
            inv_d = 1.0 / torch.where(cm, depth_ray, 1.0)
            md = MD_SCALE * (1.0 - NEAR_N * inv_d)
            dLdw = (dLdw + depth_ray * gD[:na]
                    + gdist[:na] * (md * md * a_fin[:na] + m2tot[:na]
                                    - 2.0 * md * m1tot[:na]))
            dmd_dd = DMD_DD * inv_d * inv_d
            dLdd = (w * gD[:na] + is_med
                    + gdist[:na] * 2.0 * w * (md * a_fin[:na] - m1tot[:na])
                    * dmd_dd)
        S_a = S[:na]
        dLda = torch.where(cm, dLdw * Ti - (S_a + Tfin_g[:na]) / one_minus,
                           0.0)
        dLdd = torch.where(cm, dLdd, 0.0)
        dopa = G * dLda
        dLdrho = -0.5 * G * (g[:, _OPA] * dLda)
        u3 = s["use3d"] & cm
        sx, sy, inv_pz = s["sx"], s["sy"], s["inv_pz"]
        dLdsx = torch.where(u3, dLdrho * 2.0 * sx + dLdd * g[:, _TW], 0.0)
        dLdsy = torch.where(u3, dLdrho * 2.0 * sy + dLdd * g[:, _TW + 1], 0.0)
        dLdpx = dLdsx * inv_pz
        dLdpy = dLdsy * inv_pz
        dLdpz = -(dLdsx * sx + dLdsy * sy) * inv_pz
        dd3 = torch.where(u3, dLdd, 0.0)
        in2d = cm & ~s["use3d"]
        dd2 = torch.where(in2d, dLdd, 0.0)
        dxy_x = torch.where(in2d, dLdrho * FILTER_INV_SQUARE * 2.0 * s["dx"],
                            0.0)
        dxy_y = torch.where(in2d, dLdrho * FILTER_INV_SQUARE * 2.0 * s["dy"],
                            0.0)
        cols = [X * dLdpx, X * dLdpy, X * dLdpz, Y * dLdpx, Y * dLdpy,
                Y * dLdpz, dLdpx, dLdpy, dLdpz, dd3 * sx, dd3 * sy,
                dd3 + dd2, dxy_x, dxy_y,
                w * gnrm[:na, 0], w * gnrm[:na, 1], w * gnrm[:na, 2],
                torch.where(cm, dopa, 0.0),
                w * gcol[:na, 0], w * gcol[:na, 1], w * gcol[:na, 2]]
        cols += [w * gext[:na, e] for e in range(E)]
        d_sorted[start[:na] + k, :21 + E] = torch.stack(cols, dim=1).sum(
            dim=2)
        S[:na] = S_a + torch.where(cm, dLdw * w, 0.0)
        T[:na] = torch.where(cm, Ti, Ta)
        if count_work:
            n_hits += int(cm.sum())
            n_slots += int(cm.any(dim=1).sum())
    if not count_work:
        return d_sorted
    if not clip_rect:
        n_evals = int(iout[:, 0].to(torch.int64).sum())
    return d_sorted, (n_evals, n_hits, n_slots)


def check_width(name, n_extra):
    """The kernels take 0 <= E <= MAX_E feature channels."""
    if not 0 <= n_extra <= MAX_E:
        raise ValueError(f"{name} kernel takes 0 <= E <= {MAX_E} feature "
                         f"channels, got {n_extra}")


def _check_common(name, flat, sorted_gid, tile_start, tile_end, n_extra,
                  clip_rect=False):
    check_width(name, n_extra)
    D = 21 + n_extra + (RECT if clip_rect else 0)
    if flat.dtype != torch.float32 or flat.dim() != 2 \
            or flat.shape[1] != D or not flat.is_contiguous():
        raise ValueError(f"flat must be contiguous f32 [N, {D}], "
                         f"got {flat.dtype} {tuple(flat.shape)}")
    nt = tile_start.shape[0]
    for what, a, shape in (("sorted_gid", sorted_gid, None),
                           ("tile_start", tile_start, (nt,)),
                           ("tile_end", tile_end, (nt,))):
        if a.dtype != torch.int32 or a.device != flat.device \
                or not a.is_contiguous() or a.dim() != 1 \
                or (shape is not None and tuple(a.shape) != shape):
            raise ValueError(f"{what} must be a contiguous int32 vector on "
                             f"{flat.device}")


def _check_tiles(name, a, dtype, shape, dev):
    if a.dtype != dtype or a.device != dev or not a.is_contiguous() \
            or tuple(a.shape) != shape:
        raise ValueError(f"{name} must be contiguous {dtype} {shape} on {dev}, "
                         f"got {a.dtype} {tuple(a.shape)} on {a.device}")


def _lib_fn(source: str, symbol: str, argtypes):
    """The ctypes function `symbol` of csrc/<source>, built at first use."""
    key = (source, symbol)
    fn = _lib_fn.cache.get(key)
    if fn is None:
        fn = getattr(cuda_build.load(source), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _lib_fn.cache[key] = fn
    return fn


_lib_fn.cache = {}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(a):
    return a.data_ptr() if a is not None else None


def _check_tile_ids(tile_ids, nt: int, dev) -> int:
    """The kernel's row count: the tile list's length (a contiguous int32
    vector on dev; _tile_key has checked its range), or nt without a
    list."""
    if tile_ids is None:
        return nt
    if tile_ids.dtype != torch.int32 or tile_ids.device != dev \
            or not tile_ids.is_contiguous() or tile_ids.dim() != 1:
        raise ValueError(f"tile_ids must be a contiguous int32 vector on "
                         f"{dev}")
    return tile_ids.shape[0]


def _mode(viewer: bool, no_dist: bool, extras_only: bool,
          track: bool) -> str:
    chosen = [m for m, on in (("viewer", viewer), ("no_dist", no_dist),
                              ("extras_only", extras_only), ("track", track))
              if on]
    if len(chosen) > 1:
        raise ValueError(f"{' and '.join(chosen)} are separate modes of K1")
    return chosen[0] if chosen else "full"


def _tile_key(kernel: str, mode: str, tile_ids, tiles_per_view: int,
              nt: int, clip_rect: bool = False) -> str:
    """The LAUNCHES key of a K1/K2 launch ("K1"/"K2"), which also checks
    the mode and the tile selection: clip_rect serves every mode but
    track; a tile list (K3/K4) serves every mode but track, merged views
    (tiles_per_view) the extras_only mode without clip_rect, one selection
    at a time; every listed id is a tile (asserted on the list's device
    without a host read: on the card a bad id stops the stream before the
    kernel reads out of bounds)."""
    clip = " clip_rect" if clip_rect else ""
    if clip_rect and mode == "track":
        raise ValueError("clip_rect and track are separate modes (track "
                         "packs no rect columns)")
    if tile_ids is None and not tiles_per_view:
        return f"{kernel} {mode}{clip}"
    if tile_ids is not None:
        torch._assert_async(((tile_ids >= 0) & (tile_ids < nt)).all(),
                            f"tile_ids must lie in [0, {nt})")
    if tile_ids is not None and tiles_per_view:
        raise ValueError("tile_ids and tiles_per_view are separate modes")
    if tiles_per_view:
        if mode != "extras_only" or clip_rect:
            raise ValueError("tiles_per_view serves the extras_only mode "
                             "without clip_rect only")
        if nt % tiles_per_view:
            raise ValueError(f"{nt} tiles are not whole views of "
                             f"{tiles_per_view}")
        return f"{kernel} tiles_per_view"
    if mode == "track":
        raise ValueError("a tile list serves every mode but track")
    return {"K1": "K3", "K2": "K4"}[kernel] + f" {mode}{clip}"


def blend_fwd(flat, sorted_gid, tile_start, tile_end, grid_x: int,
              n_extra: int, viewer: bool = False, no_dist: bool = False,
              extras_only: bool = False, done0=None, track: bool = False,
              tile_ids=None, tiles_per_view: int = 0,
              clip_rect: bool = False):
    """K1 forward blend → (out [T, 12+E, 256] f32, iout [T, 2, 256] i32),
    and with track the contributor buffer (ids [T, TRACK_K, 256] i32, w
    [T, TRACK_K, 256] f32) after them. done0 [T, 1, 256] int32 (extras_only
    only): the sampled-pixel mask (see blend_fwd_reference). tile_ids [K]
    int32 (K3, every mode but track): render only these tiles, out/iout
    [K, ...] in list order. tiles_per_view (extras_only): merged views,
    pixel coordinates from t % tiles_per_view. clip_rect (every mode but
    track): flat [N, 21+E+4] carries each gaussian's rect (pack_flat_cols
    rect=), and a pair contributes only where its tile lies in it.

    CUDA tensors launch csrc/blend_fwd.cu (and raise on anything it does
    not take); CPU tensors run blend_fwd_reference. Forward only: for
    gradients call `blend`."""
    mode = _mode(viewer, no_dist, extras_only, track)
    if done0 is not None and mode != "extras_only":
        raise ValueError("done0 masks serve K1's extras_only mode only")
    key = _tile_key("K1", mode, tile_ids, tiles_per_view,
                    tile_start.shape[0], clip_rect)
    if torch.is_grad_enabled() and flat.requires_grad:
        raise ValueError("blend_fwd is the forward kernel alone; call "
                         "blend() (BlendFunction) for gradients, or "
                         "detach flat")
    if flat.device.type == "cpu":
        return blend_fwd_reference(flat, sorted_gid, tile_start, tile_end,
                                   grid_x, n_extra, viewer, no_dist=no_dist,
                                   extras_only=extras_only, done0=done0,
                                   track=track, tile_ids=tile_ids,
                                   tiles_per_view=tiles_per_view,
                                   clip_rect=clip_rect)
    if flat.device.type != "cuda":
        raise ValueError(f"blend_fwd: unsupported device {flat.device}")
    _check_common("blend_fwd", flat, sorted_gid, tile_start, tile_end,
                  n_extra, clip_rect)
    nt = tile_start.shape[0]
    dev = flat.device
    rows = _check_tile_ids(tile_ids, nt, dev)
    if done0 is not None:
        _check_tiles("done0", done0, torch.int32, (nt, 1, P2), dev)
    out = torch.empty((rows, 12 + n_extra, P2), dtype=torch.float32,
                      device=dev)
    iout = torch.empty((rows, 2, P2), dtype=torch.int32, device=dev)
    ids = tw = None
    if track:
        ids = torch.empty((rows, TRACK_K, P2), dtype=torch.int32, device=dev)
        tw = torch.empty((rows, TRACK_K, P2), dtype=torch.float32, device=dev)
    fn = _lib_fn("blend_fwd.cu", "blend_fwd_launch",
                 [_P] * 4 + [_I] * 5 + [_P, _I] + [_P] * 6)
    with torch.cuda.device(dev):
        err = fn(flat.data_ptr(), sorted_gid.data_ptr(),
                 tile_start.data_ptr(), tile_end.data_ptr(), rows, grid_x,
                 n_extra, MODES.index(mode), int(clip_rect), _ptr(tile_ids),
                 tiles_per_view, _ptr(done0), out.data_ptr(),
                 iout.data_ptr(), _ptr(ids), _ptr(tw), _stream(dev))
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: cudaError {err}")
    LAUNCHES[key] += 1
    return (out, iout, ids, tw) if track else (out, iout)


def blend_bwd(flat, sorted_gid, tile_start, tile_end, grid_x: int,
              n_extra: int, gout, saved, iout, no_dist: bool = False,
              extras_only: bool = False, tile_ids=None,
              tiles_per_view: int = 0, clip_rect: bool = False):
    """K2 backward blend → d_sorted [pairs, 21+E] f32 ([pairs, E] with
    extras_only, [pairs, 21+E+4] with clip_rect; see blend_bwd_reference
    for what it computes). tile_ids (K4) and tiles_per_view as in
    blend_fwd: gout, saved and iout have K1's rows, and the slots of
    unlisted tiles get zero rows.

    CUDA tensors launch csrc/blend_bwd.cu (and raise on anything it does
    not take); CPU tensors run blend_bwd_reference."""
    if no_dist and extras_only:
        raise ValueError("no_dist and extras_only are separate modes of K2")
    mode = "extras_only" if extras_only else "no_dist" if no_dist else "full"
    key = _tile_key("K2", mode, tile_ids, tiles_per_view,
                    tile_start.shape[0], clip_rect)
    if flat.device.type == "cpu":
        return blend_bwd_reference(flat, sorted_gid, tile_start, tile_end,
                                   grid_x, n_extra, gout, saved, iout,
                                   no_dist=no_dist, extras_only=extras_only,
                                   tile_ids=tile_ids,
                                   tiles_per_view=tiles_per_view,
                                   clip_rect=clip_rect)
    if flat.device.type != "cuda":
        raise ValueError(f"blend_bwd: unsupported device {flat.device}")
    _check_common("blend_bwd", flat, sorted_gid, tile_start, tile_end,
                  n_extra, clip_rect)
    if extras_only and n_extra == 0:
        raise ValueError("K2 extras_only needs feature channels (E > 0)")
    nt = tile_start.shape[0]
    dev = flat.device
    rows = _check_tile_ids(tile_ids, nt, dev)
    _check_tiles("gout", gout, torch.float32, (rows, 12 + n_extra, P2), dev)
    _check_tiles("saved", saved, torch.float32, (rows, 3, P2), dev)
    _check_tiles("iout", iout, torch.int32, (rows, 2, P2), dev)
    # with a tile list the kernel writes only the listed tiles' slots
    d_sorted = (torch.empty if tile_ids is None else torch.zeros)(
        (sorted_gid.shape[0], n_extra if extras_only else flat.shape[1]),
        dtype=torch.float32, device=dev)
    fn = _lib_fn("blend_bwd.cu", "blend_bwd_launch",
                 [_P] * 4 + [_I] * 5 + [_P, _I] + [_P] * 5)
    with torch.cuda.device(dev):
        err = fn(flat.data_ptr(), sorted_gid.data_ptr(),
                 tile_start.data_ptr(), tile_end.data_ptr(), rows, grid_x,
                 n_extra, BWD_MODES.index(mode), int(clip_rect),
                 _ptr(tile_ids), tiles_per_view, gout.data_ptr(),
                 saved.data_ptr(), iout.data_ptr(), d_sorted.data_ptr(),
                 _stream(dev))
    if err != 0:
        raise RuntimeError(f"blend_bwd kernel launch failed: cudaError {err}")
    LAUNCHES[key] += 1
    return d_sorted


def reduce_per_gaussian_reference(d_sorted, sorted_gid, n: int):
    """The plain version of the segment sum: an index_add_, in slot order
    on the CPU (on the card its atomics add in no fixed order)."""
    return torch.zeros((n, d_sorted.shape[1]), dtype=d_sorted.dtype,
                       device=d_sorted.device).index_add_(
        0, sorted_gid.to(torch.int64), d_sorted)


def reduce_per_gaussian(d_sorted, sorted_gid, n: int, runs):
    """d_flat [n, D]: d_flat[g] = Σ over slots s with sorted_gid[s] = g of
    d_sorted[s], summed in slot order from 0 — deterministic.

    runs = (gid_order, run_start), binning's list of each gaussian's slots
    (ops/binning.BinningOut). CUDA tensors launch csrc/blend_bwd.cu's
    segment-sum kernel (a block per batch of consecutive gaussians, their
    runs' rows staged in shared memory; its d_flat is the plain version's
    bits);
    CPU tensors run the plain version, reduce_per_gaussian_reference."""
    D = d_sorted.shape[1]
    if d_sorted.device.type == "cpu":
        return reduce_per_gaussian_reference(d_sorted, sorted_gid, n)
    if d_sorted.device.type != "cuda":
        raise ValueError(f"reduce_per_gaussian: unsupported device "
                         f"{d_sorted.device}")
    dev = d_sorted.device
    _check_tiles("d_sorted", d_sorted, torch.float32,
                 (sorted_gid.shape[0], D), dev)
    gid_order, run_start = runs
    _check_tiles("gid_order", gid_order, torch.int32, (d_sorted.shape[0],),
                 dev)
    _check_tiles("run_start", run_start, torch.int32, (n + 1,), dev)
    d_flat = torch.empty((n, D), dtype=torch.float32, device=dev)
    fn = _lib_fn("blend_bwd.cu", "segment_sum_launch",
                 [_P] * 3 + [_I] * 2 + [_P] * 2)
    with torch.cuda.device(dev):
        err = fn(d_sorted.data_ptr(), gid_order.data_ptr(),
                 run_start.data_ptr(), n, D, d_flat.data_ptr(),
                 _stream(dev))
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES["segment_sum"] += 1
    return d_flat


class BlendFunction(torch.autograd.Function):
    """Differentiable K1 (`full`, `no_dist` or `extras_only`, the last
    with an optional done0 mask; each over a tile list (K3) or with
    clip_rect; extras_only also over merged views): forward runs
    blend_fwd; backward runs blend_bwd (K2, K4 with a tile list) and
    reduce_per_gaussian and returns d_flat (extras_only: zero in the 21
    geometry columns, as the JAX VJP pads it; clip_rect: zero in the 4
    rect columns). Saved for the backward: flat, the pair list, tile
    ranges, tile list and per-gaussian runs, iout and out's final T, m1
    and m2 rows."""

    @staticmethod
    def forward(ctx, flat, sorted_gid, tile_start, tile_end, gid_order,
                run_start, grid_x, n_extra, no_dist, extras_only, done0,
                tile_ids, tiles_per_view, clip_rect):
        out, iout = blend_fwd(flat, sorted_gid, tile_start, tile_end, grid_x,
                              n_extra, no_dist=no_dist,
                              extras_only=extras_only, done0=done0,
                              tile_ids=tile_ids,
                              tiles_per_view=tiles_per_view,
                              clip_rect=clip_rect)
        E = n_extra
        saved = torch.stack([out[:, 9], out[:, 10 + E], out[:, 11 + E]],
                            dim=1).contiguous()
        ctx.save_for_backward(flat, sorted_gid, tile_start, tile_end,
                              gid_order, run_start, iout, saved, tile_ids)
        ctx.grid_x, ctx.n_extra = grid_x, n_extra
        ctx.no_dist, ctx.extras_only = no_dist, extras_only
        ctx.tiles_per_view, ctx.clip_rect = tiles_per_view, clip_rect
        ctx.mark_non_differentiable(iout)
        return out, iout

    @staticmethod
    def backward(ctx, gout, _giout):
        (flat, sorted_gid, tile_start, tile_end, gid_order, run_start, iout,
         saved, tile_ids) = ctx.saved_tensors
        d_sorted = blend_bwd(flat, sorted_gid, tile_start, tile_end,
                             ctx.grid_x, ctx.n_extra, gout.contiguous(),
                             saved, iout, no_dist=ctx.no_dist,
                             extras_only=ctx.extras_only, tile_ids=tile_ids,
                             tiles_per_view=ctx.tiles_per_view,
                             clip_rect=ctx.clip_rect)
        d_flat = reduce_per_gaussian(d_sorted, sorted_gid, flat.shape[0],
                                     (gid_order, run_start))
        if ctx.extras_only:
            # pixels done0 latched have n_contrib 0: no mask input needed;
            # clip_rect's rect columns take no gradient
            n = flat.shape[0]
            d_flat = torch.cat(
                [d_flat.new_zeros((n, _EXT)), d_flat]
                + ([d_flat.new_zeros((n, RECT))] if ctx.clip_rect else []),
                dim=1)
        return (d_flat,) + (None,) * 13


def blend(flat, sorted_gid, tile_start, tile_end, grid_x: int, n_extra: int,
          runs, no_dist: bool = False, extras_only: bool = False,
          done0=None, tile_ids=None, tiles_per_view: int = 0,
          clip_rect: bool = False):
    """Differentiable K1 → (out, iout); gradients reach `flat` through K2.
    runs = (gid_order, run_start) of the same binning (BinningOut).
    tile_ids (K3/K4), tiles_per_view and clip_rect: see blend_fwd."""
    return BlendFunction.apply(flat, sorted_gid, tile_start, tile_end,
                               *runs, grid_x, n_extra, no_dist, extras_only,
                               done0, tile_ids, tiles_per_view, clip_rect)
