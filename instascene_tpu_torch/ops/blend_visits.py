"""The blend: pack, the forward kernel K1, the backward kernel K2, the
per-gaussian reduction, their plain PyTorch versions and the autograd
Function that joins them.

Port of instascene_tpu/ops/blend_pallas.py:51-89 (`pack_flat_cols`),
:150-182 (`_splat_terms`) and instascene_tpu/ops/blend_visits.py:62-392
(`_fwd_kernel_visits`, the TPU kernel K1, in its `full`, `viewer` and
`no_dist` modes), :395-607 (`_bwd_kernel_visits`, the TPU kernel K2, in its
`full` and `no_dist` modes) and :687-751 (the custom VJP with its
per-gaussian scatter-add). The kernels are csrc/blend_fwd.cu and
csrc/blend_bwd.cu (CUDA C++ for sm_90a); their headers say what bounds them
on the H100 and how the design answers that.

The TPU layout machinery (pair caps, the (chunk, tile) visit list and its
SMEM budget) is gone: the inputs are the per-gaussian packed table `flat`
[N, 21+E], the depth-sorted pair list `sorted_gid` [pairs] and the per-tile
ranges [tile_start, tile_end). Outputs keep K1's public layout:
out [num_tiles, 12+E, 256] f32 and iout [num_tiles, 2, 256] i32
(rows listed in csrc/blend_fwd.cu).

`blend_fwd`, `blend_bwd` and `reduce_per_gaussian` launch their kernels for
CUDA tensors (or raise) and run the plain versions for CPU tensors; each
adds one to its entry of `LAUNCHES` (by kernel and mode) where it launches.
`blend` is the differentiable entry (`BlendFunction`). K1's extras_only (with done0), track, clip_rect and
tiles_per_view modes and K2's extras_only, clip_rect and tiles_per_view
modes come in later slices.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_build
from .preprocess import FAR_N, FILTER_INV_SQUARE, NEAR_N, TILE, fma

P2 = TILE * TILE
_TW, _XY, _NRM, _OPA, _COL, _EXT = 9, 12, 14, 17, 18, 21
MD_SCALE = FAR_N / (FAR_N - NEAR_N)
DMD_DD = FAR_N * NEAR_N / (FAR_N - NEAR_N)   # d(md)/d(depth) · depth²
ALPHA_MIN = 1.0 / 255.0
T_DONE = 1e-4
KERNEL_E = (0, 16)                      # feature widths the kernels are built for
MODES = ("full", "viewer", "no_dist")   # K1's modes here; its C entry takes the index
# kernel launches, by kernel and mode (the plain versions launch nothing)
LAUNCHES = dict.fromkeys(("K1 full", "K1 viewer", "K1 no_dist", "K2 full",
                          "K2 no_dist", "segment_sum"), 0)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b with each component fma(a_i, b_j, −a_j·b_i), the rounding the
    JAX package's jnp.cross gets (see ops/preprocess.py on why it matters)."""
    return torch.stack([fma(a[:, 1], b[:, 2], -(a[:, 2] * b[:, 1])),
                        fma(a[:, 2], b[:, 0], -(a[:, 0] * b[:, 2])),
                        fma(a[:, 0], b[:, 1], -(a[:, 1] * b[:, 0]))], dim=1)


def pack_flat_cols(T_used, xy, normal_view, opacities, color, extras=None):
    """Per-gaussian packed attribute table [N, 21+E]: affine ray
    coefficients A = Tv×Tw, B = Tw×Tu, C = Tu×Tv (so the ray-splat
    intersection is p = x·A + y·B + C), Tw, xy, view normal, opacity,
    color, E extra channels. Differentiable."""
    n = xy.shape[0]
    T = torch.reshape(T_used, (n, 3, 3))
    Tu, Tv, Tw = T[:, 0], T[:, 1], T[:, 2]
    cols = [_cross(Tv, Tw), _cross(Tw, Tu), _cross(Tu, Tv), Tw, xy,
            normal_view, torch.reshape(opacities, (n, 1)), color]
    if extras is not None:
        cols.append(extras)
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


def _walk_order(tile_start, tile_end, grid_x):
    """Tiles longest-first (so step k touches only the first `na` tiles,
    those with a slot k) and their pixel coordinates [T, 256]."""
    dev = tile_start.device
    counts = (tile_end - tile_start).to(torch.int64)
    order = torch.argsort(counts, descending=True, stable=True)
    start = tile_start.to(torch.int64)[order]
    asc = counts[order].cpu().numpy()[::-1]
    pix = torch.arange(P2, device=dev)
    pxf = ((order % grid_x) * TILE)[:, None].to(torch.float32) \
        + (pix % TILE).to(torch.float32)
    pyf = ((order // grid_x) * TILE)[:, None].to(torch.float32) \
        + (pix // TILE).to(torch.float32)
    n_at = lambda k: order.shape[0] - int(np.searchsorted(asc, k,
                                                           side="right"))
    return order, start, int(asc[-1]) if len(asc) else 0, n_at, pxf, pyf


def blend_fwd_reference(flat, sorted_gid, tile_start, tile_end, grid_x: int,
                        n_extra: int, viewer: bool = False,
                        count_work: bool = False, no_dist: bool = False):
    """The plain PyTorch version of K1: vectorised over tiles × pixels,
    looping over the within-tile slot index in the kernel's order with the
    kernel's arithmetic (see _splat).

    no_dist: the depth sum, the distortion and the m1/m2 totals are skipped
    and their rows (3, 8, 10+E, 11+E) are exact zeros; every other row and
    iout are as `full` computes them. viewer: only color, final T, features
    and n_contrib are computed.

    count_work=True also returns the work these inputs need, per pixel
    [T, 256] int32: the slots it must evaluate (up to and including the one
    that latches it done, else its tile's whole range) and its
    contributions."""
    dev = flat.device
    E = n_extra
    OC = 12 + E
    nt = tile_start.shape[0]
    f32 = torch.float32
    order, start, max_count, n_at, pxf, pyf = _walk_order(
        tile_start, tile_end, grid_x)

    T = torch.ones((nt, P2), dtype=f32, device=dev)
    done = torch.zeros((nt, P2), dtype=torch.bool, device=dev)
    acc = torch.zeros((nt, OC, P2), dtype=f32, device=dev)
    last = torch.zeros((nt, P2), dtype=torch.int32, device=dev)
    med_slot = torch.zeros((nt, P2), dtype=torch.int32, device=dev)
    n_eval = torch.zeros((nt, P2), dtype=torch.int32, device=dev)
    n_hit = torch.zeros((nt, P2), dtype=torch.int32, device=dev)
    gid_l = sorted_gid.to(torch.int64)

    for k in range(max_count):
        na = n_at(k)
        g = flat[gid_l[start[:na] + k]][:, :, None]        # [na, D, 1]
        s = _splat(g, pxf[:na], pyf[:na])
        alpha, depth_ray = s["alpha"], s["depth_ray"]
        Tk = T[:na]
        walking = ~done[:na]
        live = s["m"] & walking
        test_T = Tk * (1.0 - alpha)
        newly = live & (test_T < T_DONE)
        done[:na] |= newly
        contrib = live & ~newly
        w = torch.where(contrib, alpha * Tk, 0.0)
        wc = w[:, None]
        a = acc[:na]
        a[:, 0:3] = a[:, 0:3] + wc * g[:, _COL:_COL + 3]
        if E:
            a[:, 10:10 + E] = a[:, 10:10 + E] + wc * g[:, _EXT:_EXT + E]
        if not viewer:
            a[:, 4:7] = a[:, 4:7] + wc * g[:, _NRM:_NRM + 3]
            if not no_dist:
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
        last[:na] = torch.where(contrib, k + 1, last[:na])
        T[:na] = torch.where(contrib, test_T, Tk)
        if count_work:
            n_eval[:na] += walking
            n_hit[:na] += contrib

    acc[:, 9] = T
    out = torch.empty_like(acc)
    out[order] = acc
    iout = torch.empty((nt, 2, P2), dtype=torch.int32, device=dev)
    iout[order] = torch.stack([last, med_slot], dim=1)
    if not count_work:
        return out, iout
    work = torch.empty((nt, 2, P2), dtype=torch.int32, device=dev)
    work[order] = torch.stack([n_eval, n_hit], dim=1)
    return out, iout, work[:, 0], work[:, 1]


def blend_bwd_reference(flat, sorted_gid, tile_start, tile_end, grid_x: int,
                        n_extra: int, gout, saved, iout,
                        no_dist: bool = False, count_work: bool = False):
    """The plain PyTorch version of K2: per-slot gradients d_sorted
    [pairs, 21+E] of Σ gout·out with respect to each slot's packed row.

    gout [T, 12+E, 256] is the cotangent of K1's out; saved [T, 3, 256]
    holds out's final T, m1 and m2 rows; iout is K1's (n_contrib,
    med_slot). Vectorised over tiles × pixels, the slot index walks back to
    front from each tile's end with the kernel's arithmetic and order: a
    slot takes part where its splat passes K1's mask and it is at or before
    the pixel's n_contrib; T before it is recovered as T_after / (1 − α);
    the suffix sum S of dL/dw·w over later slots carries the transmittance
    chain. A slot's row is its contributions summed over its tile's 256
    pixels (each slot belongs to one tile).

    count_work=True also returns (evaluations, contributions, slots reduced)
    these inputs need: each pixel evaluates its slots 1..n_contrib, and a
    slot is reduced when some pixel of its tile is at or before its
    n_contrib there."""
    dev = flat.device
    E = n_extra
    D = 21 + E
    f32 = torch.float32
    order, start, max_count, n_at, pxf, pyf = _walk_order(
        tile_start, tile_end, grid_x)
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
    n_hits = n_slots = 0
    for k in range(max_count - 1, -1, -1):
        na = n_at(k)
        g = flat[gid_l[start[:na] + k]][:, :, None]        # [na, D, 1]
        X, Y = pxf[:na], pyf[:na]
        s = _splat(g, X, Y)
        alpha, depth_ray, G = s["alpha"], s["depth_ray"], s["G"]
        cm = s["m"] & (k + 1 <= n_contrib[:na])
        one_minus = torch.where(cm, 1.0 - alpha, 1.0)
        Ta = T[:na]
        Ti = Ta / one_minus
        w = torch.where(cm, alpha * Ti, 0.0)
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
        d_sorted[start[:na] + k] = torch.stack(cols, dim=1).sum(dim=2)
        S[:na] = S_a + torch.where(cm, dLdw * w, 0.0)
        T[:na] = torch.where(cm, Ti, Ta)
        if count_work:
            n_hits += int(cm.sum())
            n_slots += int(cm.any(dim=1).sum())
    if not count_work:
        return d_sorted
    n_evals = int(iout[:, 0].to(torch.int64).sum())
    return d_sorted, (n_evals, n_hits, n_slots)


def _check_common(name, flat, sorted_gid, tile_start, tile_end, n_extra):
    if n_extra not in KERNEL_E:
        raise ValueError(f"{name} kernel is built for E in {KERNEL_E}, "
                         f"got {n_extra}")
    if flat.dtype != torch.float32 or flat.dim() != 2 \
            or flat.shape[1] != 21 + n_extra or not flat.is_contiguous():
        raise ValueError(f"flat must be contiguous f32 [N, {21 + n_extra}], "
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


def blend_fwd(flat, sorted_gid, tile_start, tile_end, grid_x: int,
              n_extra: int, viewer: bool = False, no_dist: bool = False):
    """K1 forward blend → (out [T, 12+E, 256] f32, iout [T, 2, 256] i32).

    CUDA tensors launch csrc/blend_fwd.cu (and raise on anything it does
    not take); CPU tensors run blend_fwd_reference. Forward only: for
    gradients call `blend`."""
    if viewer and no_dist:
        raise ValueError("viewer and no_dist are separate modes of K1")
    if torch.is_grad_enabled() and flat.requires_grad:
        raise ValueError("blend_fwd is the forward kernel alone; call "
                         "blend() (BlendFunction) for gradients, or "
                         "detach flat")
    if flat.device.type == "cpu":
        return blend_fwd_reference(flat, sorted_gid, tile_start, tile_end,
                                   grid_x, n_extra, viewer, no_dist=no_dist)
    if flat.device.type != "cuda":
        raise ValueError(f"blend_fwd: unsupported device {flat.device}")
    _check_common("blend_fwd", flat, sorted_gid, tile_start, tile_end,
                  n_extra)
    nt = tile_start.shape[0]
    out = torch.empty((nt, 12 + n_extra, P2), dtype=torch.float32,
                      device=flat.device)
    iout = torch.empty((nt, 2, P2), dtype=torch.int32, device=flat.device)
    mode = MODES.index("viewer" if viewer else
                       "no_dist" if no_dist else "full")
    fn = _lib_fn("blend_fwd.cu", "blend_fwd_launch",
                 [_P] * 4 + [_I] * 4 + [_P] * 3)
    with torch.cuda.device(flat.device):
        err = fn(flat.data_ptr(), sorted_gid.data_ptr(),
                 tile_start.data_ptr(), tile_end.data_ptr(), nt, grid_x,
                 n_extra, mode, out.data_ptr(), iout.data_ptr(),
                 _stream(flat.device))
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: cudaError {err}")
    LAUNCHES[f"K1 {MODES[mode]}"] += 1
    return out, iout


def blend_bwd(flat, sorted_gid, tile_start, tile_end, grid_x: int,
              n_extra: int, gout, saved, iout, no_dist: bool = False):
    """K2 backward blend → d_sorted [pairs, 21+E] f32 (see
    blend_bwd_reference for what it computes).

    CUDA tensors launch csrc/blend_bwd.cu (and raise on anything it does
    not take); CPU tensors run blend_bwd_reference."""
    if flat.device.type == "cpu":
        return blend_bwd_reference(flat, sorted_gid, tile_start, tile_end,
                                   grid_x, n_extra, gout, saved, iout,
                                   no_dist=no_dist)
    if flat.device.type != "cuda":
        raise ValueError(f"blend_bwd: unsupported device {flat.device}")
    _check_common("blend_bwd", flat, sorted_gid, tile_start, tile_end,
                  n_extra)
    nt = tile_start.shape[0]
    dev = flat.device
    _check_tiles("gout", gout, torch.float32, (nt, 12 + n_extra, P2), dev)
    _check_tiles("saved", saved, torch.float32, (nt, 3, P2), dev)
    _check_tiles("iout", iout, torch.int32, (nt, 2, P2), dev)
    d_sorted = torch.empty((sorted_gid.shape[0], 21 + n_extra),
                           dtype=torch.float32, device=dev)
    fn = _lib_fn("blend_bwd.cu", "blend_bwd_launch",
                 [_P] * 4 + [_I] * 4 + [_P] * 5)
    with torch.cuda.device(dev):
        err = fn(flat.data_ptr(), sorted_gid.data_ptr(),
                 tile_start.data_ptr(), tile_end.data_ptr(), nt, grid_x,
                 n_extra, int(no_dist), gout.data_ptr(), saved.data_ptr(),
                 iout.data_ptr(), d_sorted.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"blend_bwd kernel launch failed: cudaError {err}")
    LAUNCHES["K2 no_dist" if no_dist else "K2 full"] += 1
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
    segment-sum kernel (one thread per (gaussian, column), over those runs);
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
    """Differentiable K1 (`full` or `no_dist`): forward runs blend_fwd;
    backward runs blend_bwd (K2) and reduce_per_gaussian and returns d_flat.
    Saved for the backward: flat, the pair list, tile ranges and per-gaussian
    runs, iout and out's final T, m1 and m2 rows."""

    @staticmethod
    def forward(ctx, flat, sorted_gid, tile_start, tile_end, gid_order,
                run_start, grid_x, n_extra, no_dist):
        out, iout = blend_fwd(flat, sorted_gid, tile_start, tile_end, grid_x,
                              n_extra, no_dist=no_dist)
        E = n_extra
        saved = torch.stack([out[:, 9], out[:, 10 + E], out[:, 11 + E]],
                            dim=1).contiguous()
        ctx.save_for_backward(flat, sorted_gid, tile_start, tile_end,
                              gid_order, run_start, iout, saved)
        ctx.grid_x, ctx.n_extra, ctx.no_dist = grid_x, n_extra, no_dist
        ctx.mark_non_differentiable(iout)
        return out, iout

    @staticmethod
    def backward(ctx, gout, _giout):
        (flat, sorted_gid, tile_start, tile_end, gid_order, run_start, iout,
         saved) = ctx.saved_tensors
        d_sorted = blend_bwd(flat, sorted_gid, tile_start, tile_end,
                             ctx.grid_x, ctx.n_extra, gout.contiguous(),
                             saved, iout, no_dist=ctx.no_dist)
        d_flat = reduce_per_gaussian(d_sorted, sorted_gid, flat.shape[0],
                                     (gid_order, run_start))
        return (d_flat,) + (None,) * 8


def blend(flat, sorted_gid, tile_start, tile_end, grid_x: int, n_extra: int,
          runs, no_dist: bool = False):
    """Differentiable K1 → (out, iout); gradients reach `flat` through K2.
    runs = (gid_order, run_start) of the same binning (BinningOut)."""
    return BlendFunction.apply(flat, sorted_gid, tile_start, tile_end,
                               *runs, grid_x, n_extra, no_dist)
