"""Sparse-pixel extras blend: only the sampled pixels of each tile blend.

Port of instascene_tpu/ops/blend_sparse.py:146-249 (`_sparse_fwd_kernel`,
the TPU kernel K5), :251-364 (`_sparse_bwd_kernel`, K6), :492-543
(`blend_sparse_diff` and its VJP with the cached per-gaussian reduction),
:546-554 (`pick_sparse_s`) and :557-602 (`spix_from_idx`). The kernels are
csrc/blend_sparse.cu (CUDA C++ for sm_90a, built at first use); its header
says what bounds them on the H100 and how the design answers that.

The semantic losses read the render at a few thousand drawn pixels, and
the draws depend only on the segmaps, so they are drawn first and only
they blend: spix [T, S] int32 lists each tile's drawn pixels (-1 padding;
a pixel drawn twice takes two slots), feat [T, S, E] and aux [T, S, 2]
(final T, n_contrib) come back per slot. A slot's values are those of K1
`extras_only` at its pixel, and the plain versions here are K1's and K2's
plain versions (ops/blend_visits.py) evaluated at the sampled pixels.
The TPU layout ([T, 8, 128] lane-aligned slot rows, grouped visits) is
gone.

`blend_sparse_fwd` and `blend_sparse_bwd` launch their kernels for CUDA
tensors (or raise) and run the plain versions for CPU tensors; each adds
one to LAUNCHES["K5"/"K6"] (cuda_build.LAUNCHES) where it launches.
`blend_sparse` is the differentiable entry (`BlendSparseFunction`).
"""

from __future__ import annotations

import torch

from . import blend_visits as bv
from ..cuda_build import LAUNCHES, I, P, lib_fn, stream

S_MAX = 128          # slots per tile the kernels take (as the JAX kernels)


def pick_sparse_s(batch: int, num_tiles: int) -> int:
    """Per-tile slot count: the mean draw density λ plus a ~6σ Poisson
    tail and a margin, rounded up to a multiple of 8, at most 128. A tile
    that draws more overflows: the caller then takes the dense path, so S
    only sets how often that happens."""
    lam = batch / max(num_tiles, 1)
    s = int(lam + 6.0 * max(lam, 1.0) ** 0.5 + 10.0)
    return min(S_MAX, (s + 7) // 8 * 8)


def spix_from_idx(idx, width: int, height: int, tile: int, S: int,
                  valid=None):
    """Pack flat pixel indices idx [B] into per-tile slot lists.

    Samples take slots in a stable order: by tile, then by their position
    in idx. valid [B] bool (optional): entries marked False take no slot
    and do not count for the overflow. Returns (spix [T, S] int32, -1
    padding; t_of [B] (0 for invalid entries); slot_of [B] (clipped to
    S−1); overflow, a 0-d bool tensor: some tile drew more than S). Sample
    j's feature is feat[t_of[j], slot_of[j]] when it is valid and nothing
    overflowed."""
    dev = idx.device
    grid_x = (width + tile - 1) // tile
    grid_y = (height + tile - 1) // tile
    T = grid_x * grid_y
    B = idx.shape[0]
    idx = idx.to(torch.int64)
    y, x = idx // width, idx % width
    t = (y // tile) * grid_x + (x // tile)
    p2 = (y % tile) * tile + (x % tile)
    if valid is not None:
        t = torch.where(valid, t, T)           # invalid entries sort last
    order = torch.argsort(t, stable=True)
    t_s = t[order]
    ar = torch.arange(B, device=dev)
    is_start = torch.ones(B, dtype=torch.bool, device=dev)
    is_start[1:] = t_s[1:] != t_s[:-1]
    run0 = torch.cummax(torch.where(is_start, ar, 0), dim=0).values
    rank = torch.empty_like(ar)
    rank[order] = ar - run0
    in_img = t < T
    overflow = ((rank >= S) & in_img).any()
    keep = (rank < S) & in_img
    # one spare row takes the entries that get no slot
    spix = torch.full((T + 1, S), -1, dtype=torch.int32, device=dev)
    spix[torch.where(keep, t, T), rank.clamp(max=S - 1)] = p2.to(torch.int32)
    return (spix[:T].contiguous(), torch.where(in_img, t, 0),
            rank.clamp(max=S - 1), overflow)


def blend_sparse_fwd_reference(flat, sorted_gid, tile_start, tile_end,
                               spix, grid_x: int, n_extra: int,
                               count_work: bool = False):
    """The plain version of K5: K1 extras_only's plain version at the
    sampled pixels (empty slots pre-latched). Returns (feat [T, S, E], aux
    [T, S, 2]), and with count_work K1's per-slot work counts after them."""
    res = bv.blend_fwd_reference(
        flat, sorted_gid, tile_start, tile_end, grid_x, n_extra,
        extras_only=True, done0=(spix < 0).to(torch.int32),
        pixels=spix.clamp(min=0), count_work=count_work)
    out, iout = res[:2]
    E = n_extra
    feat = out[:, 10:10 + E].transpose(1, 2).contiguous()
    aux = torch.stack([out[:, 9], iout[:, 0].to(torch.float32)], dim=2)
    return (feat, aux) + tuple(res[2:])


def blend_sparse_bwd_reference(flat, sorted_gid, tile_start, tile_end, spix,
                               grid_x: int, n_extra: int, gout, aux,
                               count_work: bool = False):
    """The plain version of K6: K2 extras_only's plain version at the
    sampled pixels, fed gout [T, S, E] as the feature rows of its
    cotangent and aux's final T and n_contrib. Returns d_sorted [pairs, E]
    (and with count_work K2's work counts)."""
    nt, S, E = gout.shape
    go = gout.new_zeros((nt, 12 + E, S))
    go[:, 10:10 + E] = gout.transpose(1, 2)
    saved = gout.new_zeros((nt, 3, S))
    saved[:, 0] = aux[..., 0]
    iout = torch.zeros((nt, 2, S), dtype=torch.int32, device=gout.device)
    iout[:, 0] = aux[..., 1].to(torch.int32)
    return bv.blend_bwd_reference(
        flat, sorted_gid, tile_start, tile_end, grid_x, n_extra, go, saved,
        iout, extras_only=True, count_work=count_work,
        pixels=spix.clamp(min=0))


def _check(name, flat, sorted_gid, tile_start, tile_end, n_extra, spix):
    if n_extra == 0:
        raise ValueError(f"{name} needs feature channels (E > 0)")
    bv._check_common(name, flat, sorted_gid, tile_start, tile_end, n_extra)
    nt = tile_start.shape[0]
    if spix.dim() != 2 or not 0 < spix.shape[1] <= S_MAX:
        raise ValueError(f"spix must be [T, S] with 0 < S <= {S_MAX}, got "
                         f"{tuple(spix.shape)}")
    bv._check_tiles("spix", spix, torch.int32, (nt, spix.shape[1]),
                    flat.device)


def blend_sparse_fwd(flat, sorted_gid, tile_start, tile_end, spix,
                     grid_x: int, n_extra: int):
    """K5 → (feat [T, S, E] f32, aux [T, S, 2] f32: final T, n_contrib).

    CUDA tensors launch csrc/blend_sparse.cu, its blocks in the tiles'
    walk_order (and raise on anything it does not take); CPU tensors run
    blend_sparse_fwd_reference. Forward only: for gradients call
    `blend_sparse`."""
    if torch.is_grad_enabled() and flat.requires_grad:
        raise ValueError("blend_sparse_fwd is the forward kernel alone; call "
                         "blend_sparse() for gradients, or detach flat")
    if flat.device.type == "cpu":
        return blend_sparse_fwd_reference(flat, sorted_gid, tile_start,
                                          tile_end, spix, grid_x, n_extra)
    if flat.device.type != "cuda":
        raise ValueError(f"blend_sparse_fwd: unsupported device "
                         f"{flat.device}")
    _check("blend_sparse_fwd", flat, sorted_gid, tile_start, tile_end,
           n_extra, spix)
    nt, S = spix.shape
    dev = flat.device
    feat = torch.empty((nt, S, n_extra), dtype=torch.float32, device=dev)
    aux = torch.empty((nt, S, 2), dtype=torch.float32, device=dev)
    order = bv.walk_order(bv.range_lengths(tile_start, tile_end))
    fn = lib_fn("blend_sparse.cu", "sparse_fwd_launch",
                [P] * 5 + [I] * 3 + [P, I] + [P] * 3)
    with torch.cuda.device(dev):
        err = fn(flat.data_ptr(), sorted_gid.data_ptr(),
                 tile_start.data_ptr(), tile_end.data_ptr(),
                 order.data_ptr(), nt, grid_x, n_extra, spix.data_ptr(), S,
                 feat.data_ptr(), aux.data_ptr(), stream(dev))
    if err != 0:
        raise RuntimeError(f"sparse_fwd kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES["K5"] += 1
    return feat, aux


def blend_sparse_bwd(flat, sorted_gid, tile_start, tile_end, spix,
                     grid_x: int, n_extra: int, gout, aux):
    """K6 → d_sorted [pairs, E] f32: per slot, Σ over its tile's sampled
    pixels of w · gout (see blend_sparse_bwd_reference).

    CUDA tensors launch csrc/blend_sparse.cu, its blocks in the tiles'
    walk_order (and raise on anything it does not take); CPU tensors run
    blend_sparse_bwd_reference."""
    if flat.device.type == "cpu":
        return blend_sparse_bwd_reference(flat, sorted_gid, tile_start,
                                          tile_end, spix, grid_x, n_extra,
                                          gout, aux)
    if flat.device.type != "cuda":
        raise ValueError(f"blend_sparse_bwd: unsupported device "
                         f"{flat.device}")
    _check("blend_sparse_bwd", flat, sorted_gid, tile_start, tile_end,
           n_extra, spix)
    nt, S = spix.shape
    dev = flat.device
    bv._check_tiles("gout", gout, torch.float32, (nt, S, n_extra), dev)
    bv._check_tiles("aux", aux, torch.float32, (nt, S, 2), dev)
    d_sorted = torch.empty((sorted_gid.shape[0], n_extra),
                           dtype=torch.float32, device=dev)
    order = bv.walk_order(bv.range_lengths(tile_start, tile_end))
    fn = lib_fn("blend_sparse.cu", "sparse_bwd_launch",
                [P] * 5 + [I] * 3 + [P, I] + [P] * 4)
    with torch.cuda.device(dev):
        err = fn(flat.data_ptr(), sorted_gid.data_ptr(),
                 tile_start.data_ptr(), tile_end.data_ptr(),
                 order.data_ptr(), nt, grid_x, n_extra, spix.data_ptr(), S,
                 gout.data_ptr(), aux.data_ptr(), d_sorted.data_ptr(),
                 stream(dev))
    if err != 0:
        raise RuntimeError(f"sparse_bwd kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES["K6"] += 1
    return d_sorted


class BlendSparseFunction(torch.autograd.Function):
    """Differentiable K5: forward runs blend_sparse_fwd; backward runs K6
    and the segment sum (reduce_per_gaussian at D = E) and returns d_flat,
    zero in the 21 geometry columns (blend_sparse.py:538-540)."""

    @staticmethod
    def forward(ctx, flat, sorted_gid, tile_start, tile_end, gid_order,
                run_start, spix, grid_x, n_extra):
        feat, aux = blend_sparse_fwd(flat, sorted_gid, tile_start, tile_end,
                                     spix, grid_x, n_extra)
        ctx.save_for_backward(flat, sorted_gid, tile_start, tile_end,
                              gid_order, run_start, spix, aux)
        ctx.grid_x, ctx.n_extra = grid_x, n_extra
        ctx.mark_non_differentiable(aux)
        return feat, aux

    @staticmethod
    def backward(ctx, gfeat, _gaux):
        (flat, sorted_gid, tile_start, tile_end, gid_order, run_start, spix,
         aux) = ctx.saved_tensors
        d_sorted = blend_sparse_bwd(flat, sorted_gid, tile_start, tile_end,
                                    spix, ctx.grid_x, ctx.n_extra,
                                    gfeat.contiguous(), aux)
        d_ext = bv.reduce_per_gaussian(d_sorted, sorted_gid, flat.shape[0],
                                       (gid_order, run_start))
        d_flat = torch.cat([d_ext.new_zeros((flat.shape[0], bv._EXT)),
                            d_ext], dim=1)
        return (d_flat,) + (None,) * 8


def blend_sparse(flat, binning, spix, grid_x: int, n_extra: int):
    """Differentiable K5 over a camera's BinningOut → (feat [T, S, E],
    aux [T, S, 2]); gradients reach flat's feature columns through K6."""
    return BlendSparseFunction.apply(
        flat, binning.sorted_gid, binning.tile_start, binning.tile_end,
        binning.gid_order, binning.run_start, spix, grid_x, n_extra)
