"""The blend over the padded per-tile layout: K7 (forward), K8 (backward),
their plain versions and the autograd Function that joins them.

Port of instascene_tpu/ops/blend_pallas.py:185-323 (`_fwd_kernel`, the TPU
kernel K7, and `blend_fwd_pallas`), :333-500 (`_bwd_kernel`, K8, and
`blend_bwd_pallas`), :503-543 (`blend_pallas_diff` and its custom VJP) and
instascene_tpu/ops/rasterize_pallas.py:21-27 (`pack_inputs`). The kernels
are csrc/blend_padded.cu (CUDA C++ for sm_90a): K1's and K2's walk
(csrc/blend_walk.cuh) over packed [T, D, K], read along K, count[t] slots
per tile. Its header says what bounds them on the H100 and how the design
answers that.

The layout: packed [T, D, K] f32 (D = 21 + E, K % 128 == 0) holds tile
t's depth-sorted pair rows in columns 0..tile_count[t), the packed table's
zero sentinel row after them (ops/binning.padded_layout,
`pack_inputs`). K7 computes K1 `full`'s function on it, out [T, 12+E, 256]
and iout [T, 2, 256]; K8 the gradient of Σ gout·out with respect to
packed, d(packed) [T, D, K], zero from each tile's last contribution on.

`blend_fwd_padded` and `blend_bwd_padded` launch their kernels for CUDA
tensors (or raise) and run the plain versions for CPU tensors; each adds
one to LAUNCHES["K7"/"K8"] (cuda_build.LAUNCHES) where it launches.
`blend_padded_diff` is the differentiable entry (`BlendPaddedFunction`).
The gather from the per-gaussian table into packed (`pack_inputs`) is
plain torch, as the JAX package's is XLA, and so is its backward.
"""

from __future__ import annotations

import torch

from . import blend_visits as bv
from ..cuda_build import LAUNCHES, I, P, lib_fn, stream
from .binning import PAD_ALIGN


def pack_inputs(flat, tile_indices):
    """The per-gaussian packed table flat [N, D] gathered into the padded
    layout → packed [T, D, K], K = tile_indices' width: column k of tile t
    is flat[tile_indices[t, k]], zero where it holds the sentinel N.
    Differentiable in flat: only the real slots are gathered, so the
    backward adds each slot's gradient into its own gaussian's row and the
    padding's zeros go nowhere."""
    n, D = flat.shape
    T, K = tile_indices.shape
    real = tile_indices < n
    packed = flat.new_zeros((T, K, D))
    packed[real] = flat[tile_indices[real].long()]
    return packed.permute(0, 2, 1).contiguous()


def _as_flat(packed, tile_count):
    """The padded layout as the plain K1/K2 versions take it: one pair row
    per (tile, slot), tile t's range [t·K, t·K + count[t])."""
    T, D, K = packed.shape
    dev = packed.device
    flat = packed.permute(0, 2, 1).reshape(T * K, D)
    gid = torch.arange(T * K, dtype=torch.int32, device=dev)
    start = torch.arange(T, dtype=torch.int32, device=dev) * K
    return flat, gid, start, start + tile_count.to(torch.int32)


def blend_fwd_padded_reference(packed, tile_count, grid_x: int,
                               n_extra: int, count_work: bool = False):
    """The plain PyTorch version of K7: K1 `full`'s plain version, slot by
    slot over each tile's count[t] columns of packed, in the kernels'
    arithmetic and order. Returns (out [T, 12+E, 256], iout [T, 2, 256]),
    and with count_work K1's per-pixel work counts after them."""
    return bv.blend_fwd_reference(*_as_flat(packed, tile_count), grid_x,
                                  n_extra, count_work=count_work)


def blend_bwd_padded_reference(packed, tile_count, grid_x: int,
                               n_extra: int, gout, saved, iout,
                               count_work: bool = False):
    """The plain PyTorch version of K8: K2 `full`'s plain version back to
    front over each tile's count[t] columns → d(packed) [T, D, K], zero
    past each tile's slots with a contribution (and with count_work K2's
    work counts)."""
    T, D, K = packed.shape
    res = bv.blend_bwd_reference(*_as_flat(packed, tile_count), grid_x,
                                 n_extra, gout, saved, iout,
                                 count_work=count_work)
    d = res[0] if count_work else res
    d = d.reshape(T, K, D).permute(0, 2, 1).contiguous()
    return (d, res[1]) if count_work else d


def _check(name, packed, tile_count, n_extra):
    bv.check_width(name, n_extra, packed.device)
    if packed.dtype != torch.float32 or packed.dim() != 3 \
            or packed.shape[1] != 21 + n_extra \
            or packed.shape[2] % PAD_ALIGN or not packed.is_contiguous():
        raise ValueError(f"packed must be contiguous f32 [T, {21 + n_extra}, "
                         f"K] with K % {PAD_ALIGN} == 0, got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    bv._check_tiles("tile_count", tile_count, torch.int32,
                    (packed.shape[0],), packed.device)
    K = packed.shape[2]
    torch._assert_async(((tile_count >= 0) & (tile_count <= K)).all(),
                        f"tile_count must lie in [0, {K}]")


def blend_fwd_padded(packed, tile_count, grid_x: int, n_extra: int):
    """K7 → (out [T, 12+E, 256] f32, iout [T, 2, 256] i32), K1 `full`'s
    outputs for the padded layout (see blend_fwd_padded_reference).

    CUDA tensors launch csrc/blend_padded.cu, its blocks in the tiles'
    walk_order by count (and raise on anything it does not take); CPU
    tensors run the plain version. Forward only: for gradients call
    `blend_padded_diff`."""
    if torch.is_grad_enabled() and packed.requires_grad:
        raise ValueError("blend_fwd_padded is the forward kernel alone; call "
                         "blend_padded_diff() for gradients, or detach "
                         "packed")
    if packed.device.type == "cpu":
        return blend_fwd_padded_reference(packed, tile_count, grid_x,
                                          n_extra)
    if packed.device.type != "cuda":
        raise ValueError(f"blend_fwd_padded: unsupported device "
                         f"{packed.device}")
    _check("blend_fwd_padded", packed, tile_count, n_extra)
    T, _, K = packed.shape
    dev = packed.device
    out = torch.empty((T, 12 + n_extra, bv.P2), dtype=torch.float32,
                      device=dev)
    iout = torch.empty((T, 2, bv.P2), dtype=torch.int32, device=dev)
    order = bv.walk_order(tile_count)
    fn = lib_fn("blend_padded.cu", "blend_fwd_padded_launch",
                [P] * 2 + [I] * 4 + [P] * 4)
    with torch.cuda.device(dev):
        err = fn(packed.data_ptr(), tile_count.data_ptr(), T, K, grid_x,
                 n_extra, order.data_ptr(), out.data_ptr(), iout.data_ptr(),
                 stream(dev))
    if err != 0:
        raise RuntimeError(f"blend_fwd_padded kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["K7"] += 1
    return out, iout


def blend_bwd_padded(packed, tile_count, grid_x: int, n_extra: int, gout,
                     saved, iout):
    """K8 → d(packed) [T, D, K] f32 (see blend_bwd_padded_reference). gout
    [T, 12+E, 256] is the cotangent of K7's out, saved [T, 3, 256] out's
    final T, m1 and m2 rows, iout K7's.

    CUDA tensors launch csrc/blend_padded.cu (and raise on anything it does
    not take); CPU tensors run the plain version."""
    if packed.device.type == "cpu":
        return blend_bwd_padded_reference(packed, tile_count, grid_x,
                                          n_extra, gout, saved, iout)
    if packed.device.type != "cuda":
        raise ValueError(f"blend_bwd_padded: unsupported device "
                         f"{packed.device}")
    _check("blend_bwd_padded", packed, tile_count, n_extra)
    T, D, K = packed.shape
    dev = packed.device
    bv._check_tiles("gout", gout, torch.float32, (T, 12 + n_extra, bv.P2),
                    dev)
    bv._check_tiles("saved", saved, torch.float32, (T, 3, bv.P2), dev)
    bv._check_tiles("iout", iout, torch.int32, (T, 2, bv.P2), dev)
    d_packed = torch.empty((T, D, K), dtype=torch.float32, device=dev)
    fn = lib_fn("blend_padded.cu", "blend_bwd_padded_launch",
                [P] * 2 + [I] * 4 + [P] * 5)
    with torch.cuda.device(dev):
        err = fn(packed.data_ptr(), tile_count.data_ptr(), T, K, grid_x,
                 n_extra, gout.data_ptr(), saved.data_ptr(), iout.data_ptr(),
                 d_packed.data_ptr(), stream(dev))
    if err != 0:
        raise RuntimeError(f"blend_bwd_padded kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["K8"] += 1
    return d_packed


class BlendPaddedFunction(torch.autograd.Function):
    """Differentiable K7: forward runs blend_fwd_padded and saves out's
    final T, m1 and m2 rows with iout (blend_pallas.py:519-526); backward
    runs K8 and returns d(packed)."""

    @staticmethod
    def forward(ctx, packed, tile_count, grid_x, n_extra):
        out, iout = blend_fwd_padded(packed, tile_count, grid_x, n_extra)
        E = n_extra
        saved = torch.stack([out[:, 9], out[:, 10 + E], out[:, 11 + E]],
                            dim=1).contiguous()
        ctx.save_for_backward(packed, tile_count, saved, iout)
        ctx.grid_x, ctx.n_extra = grid_x, n_extra
        ctx.mark_non_differentiable(iout)
        return out, iout

    @staticmethod
    def backward(ctx, gout, _giout):
        packed, tile_count, saved, iout = ctx.saved_tensors
        d = blend_bwd_padded(packed, tile_count, ctx.grid_x, ctx.n_extra,
                             gout.contiguous(), saved, iout)
        return d, None, None, None


def blend_padded_diff(packed, tile_count, grid_x: int, n_extra: int):
    """Differentiable K7 over packed [T, D, K] → (out [T, 12+E, 256],
    iout [T, 2, 256]); gradients reach packed through K8 (and flat through
    pack_inputs' gather)."""
    return BlendPaddedFunction.apply(packed, tile_count, grid_x, n_extra)
