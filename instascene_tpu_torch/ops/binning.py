"""Tile binning: (gaussian, tile) pair expansion, fused tile|depth sort key,
per-tile [start, end) ranges.

Port of instascene_tpu/ops/binning.py:284-473 (`bin_gaussians`) without the
TPU's static shapes: every buffer is sized to the exact pair total (one
host read of tiles_touched.sum() per frame, as the CUDA reference does), so
there is no pair cap, no overflow count and no visit layout.

The pair order equals the JAX package's, since n_contrib counts every
binned slot: pairs expand gaussian-major in row-major rect order, and the
sort key is tile_id · 2^depth_bits + the gaussian's depth quantized over the
visible gaussians, with depth_bits = min(22, 31 − tile_bits), capped at
31 − bits_x − bits_y when bits_x + bits_y + 12 <= 31. The JAX sort is
unstable; this one is stable over the gid-ascending pair list, so key ties
go gid-ascending.

It also returns each gaussian's slots as one run, for the backward's
per-gaussian sum, without a second sort: the pairs expand gid-ascending and
a gaussian's tiles ascend in its rect's row-major order, so within a
gaussian the sort keeps its pairs in slot order, and the inverse of the
sort's permutation lists every gaussian's slots contiguously in slot order.

`select_tiles` (port of instascene_tpu/ops/binning.py:69-151,
`select_tiles_bundle`) lists a tile subset's slot ranges: K3/K4 take the
tile ids alone and walk each listed tile's whole cached range, so no mini
bundle is built and nothing is truncated; it reports what the JAX
package's capped bundle would have cut.

`merge_binnings` concatenates a window's views along the tile axis for
K1/K2's tiles_per_view mode (the layout of the JAX package's
pipelines/train_semantic.py:309-406, `_mv_full_loss_merged`).

Also ported: `dilate_rects` (:267-281) and `bin_gaussians(dilate_tiles=)`,
the cached superset a nearby camera renders through K1/K2's clip_rect
gate; the conic-culled expansion (:405-420: pair rank r of a gaussian maps
to the r-th set bit of its 64-bit keep-mask, preprocess.conic_cull_masks;
dilation turns culling off, as in JAX); and `padded_layout`, the padded
per-tile [T, K] index layout (layout="padded", :448-455) that K7/K8
(ops/blend_padded.py) read, with K sized to the frame's largest tile so
that no pair is dropped.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .preprocess import TILE, PreprocessOut, popcount32, word_of_i32
from ..utils.profiling import span

PAD_ALIGN = 128   # padded_layout's K is a multiple of this (the JAX chunk)


class BinningOut(NamedTuple):
    sorted_gid: torch.Tensor   # [total] int32 gaussian id per sorted slot
    tile_start: torch.Tensor   # [num_tiles] int32 first slot of each tile
    tile_end: torch.Tensor     # [num_tiles] int32 one past its last slot
    total_pairs: int
    # gaussian g's slots are gid_order[run_start[g]:run_start[g + 1]],
    # ascending
    gid_order: torch.Tensor    # [total] int32 slot of each gid-major pair
    run_start: torch.Tensor    # [N + 1] int32


def depth_bits_for(grid_x: int, grid_y: int) -> int:
    num_tiles = grid_x * grid_y
    tile_bits = max(int(math.ceil(math.log2(num_tiles + 2))), 1)
    depth_bits = min(22, 31 - tile_bits)
    bits_x = max(int(math.ceil(math.log2(grid_x + 1))), 1)
    bits_y = max(int(math.ceil(math.log2(grid_y + 1))), 1)
    if bits_x + bits_y + 12 <= 31:
        depth_bits = min(depth_bits, 31 - bits_x - bits_y)
    return depth_bits


def dilate_rects(rect_min: torch.Tensor, rect_max: torch.Tensor,
                 tiles_touched: torch.Tensor, grid_x: int, grid_y: int,
                 dilate_tiles: int):
    """Expand visible gaussians' tile rects by `dilate_tiles` per side,
    clamped to the grid, and recount tiles_touched. Invisible gaussians
    (tiles_touched == 0) stay empty: dilation does not resurrect culled
    splats. Returns (rect_min, rect_max, tiles_touched)."""
    vis = tiles_touched > 0
    gmax = torch.tensor([grid_x, grid_y], dtype=rect_max.dtype,
                        device=rect_max.device)
    rmin = torch.where(vis[:, None],
                       torch.clamp(rect_min - dilate_tiles, min=0), rect_min)
    rmax = torch.where(vis[:, None],
                       torch.minimum(rect_max + dilate_tiles, gmax), rect_max)
    tiles = (rmax[:, 0] - rmin[:, 0]) * (rmax[:, 1] - rmin[:, 1])
    return rmin, rmax, torch.where(vis, tiles, 0).to(torch.int32)


def _culled_offsets(rank: torch.Tensor, m0: torch.Tensor,
                    m1: torch.Tensor) -> torch.Tensor:
    """Row-major rect offset of each pair of rank `rank` under its
    gaussian's keep-mask words m0 (offsets 0..31) and m1 (32..63), uint32
    bits in int64: the rank-th set bit, found by halving; ranks past the
    mask's population map linearly onto the offsets >= 64, which are all
    kept."""
    p0 = popcount32(m0)
    ptot = p0 + popcount32(m1)
    in_win = rank < ptot
    use_hi = rank >= p0
    word = torch.where(use_hi, m1, m0)
    r = rank - torch.where(use_hi, p0, 0)
    pos = torch.zeros_like(rank)
    for half in (16, 8, 4, 2, 1):
        cnt = popcount32(word & ((1 << half) - 1))
        go_hi = r >= cnt
        word = torch.where(go_hi, word >> half, word)
        r = r - torch.where(go_hi, cnt, 0)
        pos = pos + torch.where(go_hi, half, 0)
    return torch.where(in_win, pos + torch.where(use_hi, 32, 0),
                       64 + rank - ptot)


def bin_gaussians(pre: PreprocessOut, width: int, height: int,
                  dilate_tiles: int = 0) -> BinningOut:
    """dilate_tiles > 0 expands every visible gaussian's tile rect by that
    many tiles per side (dilate_rects): a SUPERSET binning, valid for any
    nearby camera whose fresh rects stay inside the dilated ones, rendered
    exactly through K1/K2's clip_rect gate. With pre's conic-cull masks
    (preprocess_gaussians(conic_cull=True)) and no dilation, each
    gaussian's pairs cover only its kept rect offsets."""
    with span("binning"):
        dev = pre.depth.device
        grid_x = (width + TILE - 1) // TILE
        grid_y = (height + TILE - 1) // TILE
        num_tiles = grid_x * grid_y
        n = pre.depth.shape[0]

        tiles_touched = pre.tiles_touched.detach()
        rect_min, rect_max = pre.rect_min, pre.rect_max
        if dilate_tiles:
            rect_min, rect_max, tiles_touched = dilate_rects(
                rect_min, rect_max, tiles_touched, grid_x, grid_y,
                dilate_tiles)
        depth = pre.depth.detach()
        total = int(tiles_touched.sum())          # the frame's one host read
        if total == 0:
            z = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
            none = torch.zeros(0, dtype=torch.int32, device=dev)
            return BinningOut(none, z, z.clone(), 0, none.clone(),
                              torch.zeros(n + 1, dtype=torch.int32,
                                          device=dev))

        depth_bits = depth_bits_for(grid_x, grid_y)
        g_valid = tiles_touched > 0
        inf = torch.tensor(float("inf"), device=dev)
        dmin = torch.min(torch.where(g_valid, depth, inf))
        dmax = torch.max(torch.where(g_valid, depth, -inf))
        dqg = torch.clamp((depth - dmin) / torch.clamp(dmax - dmin, min=1e-12),
                          0.0, 1.0)
        dqg = torch.clamp((dqg * float((1 << depth_bits) - 1)).to(torch.int32),
                          0, (1 << depth_bits) - 1)

        # interval expand: slot j of gaussian g covers rect offset
        # j - offset[g]
        counts = tiles_touched.to(torch.int64)
        offsets = torch.cumsum(counts, 0) - counts
        gid = torch.repeat_interleave(torch.arange(n, device=dev), counts,
                                      output_size=total)
        rank = torch.arange(total, device=dev) - offsets[gid]
        if pre.cull_lo is not None and not dilate_tiles:
            rank = _culled_offsets(rank, word_of_i32(pre.cull_lo)[gid],
                                   word_of_i32(pre.cull_hi)[gid])
        rmin = rect_min.to(torch.int64)[gid]
        rw = torch.clamp(rect_max[:, 0] - rect_min[:, 0],
                         min=1).to(torch.int64)[gid]
        dy = rank // rw
        dx = rank - dy * rw
        tile_id = (rmin[:, 1] + dy) * grid_x + (rmin[:, 0] + dx)

        key = tile_id * (1 << depth_bits) + dqg.to(torch.int64)[gid]
        sorted_key, order = torch.sort(key, stable=True)
        sorted_gid = gid[order].to(torch.int32)
        bounds = torch.searchsorted(
            sorted_key >> depth_bits,
            torch.arange(num_tiles + 1, dtype=torch.int64, device=dev),
            side="left").to(torch.int32)
        gid_order = torch.empty(total, dtype=torch.int32, device=dev)
        gid_order[order] = torch.arange(total, dtype=torch.int32, device=dev)
        run_start = torch.cat([offsets, offsets.new_tensor([total])])
        return BinningOut(sorted_gid=sorted_gid,
                          tile_start=bounds[:-1].contiguous(),
                          tile_end=bounds[1:].contiguous(), total_pairs=total,
                          gid_order=gid_order,
                          run_start=run_start.to(torch.int32))


def padded_layout(binning: BinningOut):
    """The padded per-tile layout of a binning → (tile_indices [T, K]
    int32, tile_count [T] int32): row t lists tile t's gaussians in its
    visit (depth) order, then the sentinel N (the packed table's zero row,
    ops/blend_padded.pack_inputs). K is the largest tile's count rounded up
    to PAD_ALIGN (at least PAD_ALIGN), read on the host, so no pair is
    dropped (the JAX package's fixed tile_cap drops the excess and counts
    it in n_dropped)."""
    n = binning.run_start.shape[0] - 1
    count = (binning.tile_end - binning.tile_start).to(torch.int32)
    longest = int(count.max()) if count.numel() else 0
    K = max(1, -(-longest // PAD_ALIGN)) * PAD_ALIGN
    dev = count.device
    k = torch.arange(K, dtype=torch.int64, device=dev)
    real = k[None, :] < count[:, None]
    if binning.total_pairs == 0:
        return (torch.full((count.shape[0], K), n, dtype=torch.int32,
                           device=dev), count)
    pos = torch.clamp(binning.tile_start.to(torch.int64)[:, None] + k[None],
                      max=binning.total_pairs - 1)
    idx = torch.where(real, binning.sorted_gid[pos], n)
    return idx.to(torch.int32).contiguous(), count.contiguous()


class TileSelection(NamedTuple):
    tile_ids: torch.Tensor       # [K] int32, ascending, unique
    tile_start: torch.Tensor     # [K] int32 their slot ranges
    tile_end: torch.Tensor
    # chunks the JAX package's mini bundle would truncate (a 0-d tensor)
    jax_capped_chunks: torch.Tensor


def select_tiles(sel_tiles: torch.Tensor, binning: BinningOut,
                 chunk: int = 128, chunks_per_tile: int = 8
                 ) -> TileSelection:
    """The tiles sel_tiles [K] (ascending, unique) of `binning`, as K3/K4
    walk them (ops/blend_visits.blend with tile_ids=, which takes the ids
    alone): their ids as a contiguous int32 vector, their slot ranges, and
    the number of `chunk`-pair chunks that the JAX package's
    select_tiles_bundle would cut: it gives each selected tile at most
    chunk_cap // K chunks (chunk_cap = 8·K in its trainer,
    pipelines/train_semantic.py:279-281) and drops the deepest beyond
    them. Here nothing is cut; the ranges and the count are for
    measurement and the record."""
    ids = sel_tiles.to(device=binning.tile_start.device,
                       dtype=torch.int32).contiguous()
    start = binning.tile_start[ids.long()]
    end = binning.tile_end[ids.long()]
    full = (end - start + chunk - 1) // chunk
    capped = (full - full.clamp(max=chunks_per_tile)).sum()
    return TileSelection(ids, start, end, capped)


def merge_binnings(views) -> tuple:
    """A window's views [(flat [N, D], BinningOut)] (one scene, one frame
    size) as one frame of V·T tiles for K1/K2's tiles_per_view mode →
    (flat [V·N, D], BinningOut, T): view v's pair list offset by v·N, its
    tile ranges and per-gaussian runs by the pairs of the views before it,
    run_start closed by the total. Autograd reaches the flats."""
    n = views[0][0].shape[0]
    gid, start, end, order, run = [], [], [], [], []
    off = 0
    for v, (_, b) in enumerate(views):
        gid.append(b.sorted_gid + v * n)
        start.append(b.tile_start + off)
        end.append(b.tile_end + off)
        order.append(b.gid_order + off)
        run.append(b.run_start[:-1] + off)
        off += b.total_pairs
    run.append(run[0].new_tensor([off]))
    merged = BinningOut(torch.cat(gid), torch.cat(start), torch.cat(end),
                        off, torch.cat(order), torch.cat(run))
    return (torch.cat([f for f, _ in views]), merged,
            views[0][1].tile_start.shape[0])
