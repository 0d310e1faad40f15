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
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .preprocess import TILE, PreprocessOut


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


def bin_gaussians(pre: PreprocessOut, width: int, height: int) -> BinningOut:
    dev = pre.depth.device
    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    num_tiles = grid_x * grid_y
    n = pre.depth.shape[0]

    tiles_touched = pre.tiles_touched.detach()
    depth = pre.depth.detach()
    total = int(tiles_touched.sum())          # the frame's one host read
    if total == 0:
        z = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
        none = torch.zeros(0, dtype=torch.int32, device=dev)
        return BinningOut(none, z, z.clone(), 0, none.clone(),
                          torch.zeros(n + 1, dtype=torch.int32, device=dev))

    depth_bits = depth_bits_for(grid_x, grid_y)
    g_valid = tiles_touched > 0
    inf = torch.tensor(float("inf"), device=dev)
    dmin = torch.min(torch.where(g_valid, depth, inf))
    dmax = torch.max(torch.where(g_valid, depth, -inf))
    dqg = torch.clamp((depth - dmin) / torch.clamp(dmax - dmin, min=1e-12),
                      0.0, 1.0)
    dqg = torch.clamp((dqg * float((1 << depth_bits) - 1)).to(torch.int32),
                      0, (1 << depth_bits) - 1)

    # interval expand: slot j of gaussian g covers rect offset j - offset[g]
    counts = tiles_touched.to(torch.int64)
    offsets = torch.cumsum(counts, 0) - counts
    gid = torch.repeat_interleave(torch.arange(n, device=dev), counts,
                                  output_size=total)
    rank = torch.arange(total, device=dev) - offsets[gid]
    rmin = pre.rect_min.to(torch.int64)[gid]
    rw = torch.clamp(pre.rect_max[:, 0] - pre.rect_min[:, 0],
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
    return BinningOut(sorted_gid=sorted_gid, tile_start=bounds[:-1].contiguous(),
                      tile_end=bounds[1:].contiguous(), total_pairs=total,
                      gid_order=gid_order,
                      run_start=run_start.to(torch.int32))


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
