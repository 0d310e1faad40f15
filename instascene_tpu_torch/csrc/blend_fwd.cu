// Forward alpha-compositing blend of 2DGS surfels, one 16x16 tile per block.
//
// Replaces the TPU kernel instascene_tpu/ops/blend_visits.py::_fwd_kernel_visits
// (K1) in its `full`, `viewer`, `no_dist`, `extras_only` (with the optional
// sampled-pixel done0 mask), `track`, `clip_rect` and `tiles_per_view`
// modes, and instascene_tpu/ops/blend_pallas.py::_fwd_kernel_aligned (K3)
// over a tile-subset mini bundle, in every mode. The walk is
// csrc/blend_walk.cuh's blend_fwd_kernel over FlatRows (K7 walks the same
// code over the padded layout). Same function, same public layout:
//   out  [num_tiles, 12+E, 256] f32: 0:3 color (no background), 3 expected
//        depth sum, 4:7 view normal, 7 median depth, 8 distortion, 9 final T,
//        10:10+E features, 10+E / 11+E the m1 / m2 totals
//   iout [num_tiles, 2, 256] i32: n_contrib (1-based within-tile slot of the
//        last contributor; every binned slot counts) and the median's slot.
// `viewer` writes color, final T, features and n_contrib; its other rows are
// exact zeros. `no_dist` skips the depth sum, the distortion and the m1/m2
// sums (rows 3, 8, 10+E, 11+E are exact zeros); every other row and iout are
// as `full` computes them. `extras_only` (the semantic step) accumulates the
// E features alone and writes final T, the features and n_contrib; every
// other row and iout row 1 are exact zeros. Its optional done0 [T, 256] i32
// pre-latches every pixel where it is non-zero (the loss reads only the few
// sampled pixels of a tile): such a pixel comes back T = 1, zero features,
// n_contrib 0, and the block leaves as soon as its unlatched pixels latch.
// A sampled pixel's values are bit for bit those of `full` (a pixel's blend
// does not depend on its neighbours). `track` is `full` plus the contributor
// buffer: each contribution with w > 0.1 writes its gaussian id
// (sorted_gid) and w into the pixel's next of TRACK_K = 10 slots, in blend
// order; empty slots are -1 and 0 (ids, w [T, 10, 256]).
//
// `clip_rect` (a flag beside `full`, `viewer`, `no_dist` and `extras_only`,
// not `track`): flat carries 4 trailing columns, each gaussian's fresh tile
// rect (rmin_x, rmax_x, rmin_y, rmax_y), and a pair contributes only where
// its tile lies in that rect. A cached superset pair list (a binning
// dilated at a nearby camera, ops/binning.py) then blends exactly as the
// fresh binning's pairs: the gated slots contribute nothing, though they
// keep their slot numbers (n_contrib counts them). Feature widths: E = 0
// and 16 are compiled as constants; any other E >= 1 runs the run-time-width
// instantiation (blend_walk.cuh), with the same values, up to the widest
// whose rows fit the device's shared memory (csrc/smem.cuh).
//
// Two arguments select the tiles and their pixels, in every mode:
//   * tile_ids [K] (K3; null: every tile): block b renders tile tile_ids[b]
//     over that tile's cached range and writes row b of out/iout (and of the
//     track buffers), so out is [K, 12+E, 256]; done0 stays indexed by tile.
//     A listed tile's values are bit for bit those of the whole frame's
//     (a tile's blend does not depend on other tiles). The JAX package's
//     mini bundle caps each selected tile at 8 chunks of 128 pairs; here a
//     block walks its tile's whole range, so nothing is truncated.
//   * tiles_per_view (K1 merged multi-view; 0: off): the tile space is
//     several views' grids concatenated (their pair lists and ranges offset
//     by the caller), and the pixel coordinates come from the view-local
//     tile t % tiles_per_view, so every view's values are bit for bit its
//     own render's. sorted_gid then indexes the concatenated tables
//     (V·N rows): the row offset is taken in size_t.
// K3 and merged rendering serve the semantic step's multi-view loss: on
// the 976x728 frame K3 renders 128 tiles of each of 5 views (extras_only),
// the merged launch all 5 · 2,806 tiles. Their bounds are K1's for the
// tiles they walk.
//
// Design. The TPU kernel walks a sequential grid of (chunk, tile) visits,
// carries T/m1/m2/done in VMEM scratch and turns the per-slot recurrence
// into log-step cumprods over 128-slot chunks. On Hopper the blocks run in
// parallel and each pixel owns a thread, so the recurrence stays a plain
// sequential loop (the CUDA reference's design): one block of 256 threads
// per tile, one thread per pixel. The block walks its tile's [start, end)
// range of the depth-sorted pair list in batches of 128 pairs; each batch's
// rows are gathered flat[sorted_gid[j]] straight into shared memory by
// cp.async while the previous batch is walked (the gather is fused: no
// packed [pairs, 21+E] copy is ever written), and every thread then walks
// the batch in order, a few slots evaluated ahead of the recurrence. A
// pixel latches done when a contribution would take T below 1e-4 (that
// contribution is dropped); the block leaves once all 256 pixels are done
// (__syncthreads_count). The blocks take the tiles longest range first
// (order, from the wrapper's stable argsort): the largest tile of the
// 976x728 bench frame holds 4,341 pairs against a mean of 279, and in
// raster order the heaviest started in late waves. csrc/blend_walk.cuh
// says why each piece is there.
//
// What bounds it on the H100: FP32 arithmetic. Each (pair, pixel) evaluation
// is 41 FP32 operations with one expf (the splat and its mask), each
// contribution 10 + 2E more (+25 in `full`, +10 in `no_dist`). At 1080p on
// the 300k-gaussian benchmark scene a frame needs ~0.2 G evaluations and
// ~0.05 G contributions, ~10 GFLOP, against ~0.3 GB that must cross HBM (the
// packed table, pair list and outputs): ~0.15 ms of FP32 issue against
// ~0.09 ms of memory (chip_smoke.py counts both per run). The design keeps
// the evaluation in registers, the rows in shared memory (broadcast reads:
// every thread of the block reads the same row), and stops each pixel at its
// done latch and each block when all its pixels are done.
//
// `extras_only` with done0 on the semantic step's frame (976x728, 32k
// sampled pixels, ~16 per tile): the FP32 work shrinks to the sampled
// pixels' evaluations, so the bytes bound it — the packed rows of each
// tile's walked range, which every block still gathers into shared memory
// until its few sampled pixels latch (or its range ends), and the outputs.
// The design keeps the fused gather and stops each block at its last
// sampled pixel's latch. `track` adds at most 10 scattered id/weight
// stores per pixel to `full`'s work: FP32 issue bounds it as `full`.
//
// Rounding: see splat.cuh. The plain PyTorch version
// (ops/blend_visits.py::blend_fwd_reference) sums in the same order.

#include <cuda_runtime.h>

#include "blend_walk.cuh"

namespace {

using namespace walk;

struct Args {
  const float* flat;
  const int* sorted_gid;
  const int* tile_start;
  const int* tile_end;
  int grid_x;
  int n_extra;
  const int* tile_ids;
  int tiles_per_view;
  const long long* order;
  const int* done0;
  float* out;
  int* iout;
  int* track_ids;
  float* track_w;
};

template <int ET, int MODE, bool CLIP>
cudaError_t launch_mode(const Args& a, int num_rows, cudaStream_t stream) {
  const FlatRows src{a.flat, a.sorted_gid, a.tile_start, a.tile_end};
  auto* kernel = blend_fwd_kernel<ET, MODE, CLIP, FlatRows>;
  const int D = 21 + a.n_extra + (CLIP ? RECT : 0);
  int batch = FWD_BATCH;
  size_t bytes = 0;
  if (ET < 0) {
    const cudaError_t err = fwd_staging(kernel, D, batch, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<num_rows, P2, bytes, stream>>>(
      src, a.n_extra, batch, a.grid_x, a.order, a.tile_ids, a.tiles_per_view,
      a.done0, a.out, a.iout, a.track_ids, a.track_w);
  return cudaGetLastError();
}

template <int ET>
cudaError_t launch(int mode, bool clip, const Args& a, int num_rows,
                   cudaStream_t stream) {
  if (a.done0 != nullptr && mode != EXTRAS) return cudaErrorInvalidValue;
  if (mode == TRACK && (clip || a.track_ids == nullptr ||
                        a.track_w == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t (*fn)(const Args&, int, cudaStream_t) =
      mode == FULL      ? (clip ? launch_mode<ET, FULL, true>
                                : launch_mode<ET, FULL, false>)
      : mode == VIEWER  ? (clip ? launch_mode<ET, VIEWER, true>
                                : launch_mode<ET, VIEWER, false>)
      : mode == NO_DIST ? (clip ? launch_mode<ET, NO_DIST, true>
                                : launch_mode<ET, NO_DIST, false>)
      : mode == EXTRAS  ? (clip ? launch_mode<ET, EXTRAS, true>
                                : launch_mode<ET, EXTRAS, false>)
      : mode == TRACK   ? launch_mode<ET, TRACK, false>
                        : nullptr;
  if (fn == nullptr) return cudaErrorInvalidValue;
  return fn(a, num_rows, stream);
}

}  // namespace

// Plain C entry point for ctypes. Returns a cudaError_t (0 = launched).
// num_rows blocks: the length of tile_ids, or the number of tiles when
// tile_ids is null. order [num_rows] int64: the rows longest range first
// (block b walks row order[b]; ops/blend_visits.walk_order). tiles_per_view
// 0 is off. done0 may be null (required
// null outside extras_only); track_ids and track_w are read only in track
// mode. clip_rect 1: flat has 21 + n_extra + 4 columns (not with track).
// n_extra: 0 <= E <= blend_fwd_max_width().
extern "C" int blend_fwd_launch(const float* flat, const int* sorted_gid,
                                const int* tile_start, const int* tile_end,
                                int num_rows, int grid_x, int n_extra,
                                int mode, int clip_rect, const int* tile_ids,
                                int tiles_per_view, const long long* order,
                                const int* done0, float* out, int* iout,
                                int* track_ids, float* track_w,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows <= 0) return (int)cudaSuccess;
  if (order == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{flat,     sorted_gid, tile_start, tile_end, grid_x,
               n_extra,  tile_ids,   tiles_per_view,       order,
               done0,    out,        iout,       track_ids, track_w};
  const bool clip = clip_rect != 0;
  if (n_extra == 16) return (int)launch<16>(mode, clip, a, num_rows, st);
  if (n_extra == 0) return (int)launch<0>(mode, clip, a, num_rows, st);
  if (n_extra > 0) return (int)launch<DYN_E>(mode, clip, a, num_rows, st);
  return (int)cudaErrorInvalidValue;
}

// The widest n_extra blend_fwd_launch takes on the current device: one row
// per buffer at clip_rect's width, beside track's static arrays (the
// largest). -1 where the device cannot be queried.
extern "C" int blend_fwd_max_width(void) {
  const int left = smem::optin_left(
      blend_fwd_kernel<DYN_E, TRACK, false, FlatRows>);
  return left > 0 ? fwd_max_width(left) : -1;
}
