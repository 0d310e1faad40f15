// Backward of the 2DGS surfel blend (K2), one 16x16 tile per block, and the
// deterministic per-gaussian segment sum that follows it.
//
// Replaces the TPU kernel instascene_tpu/ops/blend_visits.py::_bwd_kernel_visits
// (K2) in its `full`, `no_dist`, `extras_only`, `clip_rect` and
// `tiles_per_view` modes, instascene_tpu/ops/blend_pallas.py::
// _bwd_kernel_aligned (K4) over a tile-subset mini bundle (`full`,
// `no_dist`, `extras_only`), and the scatter-add of K2's custom VJP
// (:729-736). The walk is csrc/blend_walk.cuh's blend_bwd_kernel over
// FlatRows (K8 walks the same code over the padded layout). Inputs: the packed table flat [N, 21+E], the depth-sorted
// pair list and tile ranges K1 blended, gout [T, 12+E, 256] (the cotangent
// of K1's out), saved [T, 3, 256] (out's final T, m1 and m2 rows) and K1's
// iout [T, 2, 256] (n_contrib, med_slot). Output d_sorted [pairs, 21+E]: per
// slot, the gradient of Σ gout·out with respect to that slot's packed row.
// `no_dist` leaves out the expected-depth and distortion chains (gD and gdist
// never enter; the depth gradient is the median tap alone). `extras_only`
// (the semantic step, blend_visits.py:473-478) emits only the E feature
// columns, d_sorted [pairs, E]: per slot the block recomputes the splat, takes
// the slot where K1's mask holds and slot <= n_contrib, recovers T before it
// as T_after / (1 - alpha) back to front from the saved final T, and reduces
// w · gout[10+e] over the tile's pixels. It needs no suffix sum, no dL/dalpha
// and no geometry column; pixels a done0 mask latched have n_contrib 0 and
// take no part.
//
// `clip_rect`: flat's 4 trailing rect columns gate each slot as in K1
// (blend_fwd.cu); the output rows carry 4 zero columns for them (in
// `extras_only` the wrapper pads d_flat to flat's width). E = 0 and 16 are
// compiled as constants, any other E in [1, 256] runs the run-time-width
// instantiation (blend_walk.cuh).
//
// tile_ids [K] and tiles_per_view select tiles and pixel coordinates as in
// blend_fwd.cu: block b walks tile tile_ids[b] and reads row b of gout,
// saved and iout (K4; the JAX package's mini bundle caps a tile at 8 chunks
// of 128 pairs, this walks the whole range); merged views take their pixel
// coordinates from t % tiles_per_view. Each block writes only its own
// tile's d_sorted rows, so with a tile list the caller zeroes d_sorted and
// the rows of unlisted tiles stay 0: the segment sum over the cached runs
// then adds exact zeros for them, and the result is as deterministic as
// the whole frame's.
//
// Design. The TPU kernel re-walks its (chunk, tile) visits in reverse on a
// sequential grid, recovers T per 128-slot visit as T_exit / P_in (a
// cumprod) and carries the suffix sum in VMEM. Here, as in K1, one block of
// 256 threads owns a tile and one thread a pixel; the pixel's gout rows,
// final T, m1/m2 totals, n_contrib and median slot sit in registers. The
// block takes its tile's largest n_contrib and walks the slots from there
// back to front, in batches gathered flat[sorted_gid[j]] into shared memory
// (fused, no packed copy). Per slot each thread recomputes the splat exactly
// as K1 does (splat.cuh), so its mask matches the forward bit for bit; the
// slot takes part where that mask holds and slot <= n_contrib (a
// contribution that would have taken T below 1e-4 never happened). T before
// the slot is recovered by one division, T_after / (1 - alpha), and the
// suffix sum S of dL/dw·w over later slots is carried. Every slot belongs to
// one tile, so the block reduces the slot's 21+E column contributions over
// its 256 pixels — butterfly shuffles in each warp (skipped by warps with no
// contribution), then the 8 warp partials from shared memory summed in a
// fixed order — and writes the row once with a plain store: no atomics, the
// same bits on every run. Slots past the tile's largest n_contrib get zero
// rows.
//
// What bounds it on the H100: instruction issue. Each evaluated (slot,
// pixel) pair is K1's 41-operation splat; each contribution 54 + 3E more
// FP32 operations (25 more in `full`); and each reduced slot costs 5 · (21+E)
// shuffles per warp plus a block barrier, whatever the number of pixels that
// contributed. The bytes (the packed rows of the tile's pairs, gout, saved,
// iout and d_sorted) are a few hundred MB at the benchmark's sizes, well
// under a millisecond of HBM time. The design keeps everything per pixel in
// registers, stops each tile at its largest n_contrib, lets warps without a
// contribution skip the shuffles, and needs one barrier per slot
// (double-buffered partials). chip_smoke.py computes the bound per run.
// `extras_only` does K1's splat and 5 + E operations per contribution, then
// E shuffle reductions per slot: on the semantic frame (976x728, E = 16) it
// is bound by the same instruction issue, with E columns where the other
// modes reduce 21 + E.
//
// The segment sum: d_flat[g] = Σ d_sorted[s] over g's slots, in slot order
// from 0, one thread per (gaussian, column) over the runs that binning lists
// (gid_order, run_start: ops/binning.py). Deterministic; its plain version
// is an index_add_ in slot order on the CPU.
//
// Rounding: see splat.cuh. The plain PyTorch version is
// ops/blend_visits.py::blend_bwd_reference; per pixel it computes the same
// values in the same order, and only the sums over pixels differ in order.

#include <cuda_runtime.h>

#include "blend_walk.cuh"

namespace {

using namespace walk;

__global__ void segment_sum_kernel(const float* __restrict__ d_sorted,
                                   const int* __restrict__ gid_order,
                                   const int* __restrict__ run_start, int n,
                                   int D, float* __restrict__ d_flat) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n * D) return;
  const int g = (int)(i / D);
  const int c = (int)(i - (long long)g * D);
  float acc = 0.f;
  const int end = run_start[g + 1];
  for (int r = run_start[g]; r < end; ++r)
    acc = acc + d_sorted[(size_t)gid_order[r] * D + c];
  d_flat[i] = acc;
}

struct Args {
  const float* flat;
  const int* sorted_gid;
  const int* tile_start;
  const int* tile_end;
  int grid_x;
  int n_extra;
  const int* tile_ids;
  int tiles_per_view;
  const float* gout;
  const float* saved;
  const int* iout;
  float* d_sorted;
};

template <int ET, int MODE, bool CLIP>
void launch_mode(const Args& a, int num_rows, cudaStream_t stream) {
  const FlatRows src{a.flat, a.sorted_gid, a.tile_start, a.tile_end};
  const int D = 21 + a.n_extra + (CLIP ? RECT : 0);
  const int DO = MODE == B_EXTRAS ? a.n_extra : D;
  const int batch = ET < 0 ? bwd_batch(D, DO) : BATCH;
  const size_t smem =
      ET < 0 ? (size_t)(batch * D + 2 * NW * DO) * sizeof(float) : 0;
  blend_bwd_kernel<ET, MODE, CLIP, FlatRows><<<num_rows, P2, smem, stream>>>(
      src, a.n_extra, batch, a.grid_x, a.tile_ids, a.tiles_per_view, a.gout,
      a.saved, a.iout, a.d_sorted);
}

template <int ET, bool CLIP>
cudaError_t launch_clip(int mode, const Args& a, int num_rows,
                        cudaStream_t stream) {
  if (mode == B_FULL)
    launch_mode<ET, B_FULL, CLIP>(a, num_rows, stream);
  else if (mode == B_NO_DIST)
    launch_mode<ET, B_NO_DIST, CLIP>(a, num_rows, stream);
  else if (mode == B_EXTRAS && ET != 0)
    launch_mode<ET, B_EXTRAS, CLIP>(a, num_rows, stream);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <int ET>
cudaError_t launch(int mode, bool clip, const Args& a, int num_rows,
                   cudaStream_t stream) {
  return clip ? launch_clip<ET, true>(mode, a, num_rows, stream)
              : launch_clip<ET, false>(mode, a, num_rows, stream);
}

}  // namespace

// Plain C entry points for ctypes. Each returns a cudaError_t (0 = launched).
// blend_bwd_launch: num_rows blocks, as blend_fwd_launch; clip_rect 1:
// flat has 21 + n_extra + 4 columns. n_extra: 0 <= E <= 256 (E > 0 in
// extras_only).
extern "C" int blend_bwd_launch(const float* flat, const int* sorted_gid,
                                const int* tile_start, const int* tile_end,
                                int num_rows, int grid_x, int n_extra,
                                int mode, int clip_rect, const int* tile_ids,
                                int tiles_per_view, const float* gout,
                                const float* saved, const int* iout,
                                float* d_sorted, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows <= 0) return (int)cudaSuccess;
  const Args a{flat,     sorted_gid, tile_start,     tile_end,
               grid_x,   n_extra,    tile_ids,       tiles_per_view,
               gout,     saved,      iout,           d_sorted};
  const bool clip = clip_rect != 0;
  if (n_extra == 16) return (int)launch<16>(mode, clip, a, num_rows, st);
  if (n_extra == 0) return (int)launch<0>(mode, clip, a, num_rows, st);
  if (n_extra > 0 && n_extra <= MAX_E)
    return (int)launch<DYN_E>(mode, clip, a, num_rows, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int segment_sum_launch(const float* d_sorted, const int* gid_order,
                                  const int* run_start, int n, int D,
                                  float* d_flat, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n * D;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  segment_sum_kernel<<<(unsigned)blocks, threads, 0, st>>>(
      d_sorted, gid_order, run_start, n, D, d_flat);
  return (int)cudaGetLastError();
}
