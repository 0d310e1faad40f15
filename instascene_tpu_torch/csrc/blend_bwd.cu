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
// back to front, in batches of 128 gathered flat[sorted_gid[j]] into shared
// memory (fused, no packed copy). Per slot each thread recomputes the splat
// exactly as K1 does (splat.cuh), so its mask matches the forward bit for
// bit; the slot takes part where that mask holds and slot <= n_contrib (a
// contribution that would have taken T below 1e-4 never happened). T before
// the slot is recovered by one division, T_after / (1 - alpha), and the
// suffix sum S of dL/dw·w over later slots is carried. Every slot belongs to
// one tile, so the block reduces the slot's 21+E column contributions over
// its 256 pixels and writes the row once with a plain store: no atomics, the
// same bits on every run. Slots past the tile's largest n_contrib get zero
// rows.
//
// What bounded the first design on the H100: warp shuffles. Each warp with
// a contribution reduced each of its NC columns (21, or 16 in
// `extras_only` at E = 16, 37 in `full` at E = 16) with its own butterfly,
// 5 · NC shuffles per slot, and an SM issues one warp shuffle per clock (a
// quarter of its FADD rate): 105 shuffles per warp per slot put K2
// `no_dist` at ~3 ms on 782k slots. A block barrier per slot and a row
// store by the first DO threads alone, while the others waited, came on
// top. The design now:
//   * a reduce-scatter across the warp (blend_walk.cuh::scatter_reduce):
//     each level halves the list of columns a lane holds, one shuffle per
//     pair of columns, 23 shuffles for 21 columns, 16 for 16, 39 for 37;
//     each kept sum is the butterfly's, so the bits are unchanged;
//   * the warp partials of 8 consecutive slots, double-buffered, share one
//     barrier, after which all 256 threads sum each (slot, column)'s 8
//     partials in the order w0 .. w7 and store the group's rows in one
//     contiguous pass.
// What is left per evaluated (slot, pixel) is K1's 41-operation splat and,
// per contribution, 54 + 3E more FP32 operations (25 more in `full`;
// `extras_only` 5 + E): instruction issue. The bytes (the packed rows of
// the tile's pairs, gout, saved, iout and d_sorted) are a few hundred MB at
// the benchmark's sizes, well under a millisecond of HBM time.
// chip_smoke.py computes the bound per run. The run-time width keeps a
// butterfly per feature column (its bits are the same either way).
//
// The segment sum: d_flat[g] = Σ d_sorted[s] over g's slots, in slot order
// from 0, over the runs that binning lists (gid_order, run_start:
// ops/binning.py). Deterministic; its plain version is an index_add_ in
// slot order on the CPU, and the kernel's result is that version's bits.
// What bounds it is latency, not bytes. On the 300k bench frame (976x728)
// the runs have a mean length of 2.7 slots but reach 525. One thread per
// (gaussian, column) walking its run with two dependent loads per slot
// (gid_order[r], then the row) had few loads in flight per SM in the
// bulk and a chain of 1,050 loads in the longest run; it took ~0.15 ms on
// an H100 at D = 21 and D = 16 alike, slower than index_add_. A warp per
// gaussian with its rows loaded ahead still left each warp a chain of
// dependent phases (run bounds, indices, rows, store) for ~3 slots of
// work, and was no faster. The design now: a block takes a batch of
// B = 1024 / D consecutive gaussians, whose runs are one contiguous range
// of gid_order; it stages that range in chunks, first the slot indices,
// then every row of the chunk at once (cp.async, one 4-byte copy per
// element: up to 24 KB of requests in flight per block), and each thread
// then adds the staged rows of its 4 (gaussian, column) sums in slot
// order. A batch costs ~3 load latencies per chunk, and a 525-slot run
// is 2-3 chunks.
//
// Rounding: see splat.cuh. The plain PyTorch version is
// ops/blend_visits.py::blend_bwd_reference; per pixel it computes the same
// values in the same order, and only the sums over pixels differ in order.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "blend_walk.cuh"

namespace {

using namespace walk;

constexpr int SEG_THREADS = 256;
constexpr int SEG_PAIRS = 4;           // (gaussian, column) sums per thread
constexpr int SEG_SMEM = 24 * 1024;    // staged indices and rows per block

// Block b sums the gaussians [b·B, b·B + B), B = SEG_PAIRS · 256 / D: their
// runs are one contiguous range of gid_order, staged CH slots at a time
// (the indices, then the rows, by cp.async), and thread q owns the sums
// (gaussian, column) = divmod(q + 256k, D), k < SEG_PAIRS, adding its
// gaussian's staged rows in slot order.
__global__ void __launch_bounds__(SEG_THREADS)
segment_sum_kernel(const float* __restrict__ d_sorted,
                   const int* __restrict__ gid_order,
                   const int* __restrict__ run_start, int n, int D, int B,
                   int CH, float* __restrict__ d_flat) {
  extern __shared__ float seg_s[];
  float* rows = seg_s;                        // [CH, D]
  int* slot = (int*)(rows + CH * D);          // [CH]
  int* run = slot + CH;                       // [B + 1], the batch's runs
  const int t = threadIdx.x;
  const long long g0 = (long long)blockIdx.x * B;
  const int nb = (int)min((long long)B, (long long)n - g0);
  for (int i = t; i <= nb; i += SEG_THREADS)
    run[i] = __ldg(run_start + g0 + i);
  __syncthreads();
  float acc[SEG_PAIRS];
  int col[SEG_PAIRS], r0[SEG_PAIRS], r1[SEG_PAIRS];
#pragma unroll
  for (int k = 0; k < SEG_PAIRS; ++k) {
    const int q = t + k * SEG_THREADS;
    const int g = q < nb * D ? q / D : 0;
    acc[k] = 0.f;
    col[k] = q - g * D;
    r0[k] = q < nb * D ? run[g] : 0;      // an empty range past the batch
    r1[k] = q < nb * D ? run[g + 1] : 0;
  }
  const int end = run[nb];
  for (int a = run[0]; a < end; a += CH) {
    const int m = min(CH, end - a);
    for (int i = t; i < m; i += SEG_THREADS)
      __pipeline_memcpy_async(slot + i, gid_order + a + i, sizeof(int));
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    // every row of the chunk in flight at once
    for (int i = t; i < m * D; i += SEG_THREADS) {
      const int r = i / D;
      __pipeline_memcpy_async(
          rows + i, d_sorted + (size_t)slot[r] * D + (i - r * D),
          sizeof(float));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    // in slot order, each add rounded alone
#pragma unroll
    for (int k = 0; k < SEG_PAIRS; ++k) {
      const int hi = min(r1[k], a + m) - a;
      for (int r = max(r0[k], a) - a; r < hi; ++r)
        acc[k] = acc[k] + rows[r * D + col[k]];
    }
    __syncthreads();   // the chunk is read before the next one is staged
  }
#pragma unroll
  for (int k = 0; k < SEG_PAIRS; ++k) {
    const int q = t + k * SEG_THREADS;
    if (q < nb * D) d_flat[g0 * D + q] = acc[k];
  }
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
  const int batch = ET < 0 ? bwd_batch(D, DO) : BWD_BATCH;
  const size_t smem = ET < 0 ? bwd_smem(D, DO) : 0;
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
  if (n <= 0 || D == 0) return (int)cudaSuccess;
  if (D < 0 || D > SEG_PAIRS * SEG_THREADS) return (int)cudaErrorInvalidValue;
  const int B = SEG_PAIRS * SEG_THREADS / D;             // gaussians per block
  const int CH = (SEG_SMEM / 4 - (B + 1)) / (D + 1);     // slots per chunk
  const size_t smem = (size_t)(CH * D + CH + B + 1) * sizeof(float);
  segment_sum_kernel<<<(unsigned)((n + B - 1) / B), SEG_THREADS, smem, st>>>(
      d_sorted, gid_order, run_start, n, D, B, CH, d_flat);
  return (int)cudaGetLastError();
}
