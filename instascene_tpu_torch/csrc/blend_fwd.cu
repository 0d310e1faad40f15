// Forward alpha-compositing blend of 2DGS surfels, one 16x16 tile per block.
//
// Replaces the TPU kernel instascene_tpu/ops/blend_visits.py::_fwd_kernel_visits
// (K1) in its `full`, `viewer` and `no_dist` modes. Same function, same
// public layout:
//   out  [num_tiles, 12+E, 256] f32: 0:3 color (no background), 3 expected
//        depth sum, 4:7 view normal, 7 median depth, 8 distortion, 9 final T,
//        10:10+E features, 10+E / 11+E the m1 / m2 totals
//   iout [num_tiles, 2, 256] i32: n_contrib (1-based within-tile slot of the
//        last contributor; every binned slot counts) and the median's slot.
// `viewer` writes color, final T, features and n_contrib; its other rows are
// exact zeros. `no_dist` skips the depth sum, the distortion and the m1/m2
// sums (rows 3, 8, 10+E, 11+E are exact zeros); every other row and iout are
// as `full` computes them.
//
// Design. The TPU kernel walks a sequential grid of (chunk, tile) visits,
// carries T/m1/m2/done in VMEM scratch and turns the per-slot recurrence
// into log-step cumprods over 128-slot chunks. On Hopper the blocks run in
// parallel and each pixel owns a thread, so the recurrence stays a plain
// sequential loop (the CUDA reference's design): one block of 256 threads
// per tile, one thread per pixel. The block walks its tile's [start, end)
// range of the depth-sorted pair list in batches of 256 pairs; each batch's
// rows are gathered flat[sorted_gid[j]] straight into shared memory (the
// gather is fused: no packed [pairs, 21+E] copy is ever written), and every
// thread then walks the batch in order. A pixel latches done when a
// contribution would take T below 1e-4 (that contribution is dropped); the
// block leaves once all 256 pixels are done (__syncthreads_count).
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
// Rounding: see splat.cuh. The plain PyTorch version
// (ops/blend_visits.py::blend_fwd_reference) sums in the same order.

#include <cuda_runtime.h>

#include "splat.cuh"

namespace {

using namespace splat;

constexpr int BATCH = 256;  // pair rows staged in shared memory per pass

enum Mode { FULL = 0, VIEWER = 1, NO_DIST = 2 };  // ops/blend_visits.MODES

template <int E, int MODE>
__global__ void __launch_bounds__(P2)
blend_fwd_kernel(const float* __restrict__ flat,
                 const int* __restrict__ sorted_gid,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end, int grid_x,
                 float* __restrict__ out, int* __restrict__ iout) {
  constexpr int D = 21 + E;
  constexpr int OC = 12 + E;
  constexpr int NF = E > 0 ? E : 1;
  constexpr bool AUX = MODE != VIEWER;   // normal and median
  constexpr bool DIST = MODE == FULL;    // depth sum, distortion, m1/m2
  __shared__ float rows[BATCH * D];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float pxf = (float)((t % grid_x) * TILE + p % TILE);
  const float pyf = (float)((t / grid_x) * TILE + p / TILE);
  const int s = tile_start[t];
  const int e = tile_end[t];

  float T = 1.0f;
  bool done = false;
  float col0 = 0.f, col1 = 0.f, col2 = 0.f;
  float feat[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) feat[k] = 0.f;
  float dep = 0.f, nx = 0.f, ny = 0.f, nz = 0.f, med = 0.f, dist = 0.f;
  float M1 = 0.f, M2 = 0.f;
  int last = 0, med_slot = 0;

  for (int base = s; base < e; base += BATCH) {
    // every pixel latched done: nothing later in the tile can change it.
    // Also the barrier that keeps the previous batch's rows alive until all
    // threads finished reading them.
    if (__syncthreads_count(done) == P2) break;
    const int nb = min(BATCH, e - base);
    for (int i = p; i < nb * D; i += P2) {
      const int r = i / D;
      const int c = i - r * D;
      rows[i] = flat[(size_t)sorted_gid[base + r] * D + c];
    }
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < nb; ++j) {
      const float* g = rows + j * D;
      const Terms q = eval(g, pxf, pyf);
      if (!q.m) continue;
      const float test_T = T * (1.0f - q.alpha);
      if (test_T < T_DONE) {
        done = true;
        break;
      }
      const float w = q.alpha * T;
      const int slot = base - s + j + 1;
      col0 = col0 + w * g[COL];
      col1 = col1 + w * g[COL + 1];
      col2 = col2 + w * g[COL + 2];
#pragma unroll
      for (int k = 0; k < E; ++k) feat[k] = feat[k] + w * g[EXT + k];
      if (AUX) {
        nx = nx + w * g[NRM];
        ny = ny + w * g[NRM + 1];
        nz = nz + w * g[NRM + 2];
        if (DIST) {
          dep = dep + w * q.depth_ray;
          // 2DGS distortion, per-contribution form (forward.cu:396-410)
          const float md = MD_SCALE * (1.0f - NEAR_N / q.depth_ray);
          const float A = 1.0f - T;
          dist = dist + w * (md * md * A + M2 - 2.0f * md * M1);
          M1 = M1 + md * w;
          M2 = M2 + md * md * w;
        }
        if (T > 0.5f) {  // median: last contributor entered with T > 0.5
          med = q.depth_ray;
          med_slot = slot;
        }
      }
      last = slot;
      T = test_T;
    }
  }

  float* o = out + (size_t)t * OC * P2 + p;
  int* io = iout + (size_t)t * 2 * P2 + p;
  o[0 * P2] = col0;
  o[1 * P2] = col1;
  o[2 * P2] = col2;
  o[3 * P2] = dep;
  o[4 * P2] = nx;
  o[5 * P2] = ny;
  o[6 * P2] = nz;
  o[7 * P2] = med;
  o[8 * P2] = dist;
  o[9 * P2] = T;
#pragma unroll
  for (int k = 0; k < E; ++k) o[(10 + k) * P2] = feat[k];
  o[(10 + E) * P2] = M1;
  o[(11 + E) * P2] = M2;
  io[0] = last;
  io[P2] = med_slot;
}

template <int E>
cudaError_t launch(int mode, const float* flat, const int* sorted_gid,
                   const int* tile_start, const int* tile_end, int num_tiles,
                   int grid_x, float* out, int* iout, cudaStream_t stream) {
  if (mode == FULL)
    blend_fwd_kernel<E, FULL><<<num_tiles, P2, 0, stream>>>(
        flat, sorted_gid, tile_start, tile_end, grid_x, out, iout);
  else if (mode == VIEWER)
    blend_fwd_kernel<E, VIEWER><<<num_tiles, P2, 0, stream>>>(
        flat, sorted_gid, tile_start, tile_end, grid_x, out, iout);
  else if (mode == NO_DIST)
    blend_fwd_kernel<E, NO_DIST><<<num_tiles, P2, 0, stream>>>(
        flat, sorted_gid, tile_start, tile_end, grid_x, out, iout);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Returns a cudaError_t (0 = launched).
extern "C" int blend_fwd_launch(const float* flat, const int* sorted_gid,
                                const int* tile_start, const int* tile_end,
                                int num_tiles, int grid_x, int n_extra,
                                int mode, float* out, int* iout,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_tiles <= 0) return (int)cudaSuccess;
  if (n_extra == 16)
    return (int)launch<16>(mode, flat, sorted_gid, tile_start, tile_end,
                           num_tiles, grid_x, out, iout, st);
  if (n_extra == 0)
    return (int)launch<0>(mode, flat, sorted_gid, tile_start, tile_end,
                          num_tiles, grid_x, out, iout, st);
  return (int)cudaErrorInvalidValue;
}
