// Backward of the 2DGS surfel blend (K2), one 16x16 tile per block, and the
// deterministic per-gaussian segment sum that follows it.
//
// Replaces the TPU kernel instascene_tpu/ops/blend_visits.py::_bwd_kernel_visits
// (K2) in its `full` and `no_dist` modes, and the scatter-add of its custom
// VJP (:729-736). Inputs: the packed table flat [N, 21+E], the depth-sorted
// pair list and tile ranges K1 blended, gout [T, 12+E, 256] (the cotangent
// of K1's out), saved [T, 3, 256] (out's final T, m1 and m2 rows) and K1's
// iout [T, 2, 256] (n_contrib, med_slot). Output d_sorted [pairs, 21+E]: per
// slot, the gradient of Σ gout·out with respect to that slot's packed row.
// `no_dist` leaves out the expected-depth and distortion chains (gD and gdist
// never enter; the depth gradient is the median tap alone).
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

#include "splat.cuh"

namespace {

using namespace splat;

constexpr int BATCH = 256;       // pair rows staged in shared memory per pass
constexpr int NW = P2 / 32;      // warps per block
constexpr unsigned FULL_MASK = 0xffffffffu;

template <int E, bool NO_DIST>
__global__ void __launch_bounds__(P2)
blend_bwd_kernel(const float* __restrict__ flat,
                 const int* __restrict__ sorted_gid,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end, int grid_x,
                 const float* __restrict__ gout,
                 const float* __restrict__ saved,
                 const int* __restrict__ iout, float* __restrict__ d_sorted) {
  constexpr int D = 21 + E;
  constexpr int OC = 12 + E;
  constexpr int NF = E > 0 ? E : 1;
  __shared__ float rows[BATCH * D];
  __shared__ float part[2][NW][D];
  __shared__ int max_nc;

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float pxf = (float)((t % grid_x) * TILE + p % TILE);
  const float pyf = (float)((t / grid_x) * TILE + p / TILE);
  const int s = tile_start[t];
  const int e = tile_end[t];

  const float* go = gout + (size_t)t * OC * P2 + p;
  const float gc0 = go[0], gc1 = go[P2], gc2 = go[2 * P2];
  const float gD = go[3 * P2];
  const float gn0 = go[4 * P2], gn1 = go[5 * P2], gn2 = go[6 * P2];
  const float gmed = go[7 * P2], gdist = go[8 * P2], gTfin = go[9 * P2];
  float gext[NF];
#pragma unroll
  for (int k = 0; k < E; ++k) gext[k] = go[(10 + k) * P2];
  const float* sv = saved + (size_t)t * 3 * P2 + p;
  const float T_fin = sv[0], m1tot = sv[P2], m2tot = sv[2 * P2];
  const int nc = iout[(size_t)t * 2 * P2 + p];
  const int med_slot = iout[(size_t)t * 2 * P2 + P2 + p];
  const float a_fin = 1.0f - T_fin;
  const float Tfin_g = gTfin * T_fin;

  // the tile's largest n_contrib: no slot after it has a contribution
  if (p == 0) max_nc = 0;
  __syncthreads();
  int wmax = nc;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    wmax = max(wmax, __shfl_xor_sync(FULL_MASK, wmax, off));
  if (lane == 0) atomicMax(&max_nc, wmax);
  __syncthreads();
  const int hi = s + min(max_nc, e - s);
  for (int i = p; i < (e - hi) * D; i += P2) d_sorted[(size_t)hi * D + i] = 0.f;

  float T = T_fin;   // transmittance after the current slot
  float S = 0.f;     // Σ dL/dw · w over the later slots
  int buf = 0;
  for (int top = hi; top > s; top -= BATCH) {
    const int base = max(s, top - BATCH);
    const int nb = top - base;
    __syncthreads();   // the previous batch's rows are no longer read
    for (int i = p; i < nb * D; i += P2) {
      const int r = i / D;
      const int c = i - r * D;
      rows[i] = flat[(size_t)sorted_gid[base + r] * D + c];
    }
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      const float* g = rows + j * D;
      const int slot = base - s + j + 1;
      const Terms q = eval(g, pxf, pyf);
      const bool cm = q.m && slot <= nc;
      float c[D];
#pragma unroll
      for (int k = 0; k < D; ++k) c[k] = 0.f;
      if (cm) {
        const float one_minus = 1.0f - q.alpha;
        const float Ti = T / one_minus;
        const float w = q.alpha * Ti;
        float dLdw = g[NRM] * gn0;
        dLdw = dLdw + g[NRM + 1] * gn1;
        dLdw = dLdw + g[NRM + 2] * gn2;
        dLdw = dLdw + g[COL] * gc0;
        dLdw = dLdw + g[COL + 1] * gc1;
        dLdw = dLdw + g[COL + 2] * gc2;
#pragma unroll
        for (int k = 0; k < E; ++k) dLdw = dLdw + g[EXT + k] * gext[k];
        float dLdd = slot == med_slot ? gmed : 0.0f;
        if (!NO_DIST) {
          const float inv_d = 1.0f / q.depth_ray;
          const float md = MD_SCALE * (1.0f - NEAR_N * inv_d);
          dLdw = dLdw + q.depth_ray * gD +
                 gdist * (md * md * a_fin + m2tot - 2.0f * md * m1tot);
          const float dmd_dd = DMD_DD * inv_d * inv_d;
          dLdd = w * gD + dLdd +
                 gdist * 2.0f * w * (md * a_fin - m1tot) * dmd_dd;
        }
        const float dLda = dLdw * Ti - (S + Tfin_g) / one_minus;
        S = S + dLdw * w;
        T = Ti;
        const float dLdrho = -0.5f * q.G * (g[OPA] * dLda);
        if (q.use3d) {
          const float dLdsx = dLdrho * 2.0f * q.sx + dLdd * g[TW];
          const float dLdsy = dLdrho * 2.0f * q.sy + dLdd * g[TW + 1];
          const float dLdpx = dLdsx * q.inv_pz;
          const float dLdpy = dLdsy * q.inv_pz;
          const float dLdpz = -(dLdsx * q.sx + dLdsy * q.sy) * q.inv_pz;
          c[0] = pxf * dLdpx;
          c[1] = pxf * dLdpy;
          c[2] = pxf * dLdpz;
          c[3] = pyf * dLdpx;
          c[4] = pyf * dLdpy;
          c[5] = pyf * dLdpz;
          c[6] = dLdpx;
          c[7] = dLdpy;
          c[8] = dLdpz;
          c[9] = dLdd * q.sx;
          c[10] = dLdd * q.sy;
          c[11] = dLdd;
        } else {
          c[11] = dLdd;
          c[12] = dLdrho * 2.0f * 2.0f * q.dx;
          c[13] = dLdrho * 2.0f * 2.0f * q.dy;
        }
        c[14] = w * gn0;
        c[15] = w * gn1;
        c[16] = w * gn2;
        c[17] = q.G * dLda;
        c[18] = w * gc0;
        c[19] = w * gc1;
        c[20] = w * gc2;
#pragma unroll
        for (int k = 0; k < E; ++k) c[EXT + k] = w * gext[k];
      }
      float* pw = part[buf][warp];
      if (__any_sync(FULL_MASK, cm)) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          float v = c[k];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(FULL_MASK, v, off);
          c[k] = v;
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < D; ++k) pw[k] = c[k];
        }
      } else if (lane == 0) {
#pragma unroll
        for (int k = 0; k < D; ++k) pw[k] = 0.f;
      }
      // one barrier per slot: the partials are double-buffered, so the
      // next slot's writes go to the other buffer while these are read
      __syncthreads();
      if (p < D) {
        float sum = part[buf][0][p];
#pragma unroll
        for (int w8 = 1; w8 < NW; ++w8) sum = sum + part[buf][w8][p];
        d_sorted[(size_t)(base + j) * D + p] = sum;
      }
      buf ^= 1;
    }
  }
}

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

template <int E>
cudaError_t launch(int no_dist, const float* flat, const int* sorted_gid,
                   const int* tile_start, const int* tile_end, int num_tiles,
                   int grid_x, const float* gout, const float* saved,
                   const int* iout, float* d_sorted, cudaStream_t stream) {
  if (no_dist)
    blend_bwd_kernel<E, true><<<num_tiles, P2, 0, stream>>>(
        flat, sorted_gid, tile_start, tile_end, grid_x, gout, saved, iout,
        d_sorted);
  else
    blend_bwd_kernel<E, false><<<num_tiles, P2, 0, stream>>>(
        flat, sorted_gid, tile_start, tile_end, grid_x, gout, saved, iout,
        d_sorted);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Each returns a cudaError_t (0 = launched).
extern "C" int blend_bwd_launch(const float* flat, const int* sorted_gid,
                                const int* tile_start, const int* tile_end,
                                int num_tiles, int grid_x, int n_extra,
                                int no_dist, const float* gout,
                                const float* saved, const int* iout,
                                float* d_sorted, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_tiles <= 0) return (int)cudaSuccess;
  if (n_extra == 16)
    return (int)launch<16>(no_dist, flat, sorted_gid, tile_start, tile_end,
                           num_tiles, grid_x, gout, saved, iout, d_sorted, st);
  if (n_extra == 0)
    return (int)launch<0>(no_dist, flat, sorted_gid, tile_start, tile_end,
                          num_tiles, grid_x, gout, saved, iout, d_sorted, st);
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
