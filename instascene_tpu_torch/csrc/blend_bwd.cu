// Backward of the 2DGS surfel blend (K2), one 16x16 tile per block, and the
// deterministic per-gaussian segment sum that follows it.
//
// Replaces the TPU kernel instascene_tpu/ops/blend_visits.py::_bwd_kernel_visits
// (K2) in its `full`, `no_dist`, `extras_only` and `tiles_per_view` modes,
// instascene_tpu/ops/blend_pallas.py::_bwd_kernel_aligned (K4) over a
// tile-subset mini bundle, and the scatter-add of K2's custom VJP
// (:729-736). Inputs: the packed table flat [N, 21+E], the depth-sorted
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

#include "splat.cuh"

namespace {

using namespace splat;

constexpr int BATCH = 256;       // pair rows staged in shared memory per pass
constexpr int NW = P2 / 32;      // warps per block
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Mode { FULL = 0, NO_DIST = 1, EXTRAS = 2 };  // ops/blend_visits.BWD_MODES

template <int E, int MODE>
__global__ void __launch_bounds__(P2)
blend_bwd_kernel(const float* __restrict__ flat,
                 const int* __restrict__ sorted_gid,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end, int grid_x,
                 const int* __restrict__ tile_ids, int tiles_per_view,
                 const float* __restrict__ gout,
                 const float* __restrict__ saved,
                 const int* __restrict__ iout, float* __restrict__ d_sorted) {
  constexpr int D = 21 + E;
  constexpr int OC = 12 + E;
  constexpr int NF = E > 0 ? E : 1;
  constexpr bool GEOM = MODE != EXTRAS;      // the 21 geometry columns
  constexpr int DO = GEOM ? D : NF;          // d_sorted's columns
  __shared__ float rows[BATCH * D];
  __shared__ float part[2][NW][DO];
  __shared__ int max_nc;

  const int row = blockIdx.x;          // row of gout, saved and iout
  const int t = tile_ids != nullptr ? tile_ids[row] : row;
  const int tl = tiles_per_view > 0 ? t % tiles_per_view : t;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float pxf = (float)((tl % grid_x) * TILE + p % TILE);
  const float pyf = (float)((tl / grid_x) * TILE + p / TILE);
  const int s = tile_start[t];
  const int e = tile_end[t];

  const float* go = gout + (size_t)row * OC * P2 + p;
  const float gc0 = go[0], gc1 = go[P2], gc2 = go[2 * P2];
  const float gD = go[3 * P2];
  const float gn0 = go[4 * P2], gn1 = go[5 * P2], gn2 = go[6 * P2];
  const float gmed = go[7 * P2], gdist = go[8 * P2], gTfin = go[9 * P2];
  float gext[NF];
#pragma unroll
  for (int k = 0; k < E; ++k) gext[k] = go[(10 + k) * P2];
  const float* sv = saved + (size_t)row * 3 * P2 + p;
  const float T_fin = sv[0], m1tot = sv[P2], m2tot = sv[2 * P2];
  const int nc = iout[(size_t)row * 2 * P2 + p];
  const int med_slot = iout[(size_t)row * 2 * P2 + P2 + p];
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
  for (int i = p; i < (e - hi) * DO; i += P2)
    d_sorted[(size_t)hi * DO + i] = 0.f;

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
      float c[DO];
#pragma unroll
      for (int k = 0; k < DO; ++k) c[k] = 0.f;
      if constexpr (!GEOM) {
        if (cm) {
          const float Ti = T / (1.0f - q.alpha);
          const float w = q.alpha * Ti;
          T = Ti;
#pragma unroll
          for (int k = 0; k < E; ++k) c[k] = w * gext[k];
        }
      } else if (cm) {
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
        if (MODE == FULL) {
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
        for (int k = 0; k < DO; ++k) {
          float v = c[k];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(FULL_MASK, v, off);
          c[k] = v;
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < DO; ++k) pw[k] = c[k];
        }
      } else if (lane == 0) {
#pragma unroll
        for (int k = 0; k < DO; ++k) pw[k] = 0.f;
      }
      // one barrier per slot: the partials are double-buffered, so the
      // next slot's writes go to the other buffer while these are read
      __syncthreads();
      if (p < DO) {
        float sum = part[buf][0][p];
#pragma unroll
        for (int w8 = 1; w8 < NW; ++w8) sum = sum + part[buf][w8][p];
        d_sorted[(size_t)(base + j) * DO + p] = sum;
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

struct Args {
  const float* flat;
  const int* sorted_gid;
  const int* tile_start;
  const int* tile_end;
  int grid_x;
  const int* tile_ids;
  int tiles_per_view;
  const float* gout;
  const float* saved;
  const int* iout;
  float* d_sorted;
};

template <int E, int MODE>
void launch_mode(const Args& a, int num_rows, cudaStream_t stream) {
  blend_bwd_kernel<E, MODE><<<num_rows, P2, 0, stream>>>(
      a.flat, a.sorted_gid, a.tile_start, a.tile_end, a.grid_x, a.tile_ids,
      a.tiles_per_view, a.gout, a.saved, a.iout, a.d_sorted);
}

template <int E>
cudaError_t launch(int mode, const Args& a, int num_rows,
                   cudaStream_t stream) {
  if (mode == FULL)
    launch_mode<E, FULL>(a, num_rows, stream);
  else if (mode == NO_DIST)
    launch_mode<E, NO_DIST>(a, num_rows, stream);
  else if (mode == EXTRAS && E > 0)
    launch_mode<E, EXTRAS>(a, num_rows, stream);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Each returns a cudaError_t (0 = launched).
// blend_bwd_launch: num_rows blocks, as blend_fwd_launch.
extern "C" int blend_bwd_launch(const float* flat, const int* sorted_gid,
                                const int* tile_start, const int* tile_end,
                                int num_rows, int grid_x, int n_extra,
                                int mode, const int* tile_ids,
                                int tiles_per_view, const float* gout,
                                const float* saved, const int* iout,
                                float* d_sorted, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows <= 0) return (int)cudaSuccess;
  const Args a{flat,   sorted_gid, tile_start,     tile_end,
               grid_x, tile_ids,   tiles_per_view, gout,
               saved,  iout,       d_sorted};
  if (n_extra == 16) return (int)launch<16>(mode, a, num_rows, st);
  if (n_extra == 0) return (int)launch<0>(mode, a, num_rows, st);
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
