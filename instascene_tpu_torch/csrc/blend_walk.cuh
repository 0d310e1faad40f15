// The per-tile walks the blend kernels share: the forward (K1, K3, K7) and
// the backward (K2, K4, K8), one block of 256 threads per 16x16 tile, one
// thread per pixel.
//
// A layout type says where a tile's pair rows come from, and where the
// backward's per-slot rows go:
//   * FlatRows (K1-K4, csrc/blend_fwd.cu and blend_bwd.cu): the tile's
//     [start, end) range of the depth-sorted pair list, each row gathered
//     flat[sorted_gid[j]] from the per-gaussian packed table; the backward
//     writes d_sorted [pairs, DO].
//   * PaddedRows (K7/K8, csrc/blend_padded.cu): slots 0..count[t) of the
//     padded per-tile layout packed [T, D, K], read along K; the backward
//     writes d(packed) [T, D, K].
// The walk itself — splat.cuh's terms and alpha mask, the done latch, the
// median rule, the fma order, the back-to-front recovery of T and the
// fixed-order per-slot reduction — is one code for every layout, so a
// tile's values depend only on its pair rows in order, never on where they
// were read from.
//
// The forward's schedule (what bounds it on the H100, and the answer):
//   * the tiles' loads differ by orders of magnitude (on the 976x728 bench
//     frame a mean of 279 pairs, the largest 4,341), and a block left
//     alone on an SM at the end of the launch walks at the latency of its
//     slot chain. Block b walks row order[b], a permutation of the output
//     rows longest range first (the wrapper's stable argsort), so the
//     heaviest tiles start in the first wave; each block still writes its
//     own row;
//   * a slot is an evaluation (splat.cuh's terms and the clip_rect gate,
//     functions of the row and the pixel alone: an IEEE division and an
//     expf) and the recurrence (T, the accumulators, the latch). The walk
//     evaluates U consecutive slots, then applies the recurrence to them
//     in slot order, so the evaluations' latencies overlap; a latch inside
//     a group drops the rest of it, as the one-slot loop would never have
//     reached them. U was chosen by timing on the H100 (PERF.md): 4
//     where the features take registers (U = 8 slowed E = 8 by 41 %), 8
//     at E = 0 (K1 no_dist 0.70 → 0.64 ms);
//   * the rows are staged in two buffers of FWD_BATCH rows by cp.async (a
//     warp per stretch of rows, FlatRows) while the other buffer is
//     walked, one barrier per batch; shared memory stays 256 rows.
//
// Template arguments:
//   ET    the feature width E. 0 and 16 are compiled as constants (their
//         features live in registers); DYN_E takes E at run time (E >= 1):
//         the forward accumulates a pixel's features in its own output
//         column (each thread owns its column: no race, the same order of
//         additions), the backward forms the E feature columns in a loop
//         at the reduction, and the staged batch (and the backward's group
//         of slots per barrier) shrinks so that rows and partials fit a
//         shared-memory budget: the 48 KB a block gets without opting in
//         while the smallest staging (one row per buffer, a group of one
//         slot) fits it, else the device's opt-in limit less the kernel's
//         static arrays (227 KB on the H100; smem.cuh). The widest E is
//         the one whose smallest staging still fits that limit
//         (fwd_max_width, bwd_max_width).
//   MODE  the forward's (Fwd) or backward's (Bwd) mode.
//   CLIP  clip_rect: the packed rows carry 4 trailing rect columns (rmin_x,
//         rmax_x, rmin_y, rmax_y) and a pair contributes only where the
//         tile lies in the rect (splat.cuh::in_rect); the backward writes
//         zeros in those columns. It serves a cached superset pair list
//         (a binning dilated at another camera) that must reproduce the
//         fresh binning's rect clipping exactly.
//
// Rounding: see splat.cuh.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>

#include "smem.cuh"
#include "splat.cuh"
#include "warp.cuh"

namespace walk {

using namespace splat;
using namespace warp;

constexpr int FWD_BATCH = 128;   // pair rows per buffer (forward, two)
constexpr int FWD_U = 4;         // forward slots evaluated ahead (E > 0)
constexpr int FWD_U0 = 8;        // the same at E = 0
constexpr int BWD_BATCH = 128;   // pair rows staged per pass (backward)
constexpr int GROUP = 8;         // backward slots per barrier (fixed E)
constexpr int NW = P2 / 32;      // warps per block
constexpr int DYN_E = -1;        // ET: the feature width is given at run time
constexpr int RECT = 4;          // clip_rect's trailing columns
constexpr int TRACK_K = 10;      // contributor slots per pixel
constexpr float TRACK_W = 0.1f;  // a contribution is tracked when w > this

// ops/blend_visits.MODES and BWD_MODES: the C entries take the index
enum Fwd { FULL = 0, VIEWER = 1, NO_DIST = 2, EXTRAS = 3, TRACK = 4 };
enum Bwd { B_FULL = 0, B_NO_DIST = 1, B_EXTRAS = 2 };

// The run-time width's staging, for `budget` bytes of dynamic shared
// memory (smem::budget). The forward's pair rows per buffer (two buffers):
inline int fwd_batch(int D, int budget) {
  return std::min(FWD_BATCH, budget / (8 * D));
}
// the backward's slots per barrier: GROUP where their double-buffered
// partials take at most half the budget, else fewer (1 at the widest rows)
inline int bwd_group(int DO, int budget) {
  int g = GROUP;
  while (g > 1 && 2 * g * NW * DO * 4 > budget / 2) g >>= 1;
  return g;
}
// the backward's staged rows beside the partials of its group (< 1: the
// rows do not fit the budget)
inline int bwd_batch(int D, int DO, int budget) {
  return std::min(BWD_BATCH, (budget / 4 - 2 * bwd_group(DO, budget) * NW *
                                               DO) / D);
}
// The run-time width's staging of a launch of `kernel` at row width D (the
// backward's output rows DO): its rows per buffer (and slots per barrier)
// and its dynamic shared memory, for the budget its smallest staging
// selects (one row per buffer of the forward; one row and the partials of
// a group of one slot of the backward; csrc/smem.cuh), the kernel opted in
// where they pass the 48 KB window. cudaErrorInvalidValue where even that
// staging does not fit the device.
template <class K>
cudaError_t fwd_staging(K* kernel, int D, int& batch, size_t& bytes) {
  batch = fwd_batch(D, smem::budget(kernel, (size_t)2 * D * sizeof(float)));
  if (batch < 1) return cudaErrorInvalidValue;
  bytes = (size_t)2 * batch * D * sizeof(float);
  return smem::allow(kernel, bytes);
}
template <class K>
cudaError_t bwd_staging(K* kernel, int D, int DO, int& batch, int& group,
                        size_t& bytes) {
  const int budget =
      smem::budget(kernel, (size_t)(D + 2 * NW * DO) * sizeof(float));
  batch = bwd_batch(D, DO, budget);
  group = bwd_group(DO, budget);
  if (batch < 1) return cudaErrorInvalidValue;
  bytes = (size_t)(batch * D + 2 * group * NW * DO) * sizeof(float);
  return smem::allow(kernel, bytes);
}
// the widest E whose smallest staging fits `left` bytes, at the widest
// rows a mode takes (clip_rect's D = 25 + E, and DO = D in the backward)
inline int fwd_max_width(int left) { return left / (2 * 4) - 21 - RECT; }
inline int bwd_max_width(int left) {
  return left / ((1 + 2 * NW) * 4) - 21 - RECT;
}

// The inputs are read-only for the whole launch: the loads go through the
// read-only data cache (__ldg), which a pointer held in a struct would not
// get from __restrict__ alone.
struct FlatRows {
  const float* flat;        // [N, D]
  const int* sorted_gid;    // [pairs]
  const int* tile_start;    // [T]
  const int* tile_end;      // [T]

  __device__ __forceinline__ int begin(int t) const {
    return __ldg(tile_start + t);
  }
  __device__ __forceinline__ int end(int t) const {
    return __ldg(tile_end + t);
  }
  // slots [base, base + nb) → rows[r * D + c], the gather fused
  __device__ __forceinline__ void stage(float* rows, int t, int base, int nb,
                                        int D, int p) const {
    for (int i = p; i < nb * D; i += P2) {
      const int r = i / D;
      const int c = i - r * D;
      rows[i] = __ldg(flat + (size_t)__ldg(sorted_gid + base + r) * D + c);
    }
  }
  // the forward's staging: slots [base, base + nb) → rows[r * D + c] by
  // cp.async (warp.cuh::gather_rows), the slots' ids → gids (may be null)
  __device__ __forceinline__ void stage_async(float* rows, int* gids, int t,
                                              int base, int nb, int D,
                                              int p) const {
    gather_rows(rows, D, flat, D, D, sorted_gid + base, nb, p >> 5, NW,
                p & 31, gids);
  }
  // d_sorted [pairs, DO]: column col of slot j
  __device__ __forceinline__ float* grad(float* d, int t, int j, int col,
                                         int DO) const {
    return d + (size_t)j * DO + col;
  }
  // entry i of a group of cnt slots' rows → (slot r, column col), in the
  // order of the output (row after row: one contiguous store)
  __device__ __forceinline__ void split(int i, int cnt, int DO, int& r,
                                        int& col) const {
    r = i / DO;
    col = i - r * DO;
  }
  // zero rows for the slots [hi, end) that no contribution reaches
  __device__ __forceinline__ void zero_tail(float* d, int t, int hi, int e,
                                            int DO, int p) const {
    for (int i = p; i < (e - hi) * DO; i += P2) d[(size_t)hi * DO + i] = 0.f;
  }
};

struct PaddedRows {
  const float* packed;      // [T, D, K]
  const int* count;         // [T], each <= K
  int K;

  __device__ __forceinline__ int begin(int t) const { return 0; }
  __device__ __forceinline__ int end(int t) const { return __ldg(count + t); }
  // slots [base, base + nb) of tile t → rows[r * D + c], read along K
  // (neighbouring threads on neighbouring slots of one column)
  __device__ __forceinline__ void stage(float* rows, int t, int base, int nb,
                                        int D, int p) const {
    for (int i = p; i < nb * D; i += P2) {
      const int c = i / nb;
      const int r = i - c * nb;
      rows[r * D + c] = __ldg(packed + ((size_t)t * D + c) * K + base + r);
    }
  }
  // the forward's staging by cp.async: warp w copies columns w, w + 8, ..
  // of the slots, its lanes on neighbouring slots (gids: the slot indices)
  __device__ __forceinline__ void stage_async(float* rows, int* gids, int t,
                                              int base, int nb, int D,
                                              int p) const {
    for (int c = p >> 5; c < D; c += NW) {
      const float* col = packed + ((size_t)t * D + c) * K + base;
      for (int r = p & 31; r < nb; r += 32)
        __pipeline_memcpy_async(rows + r * D + c, col + r, sizeof(float));
    }
    if (gids != nullptr)
      for (int r = p; r < nb; r += P2) gids[r] = base + r;
  }
  // d(packed) [T, DO, K]: column col of tile t's slot j
  __device__ __forceinline__ float* grad(float* d, int t, int j, int col,
                                         int DO) const {
    return d + ((size_t)t * DO + col) * K + j;
  }
  // entry i of a group of cnt slots → (slot r, column col), along K
  __device__ __forceinline__ void split(int i, int cnt, int DO, int& r,
                                        int& col) const {
    col = i / cnt;
    r = i - col * cnt;
  }
  // zero every column of the slots [hi, K): past the last contribution and
  // past count[t]
  __device__ __forceinline__ void zero_tail(float* d, int t, int hi, int e,
                                            int DO, int p) const {
    const int n = K - hi;
    for (int i = p; i < n * DO; i += P2) {
      const int c = i / n;
      d[((size_t)t * DO + c) * K + hi + (i - c * n)] = 0.f;
    }
  }
};

// The forward blend of one tile: block b writes row order[b] of out/iout
// (see csrc/blend_fwd.cu for the modes, the outputs and the tile
// selection). batch: rows per buffer (FWD_BATCH at a fixed E).
template <int ET, int MODE, bool CLIP, class Rows>
__global__ void __launch_bounds__(P2)
blend_fwd_kernel(const Rows src, int n_extra, int batch, int grid_x,
                 const long long* __restrict__ order,
                 const int* __restrict__ tile_ids, int tiles_per_view,
                 const int* __restrict__ done0, float* __restrict__ out,
                 int* __restrict__ iout, int* __restrict__ track_ids,
                 float* __restrict__ track_w) {
  constexpr bool DYN = ET < 0;
  constexpr int ES = DYN ? 0 : ET;           // features held in registers
  constexpr int NF = ES > 0 ? ES : 1;
  constexpr int DS = 21 + ES + (CLIP ? RECT : 0);
  const int E = DYN ? n_extra : ET;
  const int D = 21 + E + (CLIP ? RECT : 0);
  const int OC = 12 + E;
  const int nbatch = DYN ? batch : FWD_BATCH;
  constexpr bool COLOR = MODE != EXTRAS;
  constexpr bool AUX = MODE != VIEWER && MODE != EXTRAS;  // normal, median
  constexpr bool DIST = MODE == FULL || MODE == TRACK;    // depth, distortion
  __shared__ float rows_s[DYN ? 1 : 2 * FWD_BATCH * DS];
  extern __shared__ float rows_d[];
  float* rows = DYN ? rows_d : rows_s;
  __shared__ int gids_s[MODE == TRACK ? 2 * FWD_BATCH : 1];
  int* gids = MODE == TRACK ? gids_s : nullptr;

  const int row = (int)__ldg(order + blockIdx.x);  // output row
  const int t = tile_ids != nullptr ? tile_ids[row] : row;
  const int tl = tiles_per_view > 0 ? t % tiles_per_view : t;
  const int p = threadIdx.x;
  const int tx = tl % grid_x;
  const int ty = tl / grid_x;
  const float pxf = (float)(tx * TILE + p % TILE);
  const float pyf = (float)(ty * TILE + p / TILE);
  const float txf = (float)tx;
  const float tyf = (float)ty;
  const int s = src.begin(t);
  const int e = src.end(t);

  float T = 1.0f;
  // done0 (extras_only only): pixels the caller will not read start latched
  bool done = MODE == EXTRAS && done0 != nullptr &&
              done0[(size_t)t * P2 + p] != 0;
  int n_track = 0;
  int* tid =
      MODE == TRACK ? track_ids + (size_t)row * TRACK_K * P2 + p : nullptr;
  float* tw =
      MODE == TRACK ? track_w + (size_t)row * TRACK_K * P2 + p : nullptr;
  float* o = out + (size_t)row * OC * P2 + p;
  float col0 = 0.f, col1 = 0.f, col2 = 0.f;
  float feat[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) feat[k] = 0.f;
  if constexpr (DYN) {
    for (int k = 0; k < E; ++k) o[(10 + k) * P2] = 0.f;
  }
  float dep = 0.f, nx = 0.f, ny = 0.f, nz = 0.f, med = 0.f, dist = 0.f;
  float M1 = 0.f, M2 = 0.f;
  int last = 0, med_slot = 0;

  // the first batch in flight before the loop
  if (s < e) src.stage_async(rows, gids, t, s, min(nbatch, e - s), D, p);
  __pipeline_commit();
  int buf = 0;
  for (int base = s; base < e; base += nbatch) {
    // this thread's copies of the batch have landed; the barrier makes
    // every thread's visible and ends the walk of the previous batch (its
    // buffer takes the next one). Every pixel latched done: nothing later
    // in the tile can change it, so the block leaves.
    __pipeline_wait_prior(0);
    if (__syncthreads_count(done) == P2) break;
    const int nb = min(nbatch, e - base);
    const int next = base + nbatch;
    if (next < e)
      src.stage_async(rows + (buf ^ 1) * nbatch * D,
                      gids + (MODE == TRACK ? (buf ^ 1) * FWD_BATCH : 0), t,
                      next, min(nbatch, e - next), D, p);
    __pipeline_commit();
    const float* rb = rows + buf * nbatch * D;
    const int* gb = gids + (MODE == TRACK ? buf * FWD_BATCH : 0);
    const int slot0 = base - s + 1;
    buf ^= 1;
    if (done) continue;

    // the recurrence of slot j of the batch, given its evaluation (alpha,
    // depth along the ray); true where the contribution would take T below
    // 1e-4: the pixel latches done and the contribution is dropped
    auto apply = [&](int j, float alpha, float depth_ray) -> bool {
      const float* g = rb + j * D;
      const float test_T = T * (1.0f - alpha);
      if (test_T < T_DONE) return true;
      const float w = alpha * T;
      const int slot = slot0 + j;
      if (COLOR) {
        col0 = col0 + w * g[COL];
        col1 = col1 + w * g[COL + 1];
        col2 = col2 + w * g[COL + 2];
      }
      if constexpr (DYN) {
        for (int k = 0; k < E; ++k)
          o[(10 + k) * P2] = o[(10 + k) * P2] + w * g[EXT + k];
      } else {
#pragma unroll
        for (int k = 0; k < ES; ++k) feat[k] = feat[k] + w * g[EXT + k];
      }
      if (AUX) {
        nx = nx + w * g[NRM];
        ny = ny + w * g[NRM + 1];
        nz = nz + w * g[NRM + 2];
        if (DIST) {
          dep = dep + w * depth_ray;
          // 2DGS distortion, per-contribution form (forward.cu:396-410)
          const float md = MD_SCALE * (1.0f - NEAR_N / depth_ray);
          const float A = 1.0f - T;
          dist = dist + w * (md * md * A + M2 - 2.0f * md * M1);
          M1 = M1 + md * w;
          M2 = M2 + md * md * w;
        }
        if (T > 0.5f) {  // median: last contributor entered with T > 0.5
          med = depth_ray;
          med_slot = slot;
        }
      }
      if (MODE == TRACK && w > TRACK_W && n_track < TRACK_K) {
        tid[n_track * P2] = gb[j];
        tw[n_track * P2] = w;
        ++n_track;
      }
      last = slot;
      T = test_T;
      return false;
    };
    // the evaluation of slot j: clip_rect's gate, then the splat's mask
    auto evaluate = [&](int j, float& alpha, float& depth_ray) -> bool {
      const float* g = rb + j * D;
      alpha = depth_ray = 0.f;
      if (CLIP && !in_rect(g + D - RECT, txf, tyf)) return false;
      const Terms q = eval(g, pxf, pyf);
      alpha = q.alpha;
      depth_ray = q.depth_ray;
      return q.m;
    };
    constexpr int U = ET == 0 ? FWD_U0 : FWD_U;
    int j = 0;
    for (; j + U <= nb && !done; j += U) {
      float al[U], dr[U];
      bool mk[U];
#pragma unroll
      for (int u = 0; u < U; ++u) mk[u] = evaluate(j + u, al[u], dr[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (mk[u] && apply(j + u, al[u], dr[u])) {
          done = true;
          break;
        }
      }
    }
    for (; j < nb && !done; ++j) {
      float al, dr;
      if (evaluate(j, al, dr) && apply(j, al, dr)) done = true;
    }
  }
  if (MODE == TRACK) {
    for (int k = n_track; k < TRACK_K; ++k) {
      tid[k * P2] = -1;
      tw[k * P2] = 0.0f;
    }
  }

  int* io = iout + (size_t)row * 2 * P2 + p;
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
  for (int k = 0; k < ES; ++k) o[(10 + k) * P2] = feat[k];
  o[(10 + E) * P2] = M1;
  o[(11 + E) * P2] = M2;
  io[0] = last;
  io[P2] = med_slot;
}

// The backward of one tile: per slot, the gradient of Σ gout·out with
// respect to the slot's packed row (see csrc/blend_bwd.cu). Block b reads
// row b of gout, saved and iout. batch: rows staged per pass, group: slots
// per barrier (BWD_BATCH and GROUP at a fixed E).
template <int ET, int MODE, bool CLIP, class Rows>
__global__ void __launch_bounds__(P2)
blend_bwd_kernel(const Rows src, int n_extra, int batch, int group,
                 int grid_x,
                 const int* __restrict__ tile_ids, int tiles_per_view,
                 const float* __restrict__ gout,
                 const float* __restrict__ saved,
                 const int* __restrict__ iout, float* __restrict__ d_out) {
  constexpr bool DYN = ET < 0;
  constexpr int ES = DYN ? 0 : ET;
  constexpr int NF = ES > 0 ? ES : 1;
  constexpr bool GEOM = MODE != B_EXTRAS;    // the 21 geometry columns
  constexpr int NC = (GEOM ? 21 : 0) + ES;   // columns reduced from registers
  constexpr int NCA = NC > 0 ? NC : 1;
  constexpr int NL = scatter_left(NC);       // columns a lane ends with
  constexpr int DS = 21 + ES + (CLIP ? RECT : 0);
  constexpr int DOS = GEOM ? DS : NF;
  const int E = DYN ? n_extra : ET;
  const int D = 21 + E + (CLIP ? RECT : 0);
  const int DO = GEOM ? D : E;               // output row's columns
  const int OC = 12 + E;
  const int nbatch = DYN ? batch : BWD_BATCH;
  const int G = DYN ? group : GROUP;          // slots per barrier
  __shared__ float rows_s[DYN ? 1 : BWD_BATCH * DS];
  // the warp partials [2][G][NW][DO] of two groups of slots
  __shared__ float part_s[DYN ? 1 : 2 * GROUP * NW * DOS];
  extern __shared__ float dyn_s[];
  float* rows = DYN ? dyn_s : rows_s;
  float* part = DYN ? dyn_s + nbatch * D : part_s;
  __shared__ int max_nc;

  const int row = blockIdx.x;          // row of gout, saved and iout
  const int t = tile_ids != nullptr ? tile_ids[row] : row;
  const int tl = tiles_per_view > 0 ? t % tiles_per_view : t;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int tx = tl % grid_x;
  const int ty = tl / grid_x;
  const float pxf = (float)(tx * TILE + p % TILE);
  const float pyf = (float)(ty * TILE + p / TILE);
  const float txf = (float)tx;
  const float tyf = (float)ty;
  const int s = src.begin(t);
  const int e = src.end(t);

  const float* go = gout + (size_t)row * OC * P2 + p;
  const float gc0 = go[0], gc1 = go[P2], gc2 = go[2 * P2];
  const float gD = go[3 * P2];
  const float gn0 = go[4 * P2], gn1 = go[5 * P2], gn2 = go[6 * P2];
  const float gmed = go[7 * P2], gdist = go[8 * P2], gTfin = go[9 * P2];
  float gext[NF];
#pragma unroll
  for (int k = 0; k < ES; ++k) gext[k] = go[(10 + k) * P2];
  const float* sv = saved + (size_t)row * 3 * P2 + p;
  const float T_fin = sv[0], m1tot = sv[P2], m2tot = sv[2 * P2];
  const int nc = iout[(size_t)row * 2 * P2 + p];
  const int med_slot = iout[(size_t)row * 2 * P2 + P2 + p];
  const float a_fin = 1.0f - T_fin;
  const float Tfin_g = gTfin * T_fin;

  // clip_rect's rect columns take no gradient: their partials stay 0
  if (CLIP && GEOM) {
    for (int i = p; i < 2 * G * NW * RECT; i += P2)
      part[(i / RECT) * DO + DO - RECT + i % RECT] = 0.f;
  }
  // where this lane's reduced columns go in the warp's partial row
  int wcol[NCA];
  bool wown[NCA];
#pragma unroll
  for (int k = 0; k < NCA; ++k) {
    wcol[k] = k;
    wown[k] = k < NC;
  }
  scatter_owners<NC>(wcol, wown, lane);

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
  src.zero_tail(d_out, t, hi, e, DO, p);

  float T = T_fin;   // transmittance after the current slot
  float S = 0.f;     // Σ dL/dw · w over the later slots
  int buf = 0;
  for (int top = hi; top > s; top -= nbatch) {
    const int base = max(s, top - nbatch);
    const int nb = top - base;
    __syncthreads();   // the previous batch's rows are no longer read
    src.stage(rows, t, base, nb, D, p);
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      const float* g = rows + j * D;
      const int slot = base - s + j + 1;
      // clip_rect's gate is uniform over the tile: a gated slot skips the
      // splat, as in the forward, and its partials are zeros
      const bool gate = !CLIP || in_rect(g + D - RECT, txf, tyf);
      Terms q;
      q.m = false;
      if (gate) q = eval(g, pxf, pyf);
      const bool cm = gate && q.m && slot <= nc;
      float c[NCA];
#pragma unroll
      for (int k = 0; k < NCA; ++k) c[k] = 0.f;
      float w = 0.f;
      if constexpr (!GEOM) {
        if (cm) {
          const float Ti = T / (1.0f - q.alpha);
          w = q.alpha * Ti;
          T = Ti;
#pragma unroll
          for (int k = 0; k < ES; ++k) c[k] = w * gext[k];
        }
      } else if (cm) {
        const float one_minus = 1.0f - q.alpha;
        const float Ti = T / one_minus;
        w = q.alpha * Ti;
        float dLdw = g[NRM] * gn0;
        dLdw = dLdw + g[NRM + 1] * gn1;
        dLdw = dLdw + g[NRM + 2] * gn2;
        dLdw = dLdw + g[COL] * gc0;
        dLdw = dLdw + g[COL + 1] * gc1;
        dLdw = dLdw + g[COL + 2] * gc2;
        if constexpr (DYN) {
          for (int k = 0; k < E; ++k)
            dLdw = dLdw + g[EXT + k] * go[(10 + k) * P2];
        } else {
#pragma unroll
          for (int k = 0; k < ES; ++k) dLdw = dLdw + g[EXT + k] * gext[k];
        }
        float dLdd = slot == med_slot ? gmed : 0.0f;
        if (MODE == B_FULL) {
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
        for (int k = 0; k < ES; ++k) c[EXT + k] = w * gext[k];
      }
      const int jj = j & (G - 1);             // the slot's place in its group
      float* pw = part + ((buf * G + jj) * NW + warp) * DO;
      const bool any = __any_sync(FULL_MASK, cm);
      // a warp without a contribution writes its zeros unreduced
      if (any) scatter_reduce<NC>(c, lane);
#pragma unroll
      for (int i = 0; i < NL; ++i)
        if (wown[i]) pw[wcol[i]] = c[i];
      if constexpr (DYN) {
        // the feature columns w · gout[10 + k], formed here one at a time
        const int f0 = GEOM ? EXT : 0;
        for (int k = 0; k < E; ++k) {
          float v = 0.f;
          if (any) {
            v = cm ? w * go[(10 + k) * P2] : 0.f;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v += __shfl_xor_sync(FULL_MASK, v, off);
          }
          if (lane == 0) pw[f0 + k] = v;
        }
      }
      if (jj == 0) {
        // the group's slots j .. j + cnt - 1 are reduced by every warp: one
        // barrier (the partials are double-buffered, so the next group's
        // writes go to the other buffer while these are read), then all
        // threads sum each (slot, column)'s 8 warp partials in a fixed
        // order and store it
        const int cnt = min(G, nb - j);
        __syncthreads();
        const float* pb = part + buf * G * NW * DO;
        for (int i = p; i < cnt * DO; i += P2) {
          int r, col;
          src.split(i, cnt, DO, r, col);
          const float* pc = pb + r * NW * DO + col;
          float sum = pc[0];
#pragma unroll
          for (int w8 = 1; w8 < NW; ++w8) sum = sum + pc[w8 * DO];
          *src.grad(d_out, t, base + j + r, col, DO) = sum;
        }
        buf ^= 1;
      }
    }
  }
}

}  // namespace walk
