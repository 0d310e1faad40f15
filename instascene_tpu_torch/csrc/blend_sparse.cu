// Sparse-pixel extras blend: the features, final T and n_contrib of S
// sampled pixels per tile (K5), and its backward, the per-slot feature
// gradients of those pixels (K6).
//
// Replaces the TPU kernels instascene_tpu/ops/blend_sparse.py::
// _sparse_fwd_kernel (K5) and ::_sparse_bwd_kernel (K6). Inputs: the packed
// table flat [N, 21+E], the depth-sorted pair list and tile ranges of the
// camera's binning, and spix [T, S] int32, the within-tile pixel index of
// each sampled slot (-1: empty; a pixel drawn twice takes two slots).
// K5 writes feat [T, S, E] and aux [T, S, 2] f32 (final T, n_contrib); an
// empty slot gets T = 1, zero features and n_contrib 0. K6 takes gout
// [T, S, E] (the cotangent of feat) and K5's aux and writes d_sorted
// [pairs, E]: per slot, Σ over the tile's sampled pixels of w · gout.
//
// Design. The TPU kernels put the S pixels on sublanes and a 128-slot chunk
// on lanes, so every elementwise op touches S x 128 values, and turn the
// per-slot recurrence into cumprods; they group 8 visits per grid step to
// amortise the step's bookkeeping. Here each block owns one tile and each
// thread one sampled slot (S rounded up to a warp; the padding threads hold
// empty slots), and a thread's recurrence is a plain sequential loop, K1's
// (csrc/blend_walk.cuh) own: every thread evaluates splat.cuh's terms,
// drops the contribution that would take T below 1e-4 and latches, and the
// block leaves when all its threads have latched (a block whose slots are
// all empty leaves at once). So a slot's values are bit for bit those of
// K1 `extras_only` at its pixel (with or without a done0 mask: a pixel's
// blend does not depend on its neighbours). K6 walks its tile back to
// front from the largest n_contrib among its slots, recovers T before each
// pair as T_after / (1 - alpha) from the saved final T (as K2 does), and
// reduces w · gout over the slots per pair across each warp and then in a
// fixed cross-warp order in shared memory: no atomics, the same bits on
// every run. Pairs past every slot's n_contrib get zero rows without a
// walk (the JAX kernel's `beyond` test). The per-gaussian sum is the
// segment sum of csrc/blend_bwd.cu at D = E.
//
// The schedule both share, K1's (blend_walk.cuh says why each piece is
// there): the blocks take the tiles longest range first (block b walks
// tile order[b], the wrapper's stable argsort; each writes only its own
// tile's rows, so no output moves); the pair rows are staged by 4-byte
// cp.async (warp.cuh::gather_rows: a warp per stretch of rows after one
// coalesced load of their ids, no division per element) into two buffers
// of 128 rows, the next batch in flight while one is walked, one barrier
// per batch; and the evaluations (an IEEE division and an expf each) run
// ahead of the recurrence, FWD_U slots in K5 and SPARSE_U pairs in K6, so
// their latencies overlap. Only the evaluations move: T, the fma order of
// the feature sums, the latch (which drops the rest of its group, as the
// one-slot loop never reached them) and n_contrib keep their order, and
// tests/test_torch_walk_schedule.py holds a float32 model of K5's walk bit
// for bit against the one-slot loop. K5 stages all 37 columns of a row at
// E = 16, as K1 does (staging columns 0-17 and reading a contribution's
// features from flat measured 5 % slower there); K6 stages only columns
// 0-17, the span splat.cuh::eval reads, and at E = 16 reduces the 16
// columns with warp.cuh's reduce-scatter (16 shuffles per warp per pair,
// not 80 in 16 butterflies, the butterflies' bits) into double-buffered
// partials of 8 pairs, one barrier per group, after which every thread
// stores the group's rows in the output's order.
//
// What bounds them on the H100: the bytes. On the semantic step's 976x728
// frame a tile holds ~12 (up to S = 48) of its 256 pixels, so the FP32 work
// is ~S/256 of K1's (41 operations per evaluation, 4 + 2E per
// contribution), while every block still gathers the rows of the pairs it
// walks: the flat columns of those pairs and the pair list dominate (the
// 15 splat columns + E features per walked row, then spix, feat and aux).
// The design keeps the gather fused (no packed copy), stops each block at
// its last slot's latch (K5) or at its largest n_contrib (K6), and runs
// blocks of 32-128 threads so that many of them fit an SM. What was in the
// way before the schedule: a heavy tile starting in a late wave and
// walking alone at the end (ranges of 279 pairs on average, 4,341 at
// most), a synchronous gather that divided per element and overlapped no
// walk, and one evaluation at a time in each thread's chain.
//
// Feature widths: E = 16 is compiled as a constant; any other E >= 1 runs
// the run-time-width instantiation (DYN_E): K5 stages columns 0-17 and the
// rows' ids, reads a contribution's E features from flat and accumulates
// them in the slot's own feat row (each thread owns its slot: no race, the
// same order of additions), so its rows take the same shared memory at any
// E; K6 reads gout per feature and reduces the E columns in a loop, one
// butterfly each, with a group of pairs per barrier whose partials fit the
// budget of csrc/smem.cuh beside its rows (sparse_group). The widest E is
// the one whose partials of a group of one pair fit the device
// (sparse_max_width).
//
// Rounding: see splat.cuh. The plain PyTorch versions
// (ops/blend_sparse.py::blend_sparse_fwd_reference, _bwd_reference) are
// K1's and K2's plain versions evaluated at the sampled pixels.

#include <cuda_runtime.h>

#include "smem.cuh"
#include "splat.cuh"
#include "warp.cuh"

namespace {

using namespace splat;
using namespace warp;

constexpr int BATCH = 128;          // pair rows per buffer (two buffers)
constexpr int MAX_THREADS = 128;    // S <= 128, as the JAX kernels take
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int DYN_E = -1;           // E given at run time
constexpr int EVAL_COLS = OPA + 1;  // the span of columns eval reads
constexpr int FWD_U = 4;            // K5's slots evaluated ahead
constexpr int SPARSE_GROUP = 8;     // K6's pairs per barrier at E = 16
constexpr int SPARSE_U = 2;         // K6's pairs evaluated ahead
// K6's two buffers of staged rows (static)
constexpr int K6_ROWS = 2 * BATCH * EVAL_COLS * (int)sizeof(float);

// K6's pairs per barrier at run-time width: its double-buffered partials
// fit `budget` bytes (1 at the widest E)
int sparse_group(int E, int budget) {
  int g = SPARSE_GROUP;
  while (g > 1 && 2 * g * MAX_WARPS * E * 4 > budget) g >>= 1;
  return g;
}
// K6's partials of a group of g pairs, in bytes
size_t sparse_part_bytes(int E, int g) {
  return (size_t)2 * g * MAX_WARPS * E * sizeof(float);
}

// K5: block b walks tile order[b] (the tiles longest range first) front to
// back, its rows in two buffers of BATCH. At E = 16 a staged row holds all
// 21 + E columns; at run-time width it holds columns 0-17 beside the row's
// id, and a contribution reads its E features from flat (measured on the
// H100: E = 8 0.645 ms against 0.667 with whole rows, PERF.md), so the
// batch stays BATCH rows at any E.
template <int ET>
__global__ void __launch_bounds__(MAX_THREADS)
sparse_fwd_kernel(const float* __restrict__ flat,
                  const int* __restrict__ sorted_gid,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_end,
                  const long long* __restrict__ order,
                  const int* __restrict__ spix, int S, int grid_x,
                  int n_extra, float* __restrict__ feat_out,
                  float* __restrict__ aux_out) {
  constexpr bool DYN = ET < 0;
  constexpr int ES = DYN ? 0 : ET;
  constexpr int NF = ES > 0 ? ES : 1;
  const int E = DYN ? n_extra : ET;
  const int D = 21 + E;
  constexpr bool ALL = !DYN;                 // whole rows staged
  constexpr int RS = ALL ? 21 + ES : EVAL_COLS;   // staged columns per row
  __shared__ float rows[2 * BATCH * RS];
  __shared__ int gids_s[ALL ? 1 : 2 * BATCH];
  int* gids = ALL ? nullptr : gids_s;

  const int t = (int)__ldg(order + blockIdx.x);
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int nthr = blockDim.x;
  const int nw = nthr >> 5;
  const int sp = i < S ? spix[(size_t)t * S + i] : -1;
  const int spc = sp >= 0 ? sp : 0;
  const float pxf = (float)((t % grid_x) * TILE + spc % TILE);
  const float pyf = (float)((t / grid_x) * TILE + spc / TILE);
  const int s = tile_start[t];
  const int e = tile_end[t];

  float T = 1.0f;
  bool done = sp < 0;          // empty slots start latched
  float feat[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) feat[k] = 0.f;
  // run-time width: the slot's feat row accumulates in place (slots past S
  // are latched and never contribute)
  float* fo = feat_out + ((size_t)t * S + i) * E;
  if constexpr (DYN) {
    if (i < S)
      for (int k = 0; k < E; ++k) fo[k] = 0.f;
  }
  int last = 0;

  // the first batch in flight before the loop
  if (s < e)
    gather_rows(rows, RS, flat, D, RS, sorted_gid + s, min(BATCH, e - s),
                warp, nw, lane, gids);
  __pipeline_commit();
  int buf = 0;
  for (int base = s; base < e; base += BATCH) {
    // this thread's copies of the batch have landed; the barrier makes
    // every thread's visible and ends the walk of the previous batch (its
    // buffer takes the next one). Every slot latched: nothing later in the
    // tile can change one, so the block leaves.
    __pipeline_wait_prior(0);
    if (__syncthreads_count(done) == nthr) break;
    const int nb = min(BATCH, e - base);
    const int next = base + BATCH;
    if (next < e)
      gather_rows(rows + (buf ^ 1) * BATCH * RS, RS, flat, D, RS,
                  sorted_gid + next, min(BATCH, e - next), warp, nw, lane,
                  ALL ? nullptr : gids + (buf ^ 1) * BATCH);
    __pipeline_commit();
    const float* rb = rows + buf * BATCH * RS;
    const int* gb = ALL ? nullptr : gids + buf * BATCH;
    buf ^= 1;
    if (done) continue;

    // the recurrence of pair j of the batch, given its alpha; true where
    // the contribution would take T below 1e-4: the slot latches and the
    // contribution is dropped
    auto apply = [&](int j, float alpha) -> bool {
      const float* g = ALL ? rb + j * RS
                           : flat + (size_t)gb[j] * D;   // its features
      const float test_T = T * (1.0f - alpha);
      if (test_T < T_DONE) return true;
      const float w = alpha * T;
      if constexpr (DYN) {
        for (int k = 0; k < E; ++k) fo[k] = fo[k] + w * g[EXT + k];
      } else {
#pragma unroll
        for (int k = 0; k < ES; ++k) feat[k] = feat[k] + w * g[EXT + k];
      }
      last = base - s + j + 1;
      T = test_T;
      return false;
    };
    // FWD_U pairs evaluated, then their recurrence in pair order
    int j = 0;
    for (; j + FWD_U <= nb && !done; j += FWD_U) {
      float al[FWD_U];
      bool mk[FWD_U];
#pragma unroll
      for (int u = 0; u < FWD_U; ++u) {
        const Terms q = eval(rb + (j + u) * RS, pxf, pyf);
        al[u] = q.alpha;
        mk[u] = q.m;
      }
#pragma unroll
      for (int u = 0; u < FWD_U; ++u) {
        if (mk[u] && apply(j + u, al[u])) {
          done = true;
          break;
        }
      }
    }
    for (; j < nb && !done; ++j) {
      const Terms q = eval(rb + j * RS, pxf, pyf);
      if (q.m && apply(j, q.alpha)) done = true;
    }
  }
  if (i < S) {
#pragma unroll
    for (int k = 0; k < ES; ++k) fo[k] = feat[k];
    float* ao = aux_out + ((size_t)t * S + i) * 2;
    ao[0] = T;
    ao[1] = (float)last;
  }
}

// K6: block b walks tile order[b] (the tiles longest range first), back to
// front from its largest n_contrib. batch: none (the staged rows hold the
// EVAL_COLS columns at any E); G: pairs per barrier (SPARSE_GROUP at
// E = 16).
template <int ET>
__global__ void __launch_bounds__(MAX_THREADS)
sparse_bwd_kernel(const float* __restrict__ flat,
                  const int* __restrict__ sorted_gid,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_end,
                  const long long* __restrict__ order,
                  const int* __restrict__ spix, int S, int grid_x,
                  int n_extra, int group, const float* __restrict__ gout,
                  const float* __restrict__ aux, float* __restrict__ d_sorted) {
  constexpr bool DYN = ET < 0;
  constexpr int ES = DYN ? 0 : ET;
  constexpr int NF = ES > 0 ? ES : 1;
  constexpr int NL = scatter_left(ES);       // columns a lane ends with
  const int E = DYN ? n_extra : ET;
  const int D = 21 + E;
  const int G = DYN ? group : SPARSE_GROUP;
  // two buffers of BATCH rows of EVAL_COLS columns
  __shared__ float rows[2 * BATCH * EVAL_COLS];
  // the warp partials [2][G][MAX_WARPS][E] of two groups of pairs
  __shared__ float part_s[DYN ? 1 : 2 * SPARSE_GROUP * MAX_WARPS * NF];
  extern __shared__ float part_d[];
  float* part = DYN ? part_d : part_s;
  __shared__ int max_nc;

  const int t = (int)__ldg(order + blockIdx.x);
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int nw = blockDim.x >> 5;
  const int sp = i < S ? spix[(size_t)t * S + i] : -1;
  const int spc = sp >= 0 ? sp : 0;
  const float pxf = (float)((t % grid_x) * TILE + spc % TILE);
  const float pyf = (float)((t / grid_x) * TILE + spc / TILE);
  const int s = tile_start[t];
  const int e = tile_end[t];

  const float* gi = gout + ((size_t)t * S + i) * E;   // read only if i < S
  float gext[NF];
#pragma unroll
  for (int k = 0; k < ES; ++k) gext[k] = i < S ? gi[k] : 0.f;
  const float T_fin = i < S ? aux[((size_t)t * S + i) * 2] : 1.f;
  // empty slots contribute nowhere
  const int nc = sp >= 0 ? (int)aux[((size_t)t * S + i) * 2 + 1] : 0;
  // where this lane's reduced columns go in the warp's partial row
  int wcol[NF];
  bool wown[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    wcol[k] = k;
    wown[k] = k < ES;
  }
  scatter_owners<ES>(wcol, wown, lane);

  // the tile's largest n_contrib: no pair after it has a contribution
  if (i == 0) max_nc = 0;
  __syncthreads();
  int wmax = nc;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    wmax = max(wmax, __shfl_xor_sync(FULL_MASK, wmax, off));
  if (lane == 0) atomicMax(&max_nc, wmax);
  __syncthreads();
  const int hi = s + min(max_nc, e - s);
  for (int k = i; k < (e - hi) * E; k += blockDim.x)
    d_sorted[(size_t)hi * E + k] = 0.f;

  // the batches from the top down, the next one in flight while one is
  // walked
  auto stage = [&](int b, int top) {
    const int base = max(s, top - BATCH);
    gather_rows(rows + b * BATCH * EVAL_COLS, EVAL_COLS, flat, D, EVAL_COLS,
                sorted_gid + base, top - base, warp, nw, lane, nullptr);
  };
  if (hi > s) stage(0, hi);
  __pipeline_commit();
  float T = T_fin;   // transmittance after the current pair
  int buf = 0, pbuf = 0;
  for (int top = hi; top > s; top -= BATCH) {
    const int base = max(s, top - BATCH);
    const int nb = top - base;
    // this batch has landed, and the previous one is no longer read
    __pipeline_wait_prior(0);
    __syncthreads();
    if (base > s) stage(buf ^ 1, base);
    __pipeline_commit();
    const float* rb = rows + buf * BATCH * EVAL_COLS;
    buf ^= 1;
    // pair j of the batch, given its evaluation (alpha, the splat's mask)
    auto pair = [&](int j, float alpha, bool m) {
      const int slot = base - s + j + 1;
      const bool cm = m && slot <= nc;
      float c[NF];
#pragma unroll
      for (int k = 0; k < NF; ++k) c[k] = 0.f;
      float w = 0.f;
      if (cm) {
        const float Ti = T / (1.0f - alpha);
        w = alpha * Ti;
        T = Ti;
#pragma unroll
        for (int k = 0; k < ES; ++k) c[k] = w * gext[k];
      }
      const int jj = j & (G - 1);             // the pair's place in its group
      float* pw = part + ((pbuf * G + jj) * MAX_WARPS + warp) * E;
      const bool any = __any_sync(FULL_MASK, cm);
      // a warp without a contribution writes its zeros unreduced
      if (any) scatter_reduce<ES>(c, lane);
#pragma unroll
      for (int k = 0; k < NL; ++k)
        if (wown[k]) pw[wcol[k]] = c[k];
      if constexpr (DYN) {
        // run-time width: the E columns w · gout, one butterfly each
        for (int k = 0; k < E; ++k) {
          float v = 0.f;
          if (any) {
            v = cm ? w * gi[k] : 0.f;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v += __shfl_xor_sync(FULL_MASK, v, off);
          }
          if (lane == 0) pw[k] = v;
        }
      }
      if (jj == 0) {
        // the group's pairs j .. j + cnt - 1 are reduced by every warp: one
        // barrier (the partials are double-buffered, so the next group's
        // writes go to the other buffer while these are read), then every
        // thread sums each (pair, column)'s warp partials in the order
        // w0, w1, .. and stores the group's rows in the output's order
        const int cnt = min(G, nb - j);
        __syncthreads();
        const float* pb = part + pbuf * G * MAX_WARPS * E;
        for (int k = i; k < cnt * E; k += blockDim.x) {
          const int r = k / E;
          const int col = k - r * E;
          const float* pc = pb + r * MAX_WARPS * E + col;
          float sum = pc[0];
          for (int w8 = 1; w8 < nw; ++w8) sum = sum + pc[w8 * E];
          d_sorted[(size_t)(base + j) * E + k] = sum;
        }
        pbuf ^= 1;
      }
    };
    // SPARSE_U pairs evaluated ahead of their recurrence, back to front
    int j = nb - 1;
    for (; j >= SPARSE_U - 1; j -= SPARSE_U) {
      float al[SPARSE_U];
      bool mk[SPARSE_U];
#pragma unroll
      for (int u = 0; u < SPARSE_U; ++u) {
        const Terms q = eval(rb + (j - u) * EVAL_COLS, pxf, pyf);
        al[u] = q.alpha;
        mk[u] = q.m;
      }
#pragma unroll
      for (int u = 0; u < SPARSE_U; ++u) pair(j - u, al[u], mk[u]);
    }
    for (; j >= 0; --j) {
      const Terms q = eval(rb + j * EVAL_COLS, pxf, pyf);
      pair(j, q.alpha, q.m);
    }
  }
}

int threads_for(int S) { return (S + 31) / 32 * 32; }

// K6 at run-time width: the partials of its group of pairs per barrier fit
// the budget beside its static rows
cudaError_t launch_bwd_dyn(const float* flat, const int* sorted_gid,
                           const int* tile_start, const int* tile_end,
                           const long long* order, int num_tiles, int grid_x,
                           int n_extra, const int* spix, int S,
                           const float* gout, const float* aux,
                           float* d_sorted, cudaStream_t st) {
  auto* kernel = sparse_bwd_kernel<DYN_E>;
  const int window = smem::WINDOW - K6_ROWS;
  const int budget =
      smem::budget(kernel, sparse_part_bytes(n_extra, 1), window);
  const int G = sparse_group(n_extra, budget);
  const size_t bytes = sparse_part_bytes(n_extra, G);
  if (bytes > (size_t)budget) return cudaErrorInvalidValue;   // too wide
  const cudaError_t err = smem::allow(kernel, bytes, window);
  if (err != cudaSuccess) return err;
  kernel<<<num_tiles, threads_for(S), bytes, st>>>(
      flat, sorted_gid, tile_start, tile_end, order, spix, S, grid_x,
      n_extra, G, gout, aux, d_sorted);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Each returns a cudaError_t (0 = launched).
// One block per tile (num_tiles = spix's rows), threads_for(S) threads;
// order [num_tiles] int64: the tiles longest range first (block b walks
// tile order[b]; ops/blend_visits.walk_order). n_extra: 1 <= E <=
// sparse_max_width().
extern "C" int sparse_fwd_launch(const float* flat, const int* sorted_gid,
                                 const int* tile_start, const int* tile_end,
                                 const long long* order, int num_tiles,
                                 int grid_x, int n_extra, const int* spix,
                                 int S, float* feat, float* aux,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_tiles <= 0) return (int)cudaSuccess;
  if (S <= 0 || S > MAX_THREADS) return (int)cudaErrorInvalidValue;
  if (order == nullptr) return (int)cudaErrorInvalidValue;
  if (n_extra == 16)
    sparse_fwd_kernel<16><<<num_tiles, threads_for(S), 0, st>>>(
        flat, sorted_gid, tile_start, tile_end, order, spix, S, grid_x,
        n_extra, feat, aux);
  else if (n_extra > 0)
    sparse_fwd_kernel<DYN_E><<<num_tiles, threads_for(S), 0, st>>>(
        flat, sorted_gid, tile_start, tile_end, order, spix, S, grid_x,
        n_extra, feat, aux);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int sparse_bwd_launch(const float* flat, const int* sorted_gid,
                                 const int* tile_start, const int* tile_end,
                                 const long long* order, int num_tiles,
                                 int grid_x, int n_extra,
                                 const int* spix, int S, const float* gout,
                                 const float* aux, float* d_sorted,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_tiles <= 0) return (int)cudaSuccess;
  if (S <= 0 || S > MAX_THREADS) return (int)cudaErrorInvalidValue;
  if (order == nullptr) return (int)cudaErrorInvalidValue;
  if (n_extra == 16) {
    sparse_bwd_kernel<16><<<num_tiles, threads_for(S), 0, st>>>(
        flat, sorted_gid, tile_start, tile_end, order, spix, S, grid_x,
        n_extra, SPARSE_GROUP, gout, aux, d_sorted);
    return (int)cudaGetLastError();
  }
  if (n_extra > 0)
    return (int)launch_bwd_dyn(flat, sorted_gid, tile_start, tile_end, order,
                               num_tiles, grid_x, n_extra, spix, S, gout, aux,
                               d_sorted, st);
  return (int)cudaErrorInvalidValue;
}

// The widest n_extra both entries take on the current device: K6's
// partials of a group of one pair beside its rows (K5 stages the same
// columns at any E). -1 where the device cannot be queried.
extern "C" int sparse_max_width(void) {
  const int left = smem::optin_left(sparse_bwd_kernel<DYN_E>);
  return left > 0 ? left / (int)sparse_part_bytes(1, 1) : -1;
}
