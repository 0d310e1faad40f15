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
// (csrc/blend_fwd.cu) own: the block stages its tile's pair rows in shared
// memory per batch of 128 (the flat[sorted_gid[j]] gather fused), every
// thread evaluates splat.cuh's terms, drops the contribution that would take
// T below 1e-4 and latches, and the block leaves when all its threads have
// latched (a block whose slots are all empty leaves at once). So a slot's
// values are bit for bit those of K1 `extras_only` at its pixel (with or
// without a done0 mask: a pixel's blend does not depend on its neighbours).
// K6 walks its tile back to front from the largest n_contrib among its
// slots, recovers T before each pair as T_after / (1 - alpha) from the
// saved final T (as K2 does), and reduces w · gout over the slots per pair
// across each warp and then in a fixed cross-warp order in shared memory:
// no atomics, the same bits on every run. Pairs past every slot's
// n_contrib get zero rows without a walk (the JAX kernel's `beyond` test).
// The per-gaussian sum is the segment sum of csrc/blend_bwd.cu at D = E.
//
// K6's schedule (its first design ran 1.65 ms on the 32k-draw frame, 70x
// its bound): the blocks take the tiles longest range first (the wrapper's
// stable argsort, as K1); it stages only columns 0-17, the span
// splat.cuh::eval reads (not the colour or the features: 18 of 37 floats
// at E = 16), row by row by cp.async into two buffers, the next batch in flight while
// one is walked; it evaluates SPARSE_U pairs ahead of the T recurrence; and
// at E = 16 it reduces the 16 columns with warp.cuh's reduce-scatter (16
// shuffles per warp per pair, not 80 in 16 butterflies, the butterflies'
// bits) into double-buffered partials of 8 pairs, one barrier per group,
// after which every thread stores the group's rows in the output's order.
//
// What bounds them on the H100: the bytes. On the semantic step's 976x728
// frame a tile holds ~12 (up to S = 48) of its 256 pixels, so the FP32 work
// is ~S/256 of K1's (41 operations per evaluation, 4 + 2E per
// contribution), while every block still gathers the rows of the pairs it
// walks: the flat columns of those pairs and the pair list dominate (the
// 15 splat columns + E features per walked row, then spix, feat and aux).
// The design keeps the gather fused (no packed copy), stops each block at
// its last slot's latch (K5) or at its largest n_contrib (K6), and runs
// blocks of 32-128 threads so that many of them fit an SM.
//
// Feature widths: E = 16 is compiled as a constant; any other E in
// [1, 256] runs the run-time-width instantiation (DYN_E): K5 accumulates a
// slot's features in its own feat row (each thread owns its slot: no race,
// the same order of additions) and its staged batch shrinks to fit 48 KB
// of shared memory; K6 reads gout per feature and reduces the E columns in
// a loop, one butterfly each, with a group of pairs per barrier whose
// partials fit beside its rows (sparse_group).
//
// Rounding: see splat.cuh. The plain PyTorch versions
// (ops/blend_sparse.py::blend_sparse_fwd_reference, _bwd_reference) are
// K1's and K2's plain versions evaluated at the sampled pixels.

#include <cuda_runtime.h>

#include "splat.cuh"
#include "warp.cuh"

namespace {

using namespace splat;
using namespace warp;

constexpr int BATCH = 128;          // pair rows staged in shared memory
constexpr int MAX_THREADS = 128;    // S <= 128, as the JAX kernels take
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int DYN_E = -1;           // E given at run time
constexpr int MAX_E = 256;
constexpr int SMEM_BUDGET = 46 * 1024;
constexpr int EVAL_COLS = OPA + 1;  // the span of columns eval reads
constexpr int SPARSE_GROUP = 8;     // K6's pairs per barrier at E = 16
constexpr int SPARSE_U = 2;         // K6's pairs evaluated ahead

// K5's pair rows staged per pass at run-time width
int fwd_batch(int D) { return BATCH < SMEM_BUDGET / (4 * D) ? BATCH
                                                          : SMEM_BUDGET / (4 * D); }
// K6's pairs per barrier at run-time width: its double-buffered partials
// fit beside the two buffers of rows
int sparse_group(int E) {
  int g = SPARSE_GROUP;
  while (g > 1 && 2 * g * MAX_WARPS * E * 4 >
                      SMEM_BUDGET - 2 * BATCH * EVAL_COLS * 4)
    g >>= 1;
  return g;
}

template <int ET>
__global__ void __launch_bounds__(MAX_THREADS)
sparse_fwd_kernel(const float* __restrict__ flat,
                  const int* __restrict__ sorted_gid,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_end,
                  const int* __restrict__ spix, int S, int grid_x,
                  int n_extra, int batch,
                  float* __restrict__ feat_out, float* __restrict__ aux_out) {
  constexpr bool DYN = ET < 0;
  constexpr int ES = DYN ? 0 : ET;
  constexpr int NF = ES > 0 ? ES : 1;
  const int E = DYN ? n_extra : ET;
  const int D = 21 + E;
  const int nbatch = DYN ? batch : BATCH;
  __shared__ float rows_s[DYN ? 1 : BATCH * (21 + ES)];
  extern __shared__ float rows_d[];
  float* rows = DYN ? rows_d : rows_s;

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int nthr = blockDim.x;
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

  for (int base = s; base < e; base += nbatch) {
    // every slot latched: nothing later in the tile can change one; also
    // the barrier that keeps the previous batch's rows until all read them
    if (__syncthreads_count(done) == nthr) break;
    const int nb = min(nbatch, e - base);
    for (int k = i; k < nb * D; k += nthr) {
      const int r = k / D;
      const int c = k - r * D;
      rows[k] = flat[(size_t)sorted_gid[base + r] * D + c];
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
      if constexpr (DYN) {
        for (int k = 0; k < E; ++k) fo[k] = fo[k] + w * g[EXT + k];
      } else {
#pragma unroll
        for (int k = 0; k < ES; ++k) feat[k] = feat[k] + w * g[EXT + k];
      }
      last = base - s + j + 1;
      T = test_T;
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

}  // namespace

// Plain C entry points for ctypes. Each returns a cudaError_t (0 = launched).
// One block per tile (num_tiles = spix's rows), threads_for(S) threads.
extern "C" int sparse_fwd_launch(const float* flat, const int* sorted_gid,
                                 const int* tile_start, const int* tile_end,
                                 int num_tiles, int grid_x, int n_extra,
                                 const int* spix, int S, float* feat,
                                 float* aux, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_tiles <= 0) return (int)cudaSuccess;
  if (S <= 0 || S > MAX_THREADS) return (int)cudaErrorInvalidValue;
  if (n_extra == 16) {
    sparse_fwd_kernel<16><<<num_tiles, threads_for(S), 0, st>>>(
        flat, sorted_gid, tile_start, tile_end, spix, S, grid_x, n_extra,
        BATCH, feat, aux);
  } else if (n_extra > 0 && n_extra <= MAX_E) {
    const int batch = fwd_batch(21 + n_extra);
    sparse_fwd_kernel<DYN_E><<<num_tiles, threads_for(S),
                               (size_t)batch * (21 + n_extra) * 4, st>>>(
        flat, sorted_gid, tile_start, tile_end, spix, S, grid_x, n_extra,
        batch, feat, aux);
  } else {
    return (int)cudaErrorInvalidValue;
  }
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
  } else if (n_extra > 0 && n_extra <= MAX_E) {
    const int G = sparse_group(n_extra);
    sparse_bwd_kernel<DYN_E><<<num_tiles, threads_for(S),
                               (size_t)2 * G * MAX_WARPS * n_extra * 4, st>>>(
        flat, sorted_gid, tile_start, tile_end, order, spix, S, grid_x,
        n_extra, G, gout, aux, d_sorted);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
