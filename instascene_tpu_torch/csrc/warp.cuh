// Warp-level pieces the blend walks share: the reduce-scatter of a warp's
// per-lane columns (K2, K4, K8 in csrc/blend_walk.cuh; K6 in
// csrc/blend_sparse.cu) and the row-wise gather of pair rows into shared
// memory by cp.async (K1, K3 in blend_walk.cuh; K6).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace warp {

constexpr unsigned FULL_MASK = 0xffffffffu;

// The warp's sum of N columns, reduce-scatter: at each level off = 16 .. 1
// a lane's list of columns splits in halves; the lane keeps the first half
// where lane & off is 0 and the second otherwise, and each pair of columns
// takes one shuffle: the lane sends the value it gives up and adds the
// value it receives to the one it keeps. An odd column out stays on both
// halves and takes a shuffle of its own. Each kept value is v_L + v_{L^off},
// the per-column butterfly's own sum at that level (float addition commutes
// bit for bit), so every column ends as the butterfly's bits, in positions
// 0 .. scatter_left(N) - 1 of c. tests/test_torch_warp_reduce.py models
// this schedule.
__host__ __device__ constexpr int scatter_left(int n, int off = 16) {
  return off == 0 ? n : scatter_left(n / 2 + n % 2, off / 2);
}

template <int N, int OFF = 16>
__device__ __forceinline__ void scatter_reduce(float* c, int lane) {
  if constexpr (OFF > 0 && N > 0) {
    constexpr int H = N / 2;
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? c[i] : c[H + i];
      const float keep = up ? c[H + i] : c[i];
      c[i] = keep + __shfl_xor_sync(FULL_MASK, send, OFF);
    }
    if constexpr (N % 2 == 1)
      c[H] = c[N - 1] + __shfl_xor_sync(FULL_MASK, c[N - 1], OFF);
    scatter_reduce<H + N % 2, OFF / 2>(c, lane);
  }
}

// The column each of the lane's final positions holds (col) and whether
// this lane stores it (own): of the lanes an odd column out stays on, the
// one with the level's bit clear, so each column has one writer.
template <int N, int OFF = 16>
__device__ __forceinline__ void scatter_owners(int* col, bool* own,
                                               int lane) {
  if constexpr (OFF > 0 && N > 0) {
    constexpr int H = N / 2;
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      col[i] = up ? col[H + i] : col[i];
      own[i] = up ? own[H + i] : own[i];
    }
    if constexpr (N % 2 == 1) {
      col[H] = col[N - 1];
      own[H] = own[N - 1] && !up;
    }
    scatter_owners<H + N % 2, OFF / 2>(col, own, lane);
  }
}

// Columns [0, cols) of the pair rows [0, nb) of gid (a stretch of the
// depth-sorted pair list) → rows[r * rs + c] = flat[gid[r] * D + c], issued
// as 4-byte cp.async copies (a row of 21 or 37 floats is not 16-byte
// aligned) that the caller commits and waits for. Warp w of nw takes a
// contiguous stretch of rows: one coalesced load of up to 32 of their ids
// (lane i holds row i's), then per row its lanes copy the columns. No
// division per element. gids (may be null): each row's id, stored as well.
__device__ __forceinline__ void gather_rows(float* rows, int rs,
                                            const float* flat, int D,
                                            int cols, const int* gid, int nb,
                                            int w, int nw, int lane,
                                            int* gids) {
  const int per = (nb + nw - 1) / nw;
  const int r_end = min(nb, (w + 1) * per);
  for (int r0 = w * per; r0 < r_end; r0 += 32) {
    const int n = min(32, r_end - r0);
    const int g = lane < n ? __ldg(gid + r0 + lane) : 0;
    if (gids != nullptr && lane < n) gids[r0 + lane] = g;
    for (int i = 0; i < n; ++i) {
      const int gi = __shfl_sync(FULL_MASK, g, i);
      const float* src = flat + (size_t)gi * D;
      float* dst = rows + (r0 + i) * rs;
      for (int c = lane; c < cols; c += 32)
        __pipeline_memcpy_async(dst + c, src + c, sizeof(float));
    }
  }
}

}  // namespace warp
