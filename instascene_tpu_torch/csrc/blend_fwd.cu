// Forward alpha-compositing blend of 2DGS surfels, one 16x16 tile per block.
//
// Replaces the TPU kernel instascene_tpu/ops/blend_visits.py::_fwd_kernel_visits
// (K1) in its `full`, `viewer`, `no_dist`, `extras_only` (with the optional
// sampled-pixel done0 mask), `track` and `tiles_per_view` modes, and
// instascene_tpu/ops/blend_pallas.py::_fwd_kernel_aligned (K3) over a
// tile-subset mini bundle. Same function, same public layout:
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

#include "splat.cuh"

namespace {

using namespace splat;

constexpr int BATCH = 256;  // pair rows staged in shared memory per pass

// ops/blend_visits.MODES
enum Mode { FULL = 0, VIEWER = 1, NO_DIST = 2, EXTRAS = 3, TRACK = 4 };
constexpr int TRACK_K = 10;      // contributor slots per pixel
constexpr float TRACK_W = 0.1f;  // a contribution is tracked when w > this

template <int E, int MODE>
__global__ void __launch_bounds__(P2)
blend_fwd_kernel(const float* __restrict__ flat,
                 const int* __restrict__ sorted_gid,
                 const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end, int grid_x,
                 const int* __restrict__ tile_ids, int tiles_per_view,
                 const int* __restrict__ done0, float* __restrict__ out,
                 int* __restrict__ iout, int* __restrict__ track_ids,
                 float* __restrict__ track_w) {
  constexpr int D = 21 + E;
  constexpr int OC = 12 + E;
  constexpr int NF = E > 0 ? E : 1;
  constexpr bool COLOR = MODE != EXTRAS;
  constexpr bool AUX = MODE != VIEWER && MODE != EXTRAS;  // normal, median
  constexpr bool DIST = MODE == FULL || MODE == TRACK;    // depth, distortion
  __shared__ float rows[BATCH * D];
  __shared__ int gids[MODE == TRACK ? BATCH : 1];

  const int row = blockIdx.x;                      // output row
  const int t = tile_ids != nullptr ? tile_ids[row] : row;
  const int tl = tiles_per_view > 0 ? t % tiles_per_view : t;
  const int p = threadIdx.x;
  const float pxf = (float)((tl % grid_x) * TILE + p % TILE);
  const float pyf = (float)((tl / grid_x) * TILE + p / TILE);
  const int s = tile_start[t];
  const int e = tile_end[t];

  float T = 1.0f;
  // done0 (extras_only only): pixels the caller will not read start latched
  bool done = MODE == EXTRAS && done0 != nullptr &&
              done0[(size_t)t * P2 + p] != 0;
  int n_track = 0;
  int* tid =
      MODE == TRACK ? track_ids + (size_t)row * TRACK_K * P2 + p : nullptr;
  float* tw =
      MODE == TRACK ? track_w + (size_t)row * TRACK_K * P2 + p : nullptr;
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
    if (MODE == TRACK && p < nb) gids[p] = sorted_gid[base + p];
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
      if (COLOR) {
        col0 = col0 + w * g[COL];
        col1 = col1 + w * g[COL + 1];
        col2 = col2 + w * g[COL + 2];
      }
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
      if (MODE == TRACK && w > TRACK_W && n_track < TRACK_K) {
        tid[n_track * P2] = gids[j];
        tw[n_track * P2] = w;
        ++n_track;
      }
      last = slot;
      T = test_T;
    }
  }
  if (MODE == TRACK) {
    for (int k = n_track; k < TRACK_K; ++k) {
      tid[k * P2] = -1;
      tw[k * P2] = 0.0f;
    }
  }

  float* o = out + (size_t)row * OC * P2 + p;
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
  for (int k = 0; k < E; ++k) o[(10 + k) * P2] = feat[k];
  o[(10 + E) * P2] = M1;
  o[(11 + E) * P2] = M2;
  io[0] = last;
  io[P2] = med_slot;
}

struct Args {
  const float* flat;
  const int* sorted_gid;
  const int* tile_start;
  const int* tile_end;
  int grid_x;
  const int* tile_ids;
  int tiles_per_view;
  const int* done0;
  float* out;
  int* iout;
  int* track_ids;
  float* track_w;
};

template <int E, int MODE>
void launch_mode(const Args& a, int num_rows, cudaStream_t stream) {
  blend_fwd_kernel<E, MODE><<<num_rows, P2, 0, stream>>>(
      a.flat, a.sorted_gid, a.tile_start, a.tile_end, a.grid_x, a.tile_ids,
      a.tiles_per_view, a.done0, a.out, a.iout, a.track_ids, a.track_w);
}

template <int E>
cudaError_t launch(int mode, const Args& a, int num_rows,
                   cudaStream_t stream) {
  if (a.done0 != nullptr && mode != EXTRAS) return cudaErrorInvalidValue;
  if (mode == TRACK && (a.track_ids == nullptr || a.track_w == nullptr))
    return cudaErrorInvalidValue;
  void (*fn)(const Args&, int, cudaStream_t) =
      mode == FULL      ? launch_mode<E, FULL>
      : mode == VIEWER  ? launch_mode<E, VIEWER>
      : mode == NO_DIST ? launch_mode<E, NO_DIST>
      : mode == EXTRAS  ? launch_mode<E, EXTRAS>
      : mode == TRACK   ? launch_mode<E, TRACK>
                        : nullptr;
  if (fn == nullptr) return cudaErrorInvalidValue;
  fn(a, num_rows, stream);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Returns a cudaError_t (0 = launched).
// num_rows blocks: the length of tile_ids, or the number of tiles when
// tile_ids is null. tiles_per_view 0 is off. done0 may be null (required
// null outside extras_only); track_ids and track_w are read only in track
// mode.
extern "C" int blend_fwd_launch(const float* flat, const int* sorted_gid,
                                const int* tile_start, const int* tile_end,
                                int num_rows, int grid_x, int n_extra,
                                int mode, const int* tile_ids,
                                int tiles_per_view, const int* done0,
                                float* out, int* iout, int* track_ids,
                                float* track_w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rows <= 0) return (int)cudaSuccess;
  const Args a{flat,   sorted_gid, tile_start, tile_end,
               grid_x, tile_ids,   tiles_per_view,
               done0,  out,        iout,       track_ids, track_w};
  if (n_extra == 16) return (int)launch<16>(mode, a, num_rows, st);
  if (n_extra == 0) return (int)launch<0>(mode, a, num_rows, st);
  return (int)cudaErrorInvalidValue;
}
