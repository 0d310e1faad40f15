// Forward and backward blend over the padded per-tile layout (K7, K8).
//
// Replaces the TPU kernels instascene_tpu/ops/blend_pallas.py::_fwd_kernel
// (K7, launched by blend_fwd_pallas) and ::_bwd_kernel (K8, launched by
// blend_bwd_pallas under blend_pallas_diff's VJP). Inputs: packed
// [T, D, K] f32 (D = 21 + E, K % 128 == 0), tile t's depth-sorted pair rows
// in columns 0..count[t) (the rest sentinel zero rows, never read), and
// count [T] i32. K7 writes K1's `full` outputs, out [T, 12+E, 256] f32 and
// iout [T, 2, 256] i32 (rows listed in csrc/blend_fwd.cu); an empty tile
// writes final T = 1 and zeros elsewhere. K8 takes gout [T, 12+E, 256] (the
// cotangent of out), saved [T, 3, 256] (out's final T, m1 and m2 rows) and
// K7's iout, and writes d(packed) [T, D, K]: per slot, the gradient of
// Σ gout·out with respect to that slot's packed column, zero in every
// column from the tile's last contribution on (so beyond count[t] too).
//
// Design. The TPU kernels walk a (tile, 128-slot chunk) grid sequentially,
// carry T, m1, m2 and the done latch (backward: T and the suffix sum) in
// VMEM scratch and turn the per-slot recurrence into log-step prefix
// sums and products over each chunk. Here the walk is K1's and K2's own
// (csrc/blend_walk.cuh) over PaddedRows: one block of 256 threads per tile,
// one thread per pixel, the recurrence a plain sequential loop. The block
// stages batches of packed[t, :, k0:k0+128] in shared memory (the forward
// by cp.async into two buffers, the next batch in flight while one is
// walked), each column read along K (neighbouring threads on neighbouring
// slots: coalesced, no gather), and walks count[t] slots only, never K.
// The forward takes the tiles largest count first (the wrapper's stable
// argsort), latches a pixel done at T < 1e-4 and leaves when all 256
// are done; the backward starts at the tile's largest n_contrib, recovers
// T before each slot as T_after / (1 - alpha) from the saved final T, m1
// and m2 totals, reduces the slot's 21+E column terms over the 256 pixels
// in a fixed order (a reduce-scatter across each warp, then the 8 warp
// partials summed in order, one barrier per 8 slots) and stores the column
// d(packed)[t, :, slot] once: no atomics, so two runs are bit for bit
// equal. The JAX package's cumprod form and this sequential form round
// differently; both are held to the tolerances of its own tests
// (tests/test_blend_pallas.py:83-93) against a slot-sequential plain
// version (ops/blend_padded.py).
//
// What bounds it on the H100. K7 is K1 `full` on another layout: FP32 issue
// (41 operations per evaluated (slot, pixel), 35 + 2E per contribution),
// while the bytes it must move are the real slots' columns of packed (not
// the padding: the walk stops at count[t]) and the outputs. K8 is K2
// `full`'s instruction issue (the splat per (slot, pixel) up to n_contrib,
// 78 + 3E per contribution, 5·(21+E) shuffles per reduced slot) plus
// writing all of d(packed): at 1080p that tensor is ~3 GB, ~16x the real
// slots' columns, so the zero fill of the padding (~0.9 ms of HBM time)
// is a floor of its own. chip_smoke.py computes both bounds per run.
//
// Feature widths: E = 0 and 16 are compiled as constants, any other E >= 1
// runs the run-time-width instantiation (blend_walk.cuh), up to the widest
// whose staging fits the device's shared memory (csrc/smem.cuh).

#include <cuda_runtime.h>

#include "blend_walk.cuh"

namespace {

using namespace walk;

template <int ET>
cudaError_t launch_fwd(const PaddedRows& src, int num_tiles, int grid_x,
                       int n_extra, const long long* order, float* out,
                       int* iout, cudaStream_t stream) {
  auto* kernel = blend_fwd_kernel<ET, FULL, false, PaddedRows>;
  const int D = 21 + n_extra;
  int batch = FWD_BATCH;
  size_t bytes = 0;
  if (ET < 0) {
    const cudaError_t err = fwd_staging(kernel, D, batch, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<num_tiles, P2, bytes, stream>>>(src, n_extra, batch, grid_x, order,
                                           nullptr, 0, nullptr, out, iout,
                                           nullptr, nullptr);
  return cudaGetLastError();
}

template <int ET>
cudaError_t launch_bwd(const PaddedRows& src, int num_tiles, int grid_x,
                       int n_extra, const float* gout, const float* saved,
                       const int* iout, float* d_packed,
                       cudaStream_t stream) {
  auto* kernel = blend_bwd_kernel<ET, B_FULL, false, PaddedRows>;
  const int D = 21 + n_extra;
  int batch = BWD_BATCH, group = GROUP;
  size_t bytes = 0;
  if (ET < 0) {
    const cudaError_t err = bwd_staging(kernel, D, D, batch, group, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<num_tiles, P2, bytes, stream>>>(src, n_extra, batch, group,
                                           grid_x, nullptr, 0, gout, saved,
                                           iout, d_packed);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Each returns a cudaError_t (0 = launched).
// One block per tile; packed [num_tiles, 21 + n_extra, K], count[t] <= K
// (the wrapper asserts it), 0 <= n_extra <= blend_padded_max_width(). K7's
// order [num_tiles]
// int64: the tiles by count, largest first (block b walks tile order[b]).
extern "C" int blend_fwd_padded_launch(const float* packed, const int* count,
                                       int num_tiles, int K, int grid_x,
                                       int n_extra, const long long* order,
                                       float* out, int* iout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_tiles <= 0) return (int)cudaSuccess;
  if (order == nullptr) return (int)cudaErrorInvalidValue;
  const PaddedRows src{packed, count, K};
  if (n_extra == 16)
    return (int)launch_fwd<16>(src, num_tiles, grid_x, n_extra, order, out,
                               iout, st);
  if (n_extra == 0)
    return (int)launch_fwd<0>(src, num_tiles, grid_x, n_extra, order, out,
                              iout, st);
  if (n_extra > 0)
    return (int)launch_fwd<DYN_E>(src, num_tiles, grid_x, n_extra, order,
                                  out, iout, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int blend_bwd_padded_launch(const float* packed, const int* count,
                                       int num_tiles, int K, int grid_x,
                                       int n_extra, const float* gout,
                                       const float* saved, const int* iout,
                                       float* d_packed, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_tiles <= 0) return (int)cudaSuccess;
  const PaddedRows src{packed, count, K};
  if (n_extra == 16)
    return (int)launch_bwd<16>(src, num_tiles, grid_x, n_extra, gout, saved,
                               iout, d_packed, st);
  if (n_extra == 0)
    return (int)launch_bwd<0>(src, num_tiles, grid_x, n_extra, gout, saved,
                              iout, d_packed, st);
  if (n_extra > 0)
    return (int)launch_bwd<DYN_E>(src, num_tiles, grid_x, n_extra, gout,
                                  saved, iout, d_packed, st);
  return (int)cudaErrorInvalidValue;
}

// The widest n_extra both entries take on the current device (K8's one row
// and partials of a group of one slot bind first). -1 where the device
// cannot be queried.
extern "C" int blend_padded_max_width(void) {
  const int lf = smem::optin_left(
      blend_fwd_kernel<DYN_E, FULL, false, PaddedRows>);
  const int lb = smem::optin_left(
      blend_bwd_kernel<DYN_E, B_FULL, false, PaddedRows>);
  if (lf <= 0 || lb <= 0) return -1;
  const int wf = fwd_max_width(lf), wb = bwd_max_width(lb);
  return wf < wb ? wf : wb;
}
