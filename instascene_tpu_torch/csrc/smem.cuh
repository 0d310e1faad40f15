// Shared memory of the run-time-width (DYN_E) instantiations of the blend
// kernels (csrc/blend_walk.cuh, csrc/blend_sparse.cu).
//
// A block gets 48 KB of shared memory without opting in. Above that it
// gets only dynamic shared memory, after cudaFuncSetAttribute(kernel,
// cudaFuncAttributeMaxDynamicSharedMemorySize, bytes), up to the device's
// opt-in limit (cudaDevAttrMaxSharedMemoryPerBlockOptin: 232,448 B on the
// H100) less the kernel's static arrays. A run-time-width launch stages
// its rows (and the backward's partials) in the 48 KB window while its
// smallest staging fits there, so every E up to a few hundred keeps the
// batches, groups and occupancy it always had; a wider E opts in and takes
// the whole limit. The widest E is the one whose smallest staging still
// fits the limit: each library exports it (`*_max_width`), and
// ops/blend_visits.width_limit takes the least of them once per device.

#pragma once

#include <cuda_runtime.h>

namespace smem {

// the dynamic shared memory a block may take without opting in: the 48 KB
// window less room for the static arrays of the run-time-width
// instantiations (a few words, or TRACK's 1 KB list of ids)
constexpr int WINDOW = 46 * 1024;

// the device's opt-in limit less the kernel's static arrays, in bytes;
// 0 where a query fails
template <class K>
int optin_left(K* kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, kernel) != cudaSuccess)
    return 0;
  return optin - (int)fa.sharedSizeBytes;
}

// the dynamic budget of a launch whose smallest staging takes `need`
// bytes: `window` (the bytes left of the 48 KB beside the kernel's static
// arrays) while that fits, else the opt-in limit less the static arrays
template <class K>
int budget(K* kernel, size_t need, int window = WINDOW) {
  return need <= (size_t)window ? window : optin_left(kernel);
}

// before a launch with `bytes` of dynamic shared memory: opts the kernel in
// where they pass `window`
template <class K>
cudaError_t allow(K* kernel, size_t bytes, int window = WINDOW) {
  if (bytes <= (size_t)window) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace smem
