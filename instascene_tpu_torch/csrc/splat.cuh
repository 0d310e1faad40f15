// The splat terms both blend kernels evaluate for one (packed row, pixel)
// pair, and the constants they share.
//
// Replaces instascene_tpu/ops/blend_pallas.py::_splat_terms. The backward
// (blend_bwd.cu) must reproduce the forward's (blend_fwd.cu) contribution
// mask to the bit, so both take it from here; the plain PyTorch version is
// ops/blend_visits.py::_splat. Built with --fmad=false and without fast
// math: every multiply, add, division and expf is rounded alone, and the
// one explicit __fmaf_rn per coordinate is fused, as XLA rounds it.

#pragma once

#include <cuda_runtime.h>

namespace splat {

constexpr int TILE = 16;
constexpr int P2 = TILE * TILE;
constexpr float NEAR_N = 0.2f;
constexpr float MD_SCALE = (float)(100.0 / (100.0 - 0.2));  // FAR/(FAR-NEAR)
constexpr float DMD_DD = (float)(100.0 * 0.2 / (100.0 - 0.2));
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float T_DONE = 1e-4f;

// packed column offsets (instascene_tpu/ops/blend_pallas.py:42-47)
constexpr int TW = 9, XY = 12, NRM = 14, OPA = 17, COL = 18, EXT = 21;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // NaN passes through, as torch.clamp / jnp.clip do
  return x < lo ? lo : (x > hi ? hi : x);
}

struct Terms {
  float alpha, depth_ray, G, sx, sy, inv_pz, dx, dy;
  bool use3d, m;
};

__device__ __forceinline__ Terms eval(const float* g, float pxf, float pyf) {
  Terms q;
  // ray-splat intersection p = x*A + y*B + C (blend_pallas._splat_terms),
  // x*A fused with y*B as XLA rounds it: the form cancels heavily, and
  // alpha sits next to the 1/255 mask often enough that the last bit of p
  // decides contributions
  const float px_ = __fmaf_rn(pxf, g[0], pyf * g[3]) + g[6];
  const float py_ = __fmaf_rn(pxf, g[1], pyf * g[4]) + g[7];
  const float pz_ = __fmaf_rn(pxf, g[2], pyf * g[5]) + g[8];
  const bool pz_ok = pz_ != 0.0f;
  q.inv_pz = 1.0f / (pz_ok ? pz_ : 1.0f);
  q.sx = clampf(px_ * q.inv_pz, -3e4f, 3e4f);
  q.sy = clampf(py_ * q.inv_pz, -3e4f, 3e4f);
  const float rho3d = q.sx * q.sx + q.sy * q.sy;
  q.dx = g[XY] - pxf;
  q.dy = g[XY + 1] - pyf;
  const float rho2d = 2.0f * (q.dx * q.dx + q.dy * q.dy);
  q.use3d = rho3d <= rho2d;
  const float rho = q.use3d ? rho3d : rho2d;
  q.depth_ray = q.use3d ? q.sx * g[TW] + q.sy * g[TW + 1] + g[TW + 2]
                        : g[TW + 2];
  const float power = -0.5f * rho;
  q.G = expf(power);
  q.alpha = fminf(g[OPA] * q.G, 0.99f);
  q.m = pz_ok && q.depth_ray >= NEAR_N && power <= 0.0f &&
        q.alpha >= ALPHA_MIN;
  return q;
}

// clip_rect: the pair's gaussian reaches tile (tx, ty) only if it lies in
// the fresh rect r = (rmin_x, rmax_x, rmin_y, rmax_y), the packed row's 4
// trailing columns (exact small integers in f32; a zero rect gates all)
__device__ __forceinline__ bool in_rect(const float* r, float tx, float ty) {
  return r[0] <= tx && tx < r[1] && r[2] <= ty && ty < r[3];
}

}  // namespace splat
