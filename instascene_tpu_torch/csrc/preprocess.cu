// Preprocess + SH in one pass: per gaussian the splat→pixel homography T,
// the view normal, depth, the low-pass centre, the radius, the
// opacity-aware tile rect, the visibility and the SH colour, for the
// renders that build no autograd graph (viewer frames, the tracker, the
// semantic step's frozen geometry, binning caches, mesh export).
//
// Replaces no TPU kernel: the JAX package leaves preprocess to XLA, which
// fuses it into a few loops. The plain version is the eager chain of
// ops/preprocess.py::preprocess_plain and ops/sh.py::sh_to_color, about
// 456 launches a view, which the rendering of geometry under autograd
// still takes. This kernel computes the same outputs in one launch, one
// thread per gaussian.
//
// Bits. The blend's alpha mask is sensitive to the last bit of T (see
// ops/preprocess.py's docstring), so every operation is the plain
// version's, in its order: its fma() (a float product made exact in
// double, one double add, one cast) is fmad() below, not __fmaf_rn; every
// other multiply, add and division is rounded alone (the build passes
// --fmad=false); rsqrtf, sqrtf, logf, floorf and ceilf are the functions
// PyTorch's CUDA kernels call; clamp, maximum and minimum pass NaN through
// as torch's do; Python constants are rounded to float as torch rounds a
// scalar operand. The two reductions follow the order PyTorch's reduce
// kernel takes for a row this short, two lanes striding by 2, each summing
// its elements in order, then lane 0 + lane 1 (measured on the H100 with
// PyTorch 2.11, CUDA 12.8, against every candidate order): the
// quaternion's torch.sum of 4 squares is (q0² + q2²) + (q1² + q3²), and
// torch.linalg.norm of the 3 view-direction components the root of
// (d0² + d2²) + d1². tests/test_torch_preprocess_kernel.py holds every
// output bit for bit against the plain version on the card.
//
// What bounds it on the H100: the bytes. A gaussian reads 36 bytes of
// geometry, its opacity and alive flag and, at SH degree 3, 192 bytes of
// coefficients, and writes 97 bytes: ~330 bytes, 99 MB at 300k gaussians,
// 0.03 ms at 3.35 TB/s. The arithmetic is ~400 FP32 and ~150 FP64
// operations a gaussian. The camera (w2v, full_proj, campos: 35 floats)
// is read from device memory by every thread, one cached broadcast, and
// ndc2pix @ full_proj (12 entries, 4 terms each) is recomputed per thread
// rather than staged: it costs less than a barrier.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int THREADS = 256;

// ops/preprocess.py::fma: a·b exact in double, one rounded double add,
// one rounding to float
__device__ __forceinline__ float fmad(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b),
                                     (double)c));
}

// torch.maximum / torch.minimum / torch.clamp on float: NaN passes
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float tclamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// ops/preprocess.py::_rows for one output: x · M[j, :3] as an fma chain
__device__ __forceinline__ float rows3(const float x[3], const float* m) {
  float acc = x[0] * m[0];
  acc = fmad(x[1], m[1], acc);
  return fmad(x[2], m[2], acc);
}

// ops/preprocess.py::_conic_box for t = (t0, t0, -1); T row-major [3,3],
// rows (Tu, Tv, Tw)
struct Box {
  bool ok;
  float cx, cy, h0x, h0y;
};

__device__ __forceinline__ Box conic_box(float t0, const float* T,
                                         float d_scale) {
  const float t[3] = {t0, t0, -1.0f};
  const float* Tw = T + 6;
  const float d = ((t[0] * Tw[0]) * Tw[0] + (t[1] * Tw[1]) * Tw[1]) +
                  (t[2] * Tw[2]) * Tw[2];
  Box b;
  b.ok = fabsf(d) > (float)1e-7 * d_scale && d_scale > 0.0f;
  const float dd = b.ok ? d : 1.0f;
  const float f[3] = {t[0] / dd, t[1] / dd, t[2] / dd};
  const float* Tu = T;
  const float* Tv = T + 3;
  b.cx = tclamp(((f[0] * Tu[0]) * Tw[0] + (f[1] * Tu[1]) * Tw[1]) +
                    (f[2] * Tu[2]) * Tw[2],
                -1e7f, 1e7f);
  b.cy = tclamp(((f[0] * Tv[0]) * Tw[0] + (f[1] * Tv[1]) * Tw[1]) +
                    (f[2] * Tv[2]) * Tw[2],
                -1e7f, 1e7f);
  b.h0x = b.cx * b.cx - (((f[0] * Tu[0]) * Tu[0] + (f[1] * Tu[1]) * Tu[1]) +
                         (f[2] * Tu[2]) * Tu[2]);
  b.h0y = b.cy * b.cy - (((f[0] * Tv[0]) * Tv[0] + (f[1] * Tv[1]) * Tv[1]) +
                         (f[2] * Tv[2]) * Tv[2]);
  return b;
}

// ops/sh.py::eval_sh for one colour channel; s points at coefficient 0 of
// the channel, stride 3 between coefficients
__device__ __forceinline__ float eval_sh(int deg, const float* s, float x,
                                         float y, float z) {
  const float C0 = (float)0.28209479177387814;
  const float C1 = (float)0.4886025119029199;
  float r = C0 * s[0];
  if (deg > 0) {
    r = ((r - (C1 * y) * s[3]) + (C1 * z) * s[6]) - (C1 * x) * s[9];
    if (deg > 1) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      r = r + ((float)1.0925484305920792 * xy) * s[12];
      r = r + ((float)-1.0925484305920792 * yz) * s[15];
      r = r + ((float)0.31539156525252005 * ((2.0f * zz - xx) - yy)) *
                  s[18];
      r = r + ((float)-1.0925484305920792 * xz) * s[21];
      r = r + ((float)0.5462742152960396 * (xx - yy)) * s[24];
      if (deg > 2) {
        r = r + (((float)-0.5900435899266435 * y) * (3.0f * xx - yy)) *
                    s[27];
        r = r + (((float)2.890611442640554 * xy) * z) * s[30];
        r = r + (((float)-0.4570457994644658 * y) * ((4.0f * zz - xx) - yy)) *
                    s[33];
        r = r + (((float)0.3731763325901154 * z) *
                 ((2.0f * zz - 3.0f * xx) - 3.0f * yy)) *
                    s[36];
        r = r + (((float)-0.4570457994644658 * x) * ((4.0f * zz - xx) - yy)) *
                    s[39];
        r = r + (((float)1.445305721320277 * z) * (xx - yy)) * s[42];
        r = r + (((float)-0.5900435899266435 * x) * (xx - 3.0f * yy)) *
                    s[45];
      }
    }
  }
  return r;
}

struct Frame {
  int n, sh_degree, sh_k, grid_x, grid_y;
  // ndc2pix_rows' nonzero entries: [0,0], [0,3], [1,1], [1,3]
  float sx, ox, sy, oy;
};

__global__ void __launch_bounds__(THREADS) preprocess_kernel(
    const float* __restrict__ xyz, const float* __restrict__ scaling,
    const float* __restrict__ rotation, const float* __restrict__ opacity,
    const unsigned char* __restrict__ alive, const float* __restrict__ shs,
    const float* __restrict__ w2v, const float* __restrict__ full_proj,
    const float* __restrict__ campos, Frame fr, float* __restrict__ T_out,
    float* __restrict__ normal_out, float* __restrict__ depth_out,
    float* __restrict__ xy_out, float* __restrict__ radius_out,
    int* __restrict__ rect_min_out, int* __restrict__ rect_max_out,
    int* __restrict__ tiles_out, unsigned char* __restrict__ valid_out,
    float* __restrict__ color_out) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= fr.n) return;
  const float p[3] = {xyz[3 * (size_t)n], xyz[3 * (size_t)n + 1],
                      xyz[3 * (size_t)n + 2]};
  float W[3][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) W[j][k] = w2v[4 * j + k];

  float pv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) pv[j] = rows3(p, W[j]) + W[j][3];
  const bool in_frustum = pv[2] > (float)0.2;

  // quat_to_rotmat
  const float* q = rotation + 4 * (size_t)n;
  const float r = rsqrtf(((q[0] * q[0] + q[2] * q[2]) +
                          (q[1] * q[1] + q[3] * q[3])) +
                         (float)1e-12);
  const float w = q[0] * r, x = q[1] * r, y = q[2] * r, z = q[3] * r;
  const float R[3][3] = {
      {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - w * z),
       2.0f * (x * z + w * y)},
      {2.0f * (x * y + w * z), 1.0f - 2.0f * (x * x + z * z),
       2.0f * (y * z - w * x)},
      {2.0f * (x * z - w * y), 2.0f * (y * z + w * x),
       1.0f - 2.0f * (x * x + y * y)}};
  const float su = scaling[2 * (size_t)n], sv = scaling[2 * (size_t)n + 1];
  const float axis_u[3] = {R[0][0] * su, R[1][0] * su, R[2][0] * su};
  const float axis_v[3] = {R[0][1] * sv, R[1][1] * sv, R[2][1] * sv};
  const float normal_world[3] = {R[0][2], R[1][2], R[2][2]};

  // ndc2pix @ full_proj, then T's rows (Tu_col[j], Tv_col[j], Tc_col[j])
  const float N[3][4] = {{fr.sx, 0.0f, 0.0f, fr.ox},
                         {0.0f, fr.sy, 0.0f, fr.oy},
                         {0.0f, 0.0f, 0.0f, 1.0f}};
  float T[9];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float nf[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = N[j][0] * full_proj[c];
#pragma unroll
      for (int k = 1; k < 4; ++k) acc = fmad(N[j][k], full_proj[4 * k + c], acc);
      nf[c] = acc;
    }
    T[3 * j] = rows3(axis_u, nf);
    T[3 * j + 1] = rows3(axis_v, nf);
    T[3 * j + 2] = rows3(p, nf) + nf[3];
  }

  float nv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) nv[j] = rows3(normal_world, W[j]);
  const float cosv = -((pv[0] * nv[0] + pv[1] * nv[1]) + pv[2] * nv[2]);
  const float mult = cosv > 0.0f ? 1.0f : -1.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) nv[j] = nv[j] * mult;

  // the 3σ AABB and low-pass centre
  const float* Tw = T + 6;
  const float d_scale = ((9.0f * Tw[0]) * Tw[0] + (9.0f * Tw[1]) * Tw[1]) +
                        (1.0f * Tw[2]) * Tw[2];
  const Box b9 = conic_box(9.0f, T, d_scale);
  float ext_x = sqrtf(tclamp(b9.h0x, (float)1e-4, (float)1e14));
  float ext_y = sqrtf(tclamp(b9.h0y, (float)1e-4, (float)1e14));
  const bool finite = isfinite(b9.cx) && isfinite(b9.cy) &&
                      isfinite(ext_x) && isfinite(ext_y);
  const float cx = finite ? b9.cx : 0.0f;
  const float cy = finite ? b9.cy : 0.0f;
  ext_x = finite ? ext_x : 0.0f;
  ext_y = finite ? ext_y : 0.0f;
  const float floor_r = (float)(3.0 * 0.707106);  // CUTOFF * FILTER_SIZE
  float radius = ceilf(tclamp_min(tmax(ext_x, ext_y), floor_r));

  // the tight per-axis tile rect of the 3σ ellipse
  const float rx = ceilf(tclamp_min(ext_x, floor_r));
  const float ry = ceilf(tclamp_min(ext_y, floor_r));
  const float tile = (float)TILE;
  const float gx = (float)fr.grid_x, gy = (float)fr.grid_y;
  const float rmin_x = tclamp(floorf((cx - rx) / tile), 0.0f, gx);
  const float rmin_y = tclamp(floorf((cy - ry) / tile), 0.0f, gy);
  const float rmax_x =
      tclamp(floorf((((cx + rx) + tile) - 1.0f) / tile), 0.0f, gx);
  const float rmax_y =
      tclamp(floorf((((cy + ry) + tile) - 1.0f) / tile), 0.0f, gy);

  // the opacity-aware rect: the thr-level conic box ∪ the thr-level disk
  const float opa = tclamp(opacity[n], (float)1e-12, 1.0f);
  const float thr = tclamp(2.0f * logf(255.0f * opa), (float)0.72, 9.0f);
  const Box bt = conic_box(thr, T, d_scale);
  const float ext_tx = sqrtf(tclamp(bt.h0x, (float)1e-4, (float)1e14));
  const float ext_ty = sqrtf(tclamp(bt.h0y, (float)1e-4, (float)1e14));
  const bool ok_t = bt.ok && isfinite(bt.cx) && isfinite(bt.cy) &&
                    isfinite(ext_tx) && isfinite(ext_ty) && thr < (float)8.99;
  const float r2d = sqrtf(thr / 2.0f);
  const float lo_x = tmin(bt.cx - ext_tx, cx - r2d) - 0.5f;
  const float hi_x = tmax(bt.cx + ext_tx, cx + r2d) + 0.5f;
  const float lo_y = tmin(bt.cy - ext_ty, cy - r2d) - 0.5f;
  const float hi_y = tmax(bt.cy + ext_ty, cy + r2d) + 0.5f;
  const float cmin_x = tmax(rmin_x, tclamp(floorf(lo_x / tile), 0.0f, gx));
  const float cmin_y = tmax(rmin_y, tclamp(floorf(lo_y / tile), 0.0f, gy));
  const float cmax_x =
      tmin(rmax_x, tclamp(floorf(hi_x / tile) + 1.0f, 0.0f, gx));
  const float cmax_y =
      tmin(rmax_y, tclamp(floorf(hi_y / tile) + 1.0f, 0.0f, gy));
  const int bmin_x = (int)(ok_t ? cmin_x : rmin_x);
  const int bmin_y = (int)(ok_t ? cmin_y : rmin_y);
  const int bmax_x = (int)(ok_t ? tmax(cmax_x, cmin_x) : rmax_x);
  const int bmax_y = (int)(ok_t ? tmax(cmax_y, cmin_y) : rmax_y);
  const int tiles = (bmax_x - bmin_x) * (bmax_y - bmin_y);
  // visibility keeps the opacity-blind 3σ box's tile count
  const float tiles9 = (rmax_x - rmin_x) * (rmax_y - rmin_y);

  bool valid = in_frustum && b9.ok && finite && tiles9 > 0.0f;
  if (alive != nullptr) valid = valid && alive[n] != 0;

#pragma unroll
  for (int i = 0; i < 9; ++i) T_out[9 * (size_t)n + i] = T[i];
#pragma unroll
  for (int j = 0; j < 3; ++j) normal_out[3 * (size_t)n + j] = nv[j];
  depth_out[n] = pv[2];
  xy_out[2 * (size_t)n] = cx;
  xy_out[2 * (size_t)n + 1] = cy;
  radius_out[n] = valid ? radius : 0.0f;
  rect_min_out[2 * (size_t)n] = bmin_x;
  rect_min_out[2 * (size_t)n + 1] = bmin_y;
  rect_max_out[2 * (size_t)n] = bmax_x;
  rect_max_out[2 * (size_t)n + 1] = bmax_y;
  tiles_out[n] = valid ? tiles : 0;
  valid_out[n] = valid ? 1 : 0;

  if (fr.sh_degree < 0) return;  // the colour was given
  // ops/sh.py::sh_to_color
  const float d0 = p[0] - campos[0], d1 = p[1] - campos[1],
              d2 = p[2] - campos[2];
  const float len = tclamp_min(sqrtf((d0 * d0 + d2 * d2) + d1 * d1),
                               (float)1e-12);
  const float dx = d0 / len, dy = d1 / len, dz = d2 / len;
  const float* s = shs + (size_t)n * fr.sh_k * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    color_out[3 * (size_t)n + ch] =
        tclamp_min(eval_sh(fr.sh_degree, s + ch, dx, dy, dz) + 0.5f, 0.0f);
}

}  // namespace

// n gaussians: xyz [n,3], scaling [n,2], rotation [n,4] (w,x,y,z),
// opacity [n], alive [n] bytes or null, shs [n,sh_k,3] (null when
// sh_degree < 0: the colour was given and none is written); w2v and
// full_proj [4,4] row-major and campos [3] on the device; (sx, ox, sy, oy)
// the NDC→pixel rows' entries. Writes T [n,3,3], normal [n,3], depth [n],
// xy [n,2], radius [n], rect_min / rect_max [n,2] int32, tiles [n] int32,
// valid [n] bytes and color [n,3]. Returns the launch's cudaError.
extern "C" int preprocess_launch(
    const float* xyz, const float* scaling, const float* rotation,
    const float* opacity, const unsigned char* alive, const float* shs,
    const float* w2v, const float* full_proj, const float* campos, int n,
    int sh_degree, int sh_k, int grid_x, int grid_y, float sx, float ox,
    float sy, float oy, float* T, float* normal, float* depth, float* xy,
    float* radius, int* rect_min, int* rect_max, int* tiles,
    unsigned char* valid, float* color, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (sh_degree > 3 || (sh_degree >= 0 && (shs == nullptr || color == nullptr ||
                                            sh_k < (sh_degree + 1) * (sh_degree + 1))))
    return (int)cudaErrorInvalidValue;
  const Frame fr{n, sh_degree, sh_k, grid_x, grid_y, sx, ox, sy, oy};
  preprocess_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      xyz, scaling, rotation, opacity, alive, shs, w2v, full_proj, campos, fr,
      T, normal, depth, xy, radius, rect_min, rect_max, tiles, valid, color);
  return (int)cudaGetLastError();
}
