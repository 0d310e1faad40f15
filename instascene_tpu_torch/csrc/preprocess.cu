// Preprocess + SH in one pass, and its backward.
//
// The forward computes per gaussian the splat→pixel homography T, the view
// normal, depth, the low-pass centre, the radius, the opacity-aware tile
// rect, the visibility and the SH colour: every render takes it, the
// geometry steps' through ops/preprocess.py's autograd Function, the
// renders that build no graph (viewer frames, the tracker, the semantic
// step's frozen geometry, binning caches, mesh export) directly. The
// backward gives that Function the gradients of xyz, scaling, rotation and
// the SH coefficients from those of T, the normal, depth, the centre and
// the colour.
//
// Replaces no TPU kernel: the JAX package leaves preprocess to XLA, which
// fuses it into a few loops and differentiates them. The plain version is
// the eager chain of ops/preprocess.py::preprocess_plain and
// ops/sh.py::sh_to_color, about 456 launches a view, and autograd's
// backward through it, about 480 more; each kernel here is one launch, one
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
// The backward saves nothing from the forward: it recomputes the
// forward's geometry (splat() below, the same arithmetic, so its branches
// are the forward's) and follows autograd through it in float32, at every
// kink as autograd does: torch.clamp passes the gradient at its bounds,
// torch.where routes it to the branch taken, the normal's sign is a
// constant, the centre's clamp to ±1e7 and its finite select stop it, and
// the rect, radius and visibility (floors, ceils, comparisons) pass none.
// Its sums are in another order than autograd's, so its gradients differ
// from autograd's by float rounding; the tests hold them to 1e-5.
//
// What bounds them on the H100: the bytes. The forward reads 36 bytes of
// geometry, its opacity and alive flag and, at SH degree 3, 192 bytes of
// coefficients, and writes 97 bytes: ~330 bytes a gaussian, 99 MB at 300k
// gaussians, 0.03 ms at 3.35 TB/s. The backward reads the 36 bytes of
// geometry, the 192 of coefficients and 68 of incoming gradients (T 36,
// the normal 12, the centre 8, the colour 12) and writes 228 (the
// coefficients' 192): ~524 bytes a gaussian, 1.55 GB at 2.96M, 0.46 ms.
// The forward's arithmetic is ~400 FP32 and ~150 FP64 operations a
// gaussian, the backward's about twice that. The camera (w2v, full_proj,
// campos: 35 floats) is read from device memory by every thread, one
// cached broadcast, and ndc2pix @ full_proj (12 entries, 4 terms each) is
// recomputed per thread rather than staged: it costs less than a barrier.
// A thread's 48 coefficients and their 48 gradients would be 192-byte
// strided accesses across a warp; the backward stages the block's
// coefficients through shared memory instead, read and written as
// contiguous 16-byte vectors, and writes the gradients above the active
// degree as zeros. Each gaussian's gradients are its own: no atomics.

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
  float dd, f[3];      // the divisor (d where ok, else 1) and t / dd
  float cx_raw, cy_raw;  // the centre before its clamp
};

__device__ __forceinline__ Box conic_box(float t0, const float* T,
                                         float d_scale) {
  const float t[3] = {t0, t0, -1.0f};
  const float* Tw = T + 6;
  const float d = ((t[0] * Tw[0]) * Tw[0] + (t[1] * Tw[1]) * Tw[1]) +
                  (t[2] * Tw[2]) * Tw[2];
  Box b;
  b.ok = fabsf(d) > (float)1e-7 * d_scale && d_scale > 0.0f;
  b.dd = b.ok ? d : 1.0f;
  float* f = b.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) f[k] = t[k] / b.dd;
  const float* Tu = T;
  const float* Tv = T + 3;
  b.cx_raw = ((f[0] * Tu[0]) * Tw[0] + (f[1] * Tu[1]) * Tw[1]) +
             (f[2] * Tu[2]) * Tw[2];
  b.cy_raw = ((f[0] * Tv[0]) * Tw[0] + (f[1] * Tv[1]) * Tw[1]) +
             (f[2] * Tv[2]) * Tw[2];
  b.cx = tclamp(b.cx_raw, -1e7f, 1e7f);
  b.cy = tclamp(b.cy_raw, -1e7f, 1e7f);
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

// ops/sh.py::sh_to_color's unit direction from the camera
struct ViewDir {
  float d[3];    // p - campos
  float norm;    // |d|, torch.linalg.norm's order
  float len;     // clamp(norm, min=1e-12)
  float dir[3];  // d / len
};

__device__ __forceinline__ ViewDir view_dir(const float p[3],
                                            const float* campos) {
  ViewDir v;
#pragma unroll
  for (int k = 0; k < 3; ++k) v.d[k] = p[k] - campos[k];
  v.norm = sqrtf((v.d[0] * v.d[0] + v.d[2] * v.d[2]) + v.d[1] * v.d[1]);
  v.len = tclamp_min(v.norm, (float)1e-12);
#pragma unroll
  for (int k = 0; k < 3; ++k) v.dir[k] = v.d[k] / v.len;
  return v;
}

struct Frame {
  int n, sh_degree, sh_k, grid_x, grid_y;
  // ndc2pix_rows' nonzero entries: [0,0], [0,3], [1,1], [1,3]
  float sx, ox, sy, oy;
};

// One gaussian's geometry as ops/preprocess.py::preprocess_plain computes
// it up to the screen box: the view-space centre, the normalised
// quaternion, the rotation, ndc2pix @ full_proj, T and the signed view
// normal. Both kernels compute it alike, so the backward's branches (the
// normal's sign, the box's masks) are the forward's.
struct Splat {
  float W[3][4];   // w2v's first three rows
  float pv[3];     // view-space centre
  float r;         // quat_to_rotmat's rsqrt
  float q[4];      // (w, x, y, z) after it
  float R[3][3];
  float nf[3][4];  // ndc2pix @ full_proj
  float T[9];      // rows (Tu, Tv, Tw), T[3 * j + c]
  float nv[3];     // the view normal with its sign
  float mult;      // the sign
};

__device__ __forceinline__ void splat(const float p[3], const float* q,
                                      float su, float sv,
                                      const float* __restrict__ w2v,
                                      const float* __restrict__ full_proj,
                                      const Frame& fr, Splat& s) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) s.W[j][k] = w2v[4 * j + k];
#pragma unroll
  for (int j = 0; j < 3; ++j) s.pv[j] = rows3(p, s.W[j]) + s.W[j][3];

  // quat_to_rotmat
  s.r = rsqrtf(((q[0] * q[0] + q[2] * q[2]) + (q[1] * q[1] + q[3] * q[3])) +
               (float)1e-12);
  const float w = q[0] * s.r, x = q[1] * s.r, y = q[2] * s.r, z = q[3] * s.r;
  s.q[0] = w;
  s.q[1] = x;
  s.q[2] = y;
  s.q[3] = z;
  const float R[3][3] = {
      {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - w * z),
       2.0f * (x * z + w * y)},
      {2.0f * (x * y + w * z), 1.0f - 2.0f * (x * x + z * z),
       2.0f * (y * z - w * x)},
      {2.0f * (x * z - w * y), 2.0f * (y * z + w * x),
       1.0f - 2.0f * (x * x + y * y)}};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) s.R[i][k] = R[i][k];
  const float axis_u[3] = {R[0][0] * su, R[1][0] * su, R[2][0] * su};
  const float axis_v[3] = {R[0][1] * sv, R[1][1] * sv, R[2][1] * sv};
  const float normal_world[3] = {R[0][2], R[1][2], R[2][2]};

  // ndc2pix @ full_proj, then T's rows (Tu_col[j], Tv_col[j], Tc_col[j])
  const float N[3][4] = {{fr.sx, 0.0f, 0.0f, fr.ox},
                         {0.0f, fr.sy, 0.0f, fr.oy},
                         {0.0f, 0.0f, 0.0f, 1.0f}};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = N[j][0] * full_proj[c];
#pragma unroll
      for (int k = 1; k < 4; ++k) acc = fmad(N[j][k], full_proj[4 * k + c], acc);
      s.nf[j][c] = acc;
    }
    s.T[3 * j] = rows3(axis_u, s.nf[j]);
    s.T[3 * j + 1] = rows3(axis_v, s.nf[j]);
    s.T[3 * j + 2] = rows3(p, s.nf[j]) + s.nf[j][3];
  }

  float nv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) nv[j] = rows3(normal_world, s.W[j]);
  const float cosv =
      -((s.pv[0] * nv[0] + s.pv[1] * nv[1]) + s.pv[2] * nv[2]);
  s.mult = cosv > 0.0f ? 1.0f : -1.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) s.nv[j] = nv[j] * s.mult;
}

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
  Splat g;
  splat(p, rotation + 4 * (size_t)n, scaling[2 * (size_t)n],
        scaling[2 * (size_t)n + 1], w2v, full_proj, fr, g);
  const float* pv = g.pv;
  const float* T = g.T;
  const float* nv = g.nv;
  const bool in_frustum = pv[2] > (float)0.2;

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
  const ViewDir v = view_dir(p, campos);
  const float* s = shs + (size_t)n * fr.sh_k * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    color_out[3 * (size_t)n + ch] = tclamp_min(
        eval_sh(fr.sh_degree, s + ch, v.dir[0], v.dir[1], v.dir[2]) + 0.5f,
        0.0f);
}

// ---- the backward: autograd's gradients of preprocess_plain, recomputed

constexpr int BWD_THREADS = 128;
// a gaussian's SH coefficients in shared memory: up to 16 x 3 floats and
// one of padding, an odd stride, so the threads of a warp reading their
// own rows hit distinct banks
constexpr int SH_ROW = 49;

// d eval_sh / d sh[k] (ops/sh.py::eval_sh's factors, in its order) for the
// (deg + 1)^2 coefficients of degree deg
__device__ __forceinline__ void sh_basis(int deg, float x, float y, float z,
                                         float b[16]) {
  b[0] = (float)0.28209479177387814;
  if (deg < 1) return;
  const float C1 = (float)0.4886025119029199;
  b[1] = -(C1 * y);
  b[2] = C1 * z;
  b[3] = -(C1 * x);
  if (deg < 2) return;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  b[4] = (float)1.0925484305920792 * xy;
  b[5] = (float)-1.0925484305920792 * yz;
  b[6] = (float)0.31539156525252005 * ((2.0f * zz - xx) - yy);
  b[7] = (float)-1.0925484305920792 * xz;
  b[8] = (float)0.5462742152960396 * (xx - yy);
  if (deg < 3) return;
  b[9] = ((float)-0.5900435899266435 * y) * (3.0f * xx - yy);
  b[10] = ((float)2.890611442640554 * xy) * z;
  b[11] = ((float)-0.4570457994644658 * y) * ((4.0f * zz - xx) - yy);
  b[12] = ((float)0.3731763325901154 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
  b[13] = ((float)-0.4570457994644658 * x) * ((4.0f * zz - xx) - yy);
  b[14] = ((float)1.445305721320277 * z) * (xx - yy);
  b[15] = ((float)-0.5900435899266435 * x) * (xx - 3.0f * yy);
}

// d/d(x, y, z) of sum_k G[k] * basis_k(x, y, z), degree deg
__device__ __forceinline__ void sh_dir_grad(int deg, float x, float y,
                                            float z, const float G[16],
                                            float g[3]) {
  g[0] = g[1] = g[2] = 0.0f;
  if (deg < 1) return;
  const float C1 = (float)0.4886025119029199;
  g[0] -= C1 * G[3];
  g[1] -= C1 * G[1];
  g[2] += C1 * G[2];
  if (deg < 2) return;
  const float C20 = (float)1.0925484305920792, C21 = (float)-1.0925484305920792,
              C22 = (float)0.31539156525252005, C23 = (float)-1.0925484305920792,
              C24 = (float)0.5462742152960396;
  g[0] += C20 * y * G[4] - 2.0f * C22 * x * G[6] + C23 * z * G[7] +
          2.0f * C24 * x * G[8];
  g[1] += C20 * x * G[4] + C21 * z * G[5] - 2.0f * C22 * y * G[6] -
          2.0f * C24 * y * G[8];
  g[2] += C21 * y * G[5] + 4.0f * C22 * z * G[6] + C23 * x * G[7];
  if (deg < 3) return;
  const float C30 = (float)-0.5900435899266435, C31 = (float)2.890611442640554,
              C32 = (float)-0.4570457994644658, C33 = (float)0.3731763325901154,
              C34 = (float)-0.4570457994644658, C35 = (float)1.445305721320277,
              C36 = (float)-0.5900435899266435;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  g[0] += C30 * 6.0f * xy * G[9] + C31 * yz * G[10] -
          2.0f * C32 * xy * G[11] - 6.0f * C33 * xz * G[12] +
          C34 * (4.0f * zz - 3.0f * xx - yy) * G[13] +
          2.0f * C35 * xz * G[14] + 3.0f * C36 * (xx - yy) * G[15];
  g[1] += 3.0f * C30 * (xx - yy) * G[9] + C31 * xz * G[10] +
          C32 * (4.0f * zz - xx - 3.0f * yy) * G[11] -
          6.0f * C33 * yz * G[12] - 2.0f * C34 * xy * G[13] -
          2.0f * C35 * yz * G[14] - 6.0f * C36 * xy * G[15];
  g[2] += C31 * xy * G[10] + 8.0f * C32 * yz * G[11] +
          C33 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * G[12] +
          8.0f * C34 * xz * G[13] + C35 * (xx - yy) * G[14];
}

// The first `row` floats of `cnt` rows lying `stride` floats apart in device
// memory, into shared rows SH_ROW apart. Where the rows are the whole
// stride (every coefficient active) the block's span is one contiguous,
// 16-byte aligned range, read as float4.
__device__ __forceinline__ void stage_in(float* sm, const float* src,
                                         int cnt, int row, int stride) {
  const int total = cnt * row;
  int i0 = 0;
  if (row == stride && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int v = threadIdx.x; v < total / 4; v += BWD_THREADS) {
      const float4 x = s4[v];
      const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * v + j, r = i / row;
        sm[r * SH_ROW + i - r * row] = e[j];
      }
    }
    i0 = total & ~3;
  }
  for (int i = i0 + threadIdx.x; i < total; i += BWD_THREADS) {
    const int r = i / row;
    sm[r * SH_ROW + i - r * row] = src[(size_t)r * stride + i - r * row];
  }
}

// Whole rows of `stride` floats: the first `row` from the shared rows, the
// rest (coefficients above the active degree) zeros.
__device__ __forceinline__ void stage_out(float* dst, const float* sm,
                                          int cnt, int row, int stride) {
  const int total = cnt * stride;
  int i0 = 0;
  if (row == stride && (reinterpret_cast<size_t>(dst) & 15) == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int v = threadIdx.x; v < total / 4; v += BWD_THREADS) {
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * v + j, r = i / row;
        e[j] = sm[r * SH_ROW + i - r * row];
      }
      d4[v] = make_float4(e[0], e[1], e[2], e[3]);
    }
    i0 = total & ~3;
  }
  for (int i = i0 + threadIdx.x; i < total; i += BWD_THREADS) {
    const int r = i / stride, c = i - r * stride;
    dst[i] = c < row ? sm[r * SH_ROW + c] : 0.0f;
  }
}

__global__ void __launch_bounds__(BWD_THREADS) preprocess_bwd_kernel(
    const float* __restrict__ xyz, const float* __restrict__ scaling,
    const float* __restrict__ rotation, const float* __restrict__ shs,
    const float* __restrict__ w2v, const float* __restrict__ full_proj,
    const float* __restrict__ campos, Frame fr, const float* __restrict__ dT,
    const float* __restrict__ dnormal, const float* __restrict__ ddepth,
    const float* __restrict__ dxy, const float* __restrict__ dcolor,
    float* __restrict__ dxyz, float* __restrict__ dscaling,
    float* __restrict__ drotation, float* __restrict__ dshs) {
  __shared__ float sh[BWD_THREADS * SH_ROW];
  const int base = blockIdx.x * BWD_THREADS;
  const int cnt = min(BWD_THREADS, fr.n - base);
  const int deg = fr.sh_degree;
  const int row = deg >= 0 ? 3 * (deg + 1) * (deg + 1) : 0;
  const int stride = 3 * fr.sh_k;
  if (row > 0) {
    stage_in(sh, shs + (size_t)base * stride, cnt, row, stride);
    __syncthreads();
  }
  if (threadIdx.x < cnt) {
    const size_t n = (size_t)base + threadIdx.x;
    const float p[3] = {xyz[3 * n], xyz[3 * n + 1], xyz[3 * n + 2]};
    const float* q = rotation + 4 * n;
    const float su = scaling[2 * n], sv = scaling[2 * n + 1];
    Splat g;
    splat(p, q, su, sv, w2v, full_proj, fr, g);
    const float* T = g.T;
    float gT[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) gT[i] = dT != nullptr ? dT[9 * n + i] : 0.0f;

    // xy, the 3σ box's centre (_conic_box), where it is finite: its
    // clamp to ±1e7 passes the gradient on the interval, bounds included
    // (torch.clamp), and the divisor d only where it was taken (d_ok)
    if (dxy != nullptr) {
      const float* Tw = T + 6;
      const float d_scale = ((9.0f * Tw[0]) * Tw[0] + (9.0f * Tw[1]) * Tw[1]) +
                            (1.0f * Tw[2]) * Tw[2];
      const Box b = conic_box(9.0f, T, d_scale);
      const float ext_x = sqrtf(tclamp(b.h0x, (float)1e-4, (float)1e14));
      const float ext_y = sqrtf(tclamp(b.h0y, (float)1e-4, (float)1e14));
      if (isfinite(b.cx) && isfinite(b.cy) && isfinite(ext_x) &&
          isfinite(ext_y)) {
        const float gcx = b.cx_raw == b.cx ? dxy[2 * n] : 0.0f;
        const float gcy = b.cy_raw == b.cy ? dxy[2 * n + 1] : 0.0f;
        const float t[3] = {9.0f, 9.0f, -1.0f};
        float gfd = 0.0f;  // sum_k d(centre)/d(f_k) * f_k
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float a = gcx * Tw[k], c = gcy * Tw[k];
          gfd += (a * T[k] + c * T[3 + k]) * b.f[k];
          gT[k] += a * b.f[k];
          gT[3 + k] += c * b.f[k];
          gT[6 + k] += gcx * (b.f[k] * T[k]) + gcy * (b.f[k] * T[3 + k]);
        }
        if (b.ok) {  // f = t / d, d = sum_k t_k Tw_k^2
          const float gd = -gfd / b.dd;
#pragma unroll
          for (int k = 0; k < 3; ++k) gT[6 + k] += 2.0f * (gd * t[k]) * Tw[k];
        }
      }
    }

    // T = (axis_u · nf, axis_v · nf, p · nf + nf[3]) row by row
    float gu[3], gv[3], gp[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gu[k] = (gT[0] * g.nf[0][k] + gT[3] * g.nf[1][k]) + gT[6] * g.nf[2][k];
      gv[k] = (gT[1] * g.nf[0][k] + gT[4] * g.nf[1][k]) + gT[7] * g.nf[2][k];
      gp[k] = (gT[2] * g.nf[0][k] + gT[5] * g.nf[1][k]) + gT[8] * g.nf[2][k];
    }
    if (ddepth != nullptr) {
#pragma unroll
      for (int k = 0; k < 3; ++k) gp[k] += ddepth[n] * g.W[2][k];
    }
    // normal_view = (R[:, 2] · W[j]) · mult, the sign a constant
    float gnw[3] = {0.0f, 0.0f, 0.0f};
    if (dnormal != nullptr) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float gn = dnormal[3 * n + j] * g.mult;
#pragma unroll
        for (int k = 0; k < 3; ++k) gnw[k] += gn * g.W[j][k];
      }
    }

    // axis_u = R[:, 0] · su, axis_v = R[:, 1] · sv, normal = R[:, 2]
    const float (*R)[3] = g.R;
    float gR[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      gR[i][0] = gu[i] * su;
      gR[i][1] = gv[i] * sv;
      gR[i][2] = gnw[i];
    }
    dscaling[2 * n] = (gu[0] * R[0][0] + gu[1] * R[1][0]) + gu[2] * R[2][0];
    dscaling[2 * n + 1] =
        (gv[0] * R[0][1] + gv[1] * R[1][1]) + gv[2] * R[2][1];

    // quat_to_rotmat: R of the normalised (w, x, y, z), then
    // q · rsqrt(|q|^2 + 1e-12)
    const float w = g.q[0], x = g.q[1], y = g.q[2], z = g.q[3];
    const float gq[4] = {
        2.0f * ((((z * gR[1][0] - z * gR[0][1]) + (y * gR[0][2] - y * gR[2][0])) +
                 (x * gR[2][1] - x * gR[1][2]))),
        2.0f * (((y * (gR[0][1] + gR[1][0]) + z * (gR[0][2] + gR[2][0])) +
                 w * (gR[2][1] - gR[1][2]))) -
            4.0f * x * (gR[1][1] + gR[2][2]),
        2.0f * (((x * (gR[0][1] + gR[1][0]) + z * (gR[1][2] + gR[2][1])) +
                 w * (gR[0][2] - gR[2][0]))) -
            4.0f * y * (gR[0][0] + gR[2][2]),
        2.0f * (((x * (gR[0][2] + gR[2][0]) + y * (gR[1][2] + gR[2][1])) +
                 w * (gR[1][0] - gR[0][1]))) -
            4.0f * z * (gR[0][0] + gR[1][1])};
    const float dot =
        (gq[0] * q[0] + gq[1] * q[1]) + (gq[2] * q[2] + gq[3] * q[3]);
    const float gs = -0.5f * dot * (g.r * g.r * g.r);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      drotation[4 * n + k] = gq[k] * g.r + 2.0f * gs * q[k];

    // SH: colour = max(eval_sh(dir) + 0.5, 0), its clamp passing the
    // gradient at 0 itself; dir = (p - campos) / max(|p - campos|, 1e-12)
    if (row > 0) {
      const ViewDir v = view_dir(p, campos);
      float* srow = sh + threadIdx.x * SH_ROW;
      float gc[3] = {0.0f, 0.0f, 0.0f};
      if (dcolor != nullptr) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float col =
              eval_sh(deg, srow + c, v.dir[0], v.dir[1], v.dir[2]) + 0.5f;
          if (col >= 0.0f) gc[c] = dcolor[3 * n + c];
        }
      }
      float b[16], G[16];
      sh_basis(deg, v.dir[0], v.dir[1], v.dir[2], b);
      const int nc = row / 3;
#pragma unroll
      for (int k = 0; k < 16; ++k) {  // unrolled: b and G stay in registers
        if (k >= nc) break;
        G[k] = (gc[0] * srow[3 * k] + gc[1] * srow[3 * k + 1]) +
               gc[2] * srow[3 * k + 2];
#pragma unroll
        for (int c = 0; c < 3; ++c) srow[3 * k + c] = gc[c] * b[k];
      }
      float gdir[3];
      sh_dir_grad(deg, v.dir[0], v.dir[1], v.dir[2], G, gdir);
      const float glen = -((gdir[0] * v.dir[0] + gdir[1] * v.dir[1]) +
                           gdir[2] * v.dir[2]) / v.len;
#pragma unroll
      for (int k = 0; k < 3; ++k) gp[k] += gdir[k] / v.len;
      if (v.norm >= (float)1e-12) {
#pragma unroll
        for (int k = 0; k < 3; ++k) gp[k] += v.d[k] * (glen / v.norm);
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) dxyz[3 * n + k] = gp[k];
  }
  if (row > 0) {
    __syncthreads();
    stage_out(dshs + (size_t)base * stride, sh, cnt, row, stride);
  }
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

// The backward of preprocess_launch's differentiable outputs (T, normal,
// depth, xy, color) for the inputs xyz, scaling, rotation and shs: the
// forward's arguments as it took them (shs null when the colour was given,
// sh_degree then < 0), the incoming gradients dT [n,9], dnormal [n,3],
// ddepth [n], dxy [n,2] and dcolor [n,3] (each null where that output took
// none). Writes dxyz [n,3], dscaling [n,2], drotation [n,4] and, with SH,
// dshs [n,sh_k,3], zeros above the degree. Returns the launch's cudaError.
extern "C" int preprocess_bwd_launch(
    const float* xyz, const float* scaling, const float* rotation,
    const float* shs, const float* w2v, const float* full_proj,
    const float* campos, int n, int sh_degree, int sh_k, float sx, float ox,
    float sy, float oy, const float* dT, const float* dnormal,
    const float* ddepth, const float* dxy, const float* dcolor, float* dxyz,
    float* dscaling, float* drotation, float* dshs, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (sh_degree > 3 || (sh_degree >= 0 && (shs == nullptr || dshs == nullptr ||
                                            sh_k < (sh_degree + 1) * (sh_degree + 1))))
    return (int)cudaErrorInvalidValue;
  const Frame fr{n, sh_degree, sh_k, 0, 0, sx, ox, sy, oy};
  preprocess_bwd_kernel<<<(n + BWD_THREADS - 1) / BWD_THREADS, BWD_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      xyz, scaling, rotation, shs, w2v, full_proj, campos, fr, dT, dnormal,
      ddepth, dxy, dcolor, dxyz, dscaling, drotation, dshs);
  return (int)cudaGetLastError();
}
