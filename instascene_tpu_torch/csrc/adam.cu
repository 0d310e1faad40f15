// Adam over every trained field of a GaussianModel in one launch.
//
// The geometry step updates six fields (xyz, the two SH bands, scaling,
// rotation, opacity), the semantic step one (seg_feature); each element
// reads its parameter, gradient and two moments and writes the three new
// values. The plain version is models/optimizer.py::adam_plain, the eager
// chain the CPU keeps: about 15 elementwise kernels a field, each reading
// and writing whole fields (~136 bytes of traffic a float), plus four
// kernels and two host copies for the bias corrections. Replaces no TPU
// kernel: the JAX package leaves adam_step to XLA, which fuses it.
//
// Bits. Every output is the eager chain's: each element takes the chain's
// operations in its order, each rounded alone (the build passes
// --fmad=false; `/` and sqrtf are IEEE-rounded, as without fast math):
//   m' = b1·m + (1−b1)·g,  v' = b2·v + (1−b2)·(g·g),
//   p' = p − (alive ? lr·(m'/c1) / (sqrt(v'/c2) + eps) : 0),
// with dead rows' moments written as the chain writes them, non-finite
// values included, and a missing gradient read as zeros (the chain's
// zeros_like). The Python scalars arrive as float, rounded as PyTorch
// rounds a scalar operand. The bias corrections c = 1 − b^step are
// computed here as aten's pow(Tensor, Scalar) computes them on the card:
// a copy at step 1, b·b at 2, (b·b)·b at 3, powf above (PyTorch's
// pow_tensor_scalar_kernel); tests/test_torch_adam_kernel.py holds them
// against the eager chain for every step up to 30,000.
//
// What bounds it on the H100: the bytes. An element reads 16 bytes and
// writes 12 (the alive flags, one byte a row, are read once a row and
// stay in cache): 28 bytes a float, 4.8 GB at 2.96M gaussians x 58 floats,
// 1.43 ms at 3.35 TB/s; ~50 FP32 operations an element (three IEEE
// divisions and a square root among them), far under the card's rate.
// Design: one pass over each byte, nothing kept between elements. The
// fields are laid end to end over the grid, each owning a contiguous run
// of blocks in proportion to its work, so one launch covers all of them
// with no idle tail per field. A thread takes VPT groups of four floats
// with 128-bit loads and stores (streaming: each byte is touched once),
// and the n mod 4 floats after them, or a whole field whose pointers are
// not 16-byte aligned, one by one.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_FIELDS = 7;  // models/optimizer.py's TRAINABLE_FIELDS
constexpr int THREADS = 256;
constexpr int VPT = 2;         // work items a thread

struct Field {
  const float* p;
  const float* g;  // null: a zero gradient
  const float* m;
  const float* v;
  float* p_out;
  float* m_out;
  float* v_out;
  long long n;            // elements
  long long nvec;         // leading float4 groups (0 when not aligned)
  long long items;        // nvec groups, then n - 4 nvec single floats
  long long first_block;  // the field's first block in the grid
  int width;              // elements a row (alive has one flag a row)
  float lr;
};

struct Launch {
  Field f[MAX_FIELDS];
  const unsigned char* alive;
  int nfields;
  int step;
  float b1, omb1, b2, omb2, eps;  // b1, 1 - b1, b2, 1 - b2, eps
};

// torch.tensor(b) ** float(step) as aten computes it on the card.
__device__ __forceinline__ float bias_pow(float b, int step) {
  if (step == 1) return b;
  if (step == 2) return b * b;
  if (step == 3) return b * b * b;
  return powf(b, static_cast<float>(step));
}

__device__ __forceinline__ void update(float p, float g, float m, float v,
                                       bool alive, float lr, float c1,
                                       float c2, const Launch& L, float& po,
                                       float& mo, float& vo) {
  mo = L.b1 * m + L.omb1 * g;
  vo = L.b2 * v + L.omb2 * (g * g);
  const float upd = lr * (mo / c1) / (sqrtf(vo / c2) + L.eps);
  po = p - (alive ? upd : 0.0f);
}

// The row of element e: a 32-bit division where e fits.
__device__ __forceinline__ long long row_of(long long e, int width) {
  return e <= 0xffffffffLL
             ? static_cast<long long>(static_cast<unsigned>(e) /
                                      static_cast<unsigned>(width))
             : e / width;
}

__global__ void __launch_bounds__(THREADS)
    adam_kernel(const __grid_constant__ Launch L) {
  int fi = 0;
#pragma unroll
  for (int j = 1; j < MAX_FIELDS; ++j)
    if (j < L.nfields && static_cast<long long>(blockIdx.x) >= L.f[j].first_block)
      fi = j;
  const Field& F = L.f[fi];
  const float c1 = 1.0f - bias_pow(L.b1, L.step);
  const float c2 = 1.0f - bias_pow(L.b2, L.step);
  const long long base =
      (static_cast<long long>(blockIdx.x) - F.first_block) * (THREADS * VPT) +
      threadIdx.x;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const long long item = base + k * THREADS;
    if (item >= F.items) break;
    if (item < F.nvec) {
      const float4 p = __ldcs(reinterpret_cast<const float4*>(F.p) + item);
      const float4 g = F.g != nullptr
                           ? __ldcs(reinterpret_cast<const float4*>(F.g) + item)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4 m = __ldcs(reinterpret_cast<const float4*>(F.m) + item);
      const float4 v = __ldcs(reinterpret_cast<const float4*>(F.v) + item);
      long long row = row_of(4 * item, F.width);
      int col = static_cast<int>(4 * item - row * F.width);
      bool a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = __ldg(L.alive + row) != 0;
        if (++col == F.width) {
          col = 0;
          ++row;
        }
      }
      float4 po, mo, vo;
      update(p.x, g.x, m.x, v.x, a[0], F.lr, c1, c2, L, po.x, mo.x, vo.x);
      update(p.y, g.y, m.y, v.y, a[1], F.lr, c1, c2, L, po.y, mo.y, vo.y);
      update(p.z, g.z, m.z, v.z, a[2], F.lr, c1, c2, L, po.z, mo.z, vo.z);
      update(p.w, g.w, m.w, v.w, a[3], F.lr, c1, c2, L, po.w, mo.w, vo.w);
      __stcs(reinterpret_cast<float4*>(F.p_out) + item, po);
      __stcs(reinterpret_cast<float4*>(F.m_out) + item, mo);
      __stcs(reinterpret_cast<float4*>(F.v_out) + item, vo);
    } else {
      const long long e = 4 * F.nvec + (item - F.nvec);
      const bool a = __ldg(L.alive + row_of(e, F.width)) != 0;
      const float g = F.g != nullptr ? __ldcs(F.g + e) : 0.0f;
      float po, mo, vo;
      update(__ldcs(F.p + e), g, __ldcs(F.m + e), __ldcs(F.v + e), a, F.lr, c1,
             c2, L, po, mo, vo);
      __stcs(F.p_out + e, po);
      __stcs(F.m_out + e, mo);
      __stcs(F.v_out + e, vo);
    }
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One Adam step over nfields fields (at most 7) in one launch. ptrs holds
// 7 device pointers a field: p, g (null: a zero gradient), m, v, and the
// new p, m, v (fresh buffers, none aliasing an input); n[j] is field j's
// element count, width[j] its elements a row of the alive flags [rows]
// (one byte each), lr[j] its learning rate. b1, 1 - b1, b2, 1 - b2 and eps
// as adam_step takes them, step its new count (>= 1). Returns the launch's
// cudaError; launches nothing when no field has an element.
extern "C" int adam_launch(int nfields, void* const* ptrs, const long long* n,
                           const int* width, const float* lr,
                           const unsigned char* alive, float b1, float omb1,
                           float b2, float omb2, float eps, int step,
                           void* stream) {
  if (nfields <= 0) return static_cast<int>(cudaSuccess);
  if (nfields > MAX_FIELDS || alive == nullptr || step < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch L{};
  L.alive = alive;
  L.nfields = nfields;
  L.step = step;
  L.b1 = b1;
  L.omb1 = omb1;
  L.b2 = b2;
  L.omb2 = omb2;
  L.eps = eps;
  long long blocks = 0;
  for (int j = 0; j < nfields; ++j) {
    Field& F = L.f[j];
    void* const* q = ptrs + 7 * j;
    F.p = static_cast<const float*>(q[0]);
    F.g = static_cast<const float*>(q[1]);
    F.m = static_cast<const float*>(q[2]);
    F.v = static_cast<const float*>(q[3]);
    F.p_out = static_cast<float*>(q[4]);
    F.m_out = static_cast<float*>(q[5]);
    F.v_out = static_cast<float*>(q[6]);
    if (F.p == nullptr || F.m == nullptr || F.v == nullptr ||
        F.p_out == nullptr || F.m_out == nullptr || F.v_out == nullptr ||
        n[j] < 0 || width[j] <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    F.n = n[j];
    F.width = width[j];
    F.lr = lr[j];
    bool vec = true;
    for (int k = 0; k < 7; ++k) vec = vec && aligned16(q[k]);
    F.nvec = vec ? F.n / 4 : 0;
    F.items = F.nvec + (F.n - 4 * F.nvec);
    F.first_block = blocks;
    blocks += (F.items + THREADS * VPT - 1) / (THREADS * VPT);
  }
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  adam_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(L);
  return static_cast<int>(cudaGetLastError());
}
