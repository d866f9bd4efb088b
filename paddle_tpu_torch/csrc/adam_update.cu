// adam_update: the Adam / AdamW update of a list of tensors in one pass.
//
// The port's own kernel; it has no TPU counterpart. The JAX package's
// Adam rule (paddle_tpu/optimizer/optimizer.py, Adam._update and the
// decay in _apply_flat) is traced into the jitted train step, where XLA
// fuses each parameter's update into one loop, and FLAGS_fuse_optimizer
// makes one loop a dtype group. The eager port had one PyTorch op per
// arithmetic step instead (17 launches a parameter, each a pass over
// memory); this kernel is one pass over a whole list.
//
// Semantics: for every element of every tensor of the list, with p the
// parameter, g its gradient and m, v the two moments:
//
//   L2 (decay 1):   g = g + wd * p                         (param dtype)
//   m = m * b1 + g * (1 - b1)
//   v = v * b2 + (g * (1 - b2)) * g
//   u = ((m * (1 / bc1)) * lr) / (sqrt(v * (1 / bc2)) + eps)
//   p' = p - u                          (slot dtype, then param dtype)
//   AdamW (decay 2): p' = p' - p * (lr * wd)   (the old p, param dtype)
//
// It gives the bits of the eager chain it replaces (the plain version,
// ops/kernels/optimizer_update.py adam_update_reference) on the card:
// every step is one IEEE f32 operation rounded to nearest
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, so nvcc
// contracts no a*b+c into an FMA), followed by a rounding to the dtype
// the eager op writes (bf16 slots round after every op, as each eager op
// writes a bf16 tensor). PyTorch's CUDA `tensor / python_scalar`
// multiplies by the f32 reciprocal, so the divisions by the bias
// corrections are products with 1/bc, which the wrapper computes on the
// host in f32 as PyTorch does.
//
// Storage: (param, slots) in {(f32, f32), (bf16, bf16), (bf16, f32)};
// the gradient has the parameter's dtype.
//
// What bounds it on the H100: bytes. Each element reads p, g, m, v once
// and writes p, m, v once (28 bytes in f32, 14 in bf16, 22 for bf16
// parameters with f32 slots), for about 20 flops.
//
// Design: the tensor table (pointers and lengths of up to kMaxTensors
// tensors) is a kernel argument (__grid_constant__, read in place), so a
// list of fresh gradient tensors needs no upload and no host sync. Each
// tensor takes ceil(n / kBlockElems) consecutive blocks; a block finds
// its tensor by a binary search of the table's block offsets. A thread
// updates 8 consecutive elements with 16-byte loads and stores where the
// tensor's four pointers are 16-byte aligned and the 8 elements are
// inside it, element by element otherwise (the ragged end).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kBlockElems = kThreads * kPerThread;
constexpr int kMaxTensors = 512;

struct Table {
  void* p[kMaxTensors];
  const void* g[kMaxTensors];
  void* m[kMaxTensors];
  void* v[kMaxTensors];
  long long n[kMaxTensors];
  int block_start[kMaxTensors + 1];
  int count;
};

struct Scalars {
  float lr, b1, c1, b2, c2, inv_bc1, inv_bc2, eps, wd, lr_wd;
  int decay;  // 0 none, 1 L2 into the gradient, 2 decoupled
};

// a float rounded to T's precision (the dtype an eager op writes)
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// one element: p, g in the parameter's dtype (PT), m, v in the slots'
// (ST), all held as floats
template <typename PT, typename ST>
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Scalars& s) {
  const float p_old = p;
  if (s.decay == 1) g = rnd<PT>(__fadd_rn(g, rnd<PT>(__fmul_rn(p, s.wd))));
  m = rnd<ST>(__fadd_rn(rnd<ST>(__fmul_rn(m, s.b1)),
                        rnd<ST>(__fmul_rn(g, s.c1))));
  const float g2 = rnd<ST>(__fmul_rn(rnd<ST>(__fmul_rn(g, s.c2)), g));
  v = rnd<ST>(__fadd_rn(rnd<ST>(__fmul_rn(v, s.b2)), g2));
  const float a = rnd<ST>(__fmul_rn(rnd<ST>(__fmul_rn(m, s.inv_bc1)), s.lr));
  float d = rnd<ST>(__fsqrt_rn(rnd<ST>(__fmul_rn(v, s.inv_bc2))));
  d = rnd<ST>(__fadd_rn(d, s.eps));
  float np_ = rnd<PT>(rnd<ST>(__fsub_rn(p, rnd<ST>(__fdiv_rn(a, d)))));
  if (s.decay == 2)
    np_ = rnd<PT>(__fsub_rn(np_, rnd<PT>(__fmul_rn(p_old, s.lr_wd))));
  p = np_;
}

// 8 values of T at a 16-byte aligned address <-> floats
__device__ __forceinline__ void load8(const float* src, float* x) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* x) {
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* dst, const float* x) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* x) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __halves2bfloat162(__float2bfloat16_rn(x[2 * i]),
                              __float2bfloat16_rn(x[2 * i + 1]));
  *reinterpret_cast<uint4*>(dst) = a;
}

template <typename PT, typename ST>
__global__ void __launch_bounds__(kThreads)
    adam_update_kernel(const __grid_constant__ Table t, const Scalars s) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.count - 1;  // last tensor whose first block <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.block_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const long long n = t.n[lo];
  const long long base =
      static_cast<long long>(b - t.block_start[lo]) * kBlockElems +
      static_cast<long long>(threadIdx.x) * kPerThread;
  if (base >= n) return;
  PT* p = static_cast<PT*>(t.p[lo]) + base;
  const PT* g = static_cast<const PT*>(t.g[lo]) + base;
  ST* m = static_cast<ST*>(t.m[lo]) + base;
  ST* v = static_cast<ST*>(t.v[lo]) + base;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(t.p[lo]) |
        reinterpret_cast<uintptr_t>(t.g[lo]) |
        reinterpret_cast<uintptr_t>(t.m[lo]) |
        reinterpret_cast<uintptr_t>(t.v[lo])) & 15) == 0;
  if (aligned && base + kPerThread <= n) {
    float xp[kPerThread], xg[kPerThread], xm[kPerThread], xv[kPerThread];
    load8(p, xp);
    load8(g, xg);
    load8(m, xm);
    load8(v, xv);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      update<PT, ST>(xp[i], xg[i], xm[i], xv[i], s);
    store8(p, xp);
    store8(m, xm);
    store8(v, xv);
    return;
  }
  const int count =
      n - base < kPerThread ? static_cast<int>(n - base) : kPerThread;
  for (int i = 0; i < count; ++i) {
    float xp = pt::to_f(p[i]), xm = pt::to_f(m[i]), xv = pt::to_f(v[i]);
    update<PT, ST>(xp, pt::to_f(g[i]), xm, xv, s);
    p[i] = pt::from_f<PT>(xp);
    m[i] = pt::from_f<ST>(xm);
    v[i] = pt::from_f<ST>(xv);
  }
}

template <typename PT, typename ST>
int launch(const Table& t, const Scalars& s, cudaStream_t st) {
  adam_update_kernel<PT, ST>
      <<<t.block_start[t.count], kThreads, 0, st>>>(t, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pt_adam_update_max_tensors() { return kMaxTensors; }

// table: n_tensors rows of 5 int64 (p, g, m, v pointers and the length)
// in host memory, read before the call returns; empty tensors are the
// caller's to drop. One launch.
extern "C" int pt_adam_update(const long long* table, int n_tensors,
                              int p_dtype, int s_dtype, float lr, float b1,
                              float c1, float b2, float c2, float inv_bc1,
                              float inv_bc2, float eps, float wd, float lr_wd,
                              int decay, void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors) return cudaErrorInvalidValue;
  Table t;
  t.count = n_tensors;
  long long blocks = 0;
  for (int i = 0; i < n_tensors; ++i) {
    const long long* row = table + 5 * i;
    t.p[i] = reinterpret_cast<void*>(row[0]);
    t.g[i] = reinterpret_cast<const void*>(row[1]);
    t.m[i] = reinterpret_cast<void*>(row[2]);
    t.v[i] = reinterpret_cast<void*>(row[3]);
    t.n[i] = row[4];
    if (row[4] <= 0) return cudaErrorInvalidValue;
    t.block_start[i] = static_cast<int>(blocks);
    blocks += (row[4] + kBlockElems - 1) / kBlockElems;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  }
  t.block_start[n_tensors] = static_cast<int>(blocks);
  const Scalars s{lr, b1, c1, b2, c2, inv_bc1, inv_bc2, eps, wd, lr_wd, decay};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_dtype == pt::kF32 && s_dtype == pt::kF32)
    return launch<float, float>(t, s, st);
  if (p_dtype == pt::kBF16 && s_dtype == pt::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(t, s, st);
  if (p_dtype == pt::kBF16 && s_dtype == pt::kF32)
    return launch<__nv_bfloat16, float>(t, s, st);
  return cudaErrorInvalidValue;
}
