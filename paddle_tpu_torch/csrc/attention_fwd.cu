// attention_fwd: causal or non-causal softmax attention forward with an
// online softmax, reading q/k/v through strides in the [B, S, H, D]
// layout, writing out [B, Sq, H, D] and, when asked, the row logsumexp
// [B, Sq, H] in f32.
//
// Replaces three TPU kernels: flash_attention._fwd_kernel (streaming,
// paddle_tpu/ops/pallas/flash_attention.py:57-113),
// flash_attention._fwd_single_block_kernel (nk == 1, :116-143) and
// folded_attention._fwd_kernel (paddle_tpu/ops/pallas/
// folded_attention.py:64-82). On the TPU they were three kernels for
// reasons of the TPU alone: the folded kernel existed to avoid the
// [B,S,H,D] -> [B,H,S,D] transposes that Mosaic's 128-lane tiling
// forced on the flash kernel, and the single-block kernel to drop the
// online-softmax scratch when one K block covers the sequence. A CUDA
// kernel takes strides, so it reads the projection's layout directly,
// and one online-softmax loop costs nothing extra with a single K
// tile. The causal mask is diagonal-aligned (key j is visible to query
// i when j <= i), as on the TPU.
//
// What bounds it on the H100: operations. 4*Sq*Sk*D flops per (batch,
// head) (half of that when causal) against 3*S*D inputs; in fp32 there
// are no tensor cores, so the bound is the 67 TFLOP/s of plain FMA.
// This first version is a simple FMA kernel: 64x64 tiles of q and k in
// shared memory (rows padded by one float against bank conflicts),
// each of the 256 threads computing a 4x4 patch of the score tile and
// a 4 x D/16 patch of the output, K tiles wholly above the diagonal
// skipped. Tensor cores (bf16 wgmma) and TMA are later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16

template <int D>
constexpr size_t smem_floats() {
  return 2 * kBQ * (D + 1) + kBK * D + kBQ * (kBK + 1) + 3 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         float* __restrict__ lse, int Sq, int Sk, int H,
                         long long qsb, long long qss, long long qsh,
                         long long ksb, long long kss, long long ksh,
                         long long vsb, long long vss, long long vsh,
                         int causal, float scale, int write_lse) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);      // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);      // [kBK][D]
  float* Ps = Vs + kBK * D;            // [kBQ][kBK + 1]
  float* Mrow = Ps + kBQ * (kBK + 1);  // [kBQ] running max
  float* Lrow = Mrow + kBQ;            // [kBQ] running sum
  float* Arow = Lrow + kBQ;            // [kBQ] this tile's rescale
  constexpr int kCols = D / 16;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int s = q0 + r;
    Qs[r * (D + 1) + d] = s < Sq ? pt::to_f(qb[s * qss + d]) : 0.f;
  }
  if (tid < kBQ) {
    Mrow[tid] = pt::kNegInf;
    Lrow[tid] = 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // causal: K tiles wholly above this Q tile's last row contribute
  // nothing and are never loaded
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // previous tile's Ks/Vs/Ps are consumed
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      const int s = k0 + c;
      const bool in = s < Sk;
      Ks[c * (D + 1) + d] = in ? pt::to_f(kb[s * kss + d]) : 0.f;
      Vs[c * D + d] = in ? pt::to_f(vb[s * vss + d]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4 + i, columns tx + 16*j
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kj = k0 + c;
        float s = sacc[i][j] * scale;
        if (kj >= Sk || (causal && kj > qi)) s = pt::kNegInf;
        Ps[r * (kBK + 1) + c] = s;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, lanes two columns
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      float* pr = Ps + r * (kBK + 1);
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_old = Mrow[r];
      const float m_new = fmaxf(m_old, pt::warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float psum = pt::warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Arow[r] = alpha;
        Lrow[r] = Lrow[r] * alpha + psum;
        Mrow[r] = m_new;
      }
    }
    __syncthreads();

    // output: rows ty*4 + i, columns tx + 16*j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = Arow[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= a;
    }
    const int c_end = min(kBK, Sk - k0);
    for (int c = 0; c < c_end; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, s = q0 + r;
    if (s >= Sq) continue;
    const float den = fmaxf(Lrow[r], 1e-30f);
    T* orow = out + ((static_cast<size_t>(b) * Sq + s) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      orow[tx + 16 * j] = pt::from_f<T>(acc[i][j] / den);
    if (write_lse && tx == 0)
      lse[(static_cast<size_t>(b) * Sq + s) * H + h] = Mrow[r] + logf(den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int Sq, int Sk, int H, const long long* st,
           int causal, float scale, int write_lse, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = attention_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Sk, H, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], causal, scale, write_lse);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int Sq, int Sk, int H, int D,
               const long long* st, int causal, float scale, int write_lse,
               cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, Sq, Sk, H, st, causal,
                           scale, write_lse, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, Sq, Sk, H, st, causal,
                            scale, write_lse, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, B, Sq, Sk, H, st, causal,
                            scale, write_lse, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int pt_attention_fwd(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int Sq, int Sk,
                                int H, int D, int qsb, int qss, int qsh,
                                int ksb, int kss, int ksh, int vsb, int vss,
                                int vsh, int causal, int dtype, float scale,
                                int write_lse, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32)
    return dispatch_d<float>(q, k, v, out, lse, B, Sq, Sk, H, D, st, causal,
                             scale, write_lse, s);
  if (dtype == pt::kBF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, H, D, st,
                                     causal, scale, write_lse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
