// attention_bwd: the softmax-attention backward (FlashAttention-2
// formulas) in four entries, reading q/k/v/dO through strides in the
// [B, S, H, D] layout and writing dQ/dK/dV [B, S, H, D] in the storage
// type, with every sum in fp32.
//
// Replaces four TPU kernels of paddle_tpu/ops/pallas/:
//   mode 0  dQ pass           flash_attention._bwd_dq_kernel    (:146, #7)
//   mode 1  dK/dV pass        flash_attention._bwd_dkv_kernel   (:250, #8)
//   mode 2  fused, nq == 1    flash_attention._bwd_fused_kernel (:186, #6)
//   mode 3  folded            folded_attention._bwd_kernel      (:85, #10)
//
// With P = exp(S*scale - lse), dP = dO V^T and dS = P (dP - delta) scale:
// dV = P^T dO, dK = dS^T Q, dQ = dS K. Modes 0-2 take lse and delta =
// rowsum(dO*O) - g_lse from the caller (the JAX package computes delta
// outside Pallas too). Mode 3 receives no lse: like the TPU kernel it
// recomputes the softmax from q and k, in a first launch that walks the
// K tiles with an online max and writes lse and delta = rowsum(P^ dP)
// per row, before the fused pass.
//
// Blocks run in no order on the card, so where the TPU carried a dQ sum
// in scratch across its sequential grid, the fused modes (2, 3) let the
// block of each K tile write its dQ contribution to a per-tile fp32
// buffer, and a last launch sums the tiles in a fixed order. There are
// no float atomics: every output element is summed by one thread in one
// order, so two runs give the same bits. The scores and their exp are
// computed once per (q, k) pair in the fused modes, as on the TPU.
//
// What bounds it on the H100: operations. 6 (dQ), 8 (dK/dV) or 10
// (fused) flops per (q, k) pair and head-dim element against 4-5 rows of
// input per position; in fp32 there are no tensor cores, so the bound
// is the 67 TFLOP/s of plain FMA. This first version is a simple FMA
// kernel in the shape of attention_fwd.cu: 64-row tiles of q and k in
// shared memory (rows padded by one float against bank conflicts), 256
// threads each owning a 4x4 patch of a 64x64 score tile and a 4 x D/16
// patch of a 64 x D accumulator, tiles wholly above the causal diagonal
// skipped. Tensor cores (bf16 wgmma), TMA and a dQ sum that stays on
// chip are later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kT = 64;         // rows of a q tile and of a k tile
constexpr int kThreads = 256;  // 16 x 16

struct Strides {
  long long b, s, h;
};

// one [kT][D] tile of a strided [B, S, H, D] tensor (already offset to
// its (b, h)) into padded shared memory, zero past row S
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int s0,
                                          int S, long long ss, int tid) {
  for (int idx = tid; idx < kT * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int s = s0 + r;
    dst[r * (D + 1) + d] = s < S ? pt::to_f(src[s * ss + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ty*4 + i][d] * Bm[tx + 16j][d]
template <int D>
__device__ __forceinline__ void tile_dot(float acc[4][4], const float* A,
                                         const float* Bm, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// the score of (row ty*4+i, column tx+16j), masked to -1e30 past the
// sequences and above the diagonal (key j visible to query i when j <= i)
__device__ __forceinline__ float masked_score(float s, int qi, int kj,
                                              int Sq, int Sk, int causal) {
  if (qi >= Sq || kj >= Sk || (causal && kj > qi)) return pt::kNegInf;
  return s;
}

// the two reductions over the 16 threads (tx) that share a row (ty): they
// are one half of a warp, so xor shuffles below 16 stay inside it
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int D>
constexpr size_t smem_floats() {
  return 4 * kT * (D + 1) + kT * (kT + 1) + 2 * kT;
}

__device__ __forceinline__ size_t row_index(int b, int s, int h, int S,
                                            int H) {
  return (static_cast<size_t>(b) * S + s) * H + h;
}

// dQ pass (#7): one block per (q tile, h, b) walks the K tiles
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int Sq, int Sk, int H,
                            Strides qs, Strides ks, Strides vs, Strides ds,
                            int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kT][D + 1]
  float* dOs = Qs + kT * (D + 1);      // [kT][D + 1]
  float* Ks = dOs + kT * (D + 1);      // [kT][D + 1]
  float* Vs = Ks + kT * (D + 1);       // [kT][D + 1]
  float* Ps = Vs + kT * (D + 1);       // [kT][kT + 1] dS
  float* Ls = Ps + kT * (kT + 1);      // [kT] lse
  float* Dl = Ls + kT;                 // [kT] delta
  constexpr int kCols = D / 16;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* db = dout + b * ds.b + h * ds.h;

  load_tile<T, D>(Qs, qb, q0, Sq, qs.s, tid);
  load_tile<T, D>(dOs, db, q0, Sq, ds.s, tid);
  if (tid < kT) {
    const int s = q0 + tid;
    const bool in = s < Sq;
    Ls[tid] = in ? lse[row_index(b, s, h, Sq, H)] : 0.f;
    Dl[tid] = in ? delta[row_index(b, s, h, Sq, H)] : 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  const int k_end = causal ? min(Sk, q0 + kT) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kT) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are consumed
    load_tile<T, D>(Ks, kb, k0, Sk, ks.s, tid);
    load_tile<T, D>(Vs, vb, k0, Sk, vs.s, tid);
    __syncthreads();
    float sacc[4][4], dp[4][4];
    tile_dot<D>(sacc, Qs, Ks, ty, tx);
    tile_dot<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float s = masked_score(sacc[i][j] * scale, q0 + r, k0 + c, Sq,
                                     Sk, causal);
        const float p = expf(s - Ls[r]);
        Ps[r * (kT + 1) + c] = p * (dp[i][j] - Dl[r]) * scale;
      }
    }
    __syncthreads();
    // dQ += dS K: rows ty*4 + i, columns tx + 16j
    const int c_end = min(kT, Sk - k0);
    for (int c = 0; c < c_end; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ps[(ty * 4 + i) * (kT + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float kv = Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += dsv[i] * kv;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= Sq) continue;
    T* row = dq + row_index(b, s, h, Sq, H) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) row[tx + 16 * j] = pt::from_f<T>(acc[i][j]);
  }
}

// dK/dV pass (#8; with dq_part, the fused pass of #6 and #10): one block
// per (k tile, h, b) walks the Q tiles that see it. With dq_part it also
// writes this K tile's dQ contribution dS K for every Q tile to
// dq_part[k tile][b][s][h][:] (fp32), which dq_reduce_kernel sums.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv,
                             float* __restrict__ dq_part, int B, int Sq,
                             int Sk, int H, Strides qs, Strides ks,
                             Strides vs, Strides ds, int causal,
                             float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                    // [kT][D + 1]
  float* Vs = Ks + kT * (D + 1);       // [kT][D + 1]
  float* Qs = Vs + kT * (D + 1);       // [kT][D + 1]
  float* dOs = Qs + kT * (D + 1);      // [kT][D + 1]
  float* Ps = dOs + kT * (D + 1);      // [kT][kT + 1] P, then dS
  float* Ls = Ps + kT * (kT + 1);      // [kT] lse
  float* Dl = Ls + kT;                 // [kT] delta
  constexpr int kCols = D / 16;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kt = blockIdx.x, k0 = kt * kT, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* db = dout + b * ds.b + h * ds.h;

  load_tile<T, D>(Ks, kb, k0, Sk, ks.s, tid);
  load_tile<T, D>(Vs, vb, k0, Sk, vs.s, tid);
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: query rows below k0 see none of this K tile
  const int q_start = causal ? k0 : 0;
  const size_t part_stride = static_cast<size_t>(B) * Sq * H * D;
  for (int q0 = q_start; q0 < Sq; q0 += kT) {
    __syncthreads();  // the previous Q tile's Qs/dOs/Ps are consumed
    load_tile<T, D>(Qs, qb, q0, Sq, qs.s, tid);
    load_tile<T, D>(dOs, db, q0, Sq, ds.s, tid);
    if (tid < kT) {
      const int s = q0 + tid;
      const bool in = s < Sq;
      Ls[tid] = in ? lse[row_index(b, s, h, Sq, H)] : 0.f;
      Dl[tid] = in ? delta[row_index(b, s, h, Sq, H)] : 0.f;
    }
    __syncthreads();
    // P and dP: rows (queries) ty*4 + i, columns (keys) tx + 16j
    float p[4][4], dp[4][4];
    tile_dot<D>(p, Qs, Ks, ty, tx);
    tile_dot<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float s = masked_score(p[i][j] * scale, q0 + r, k0 + c, Sq, Sk,
                                     causal);
        p[i][j] = expf(s - Ls[r]);
        Ps[r * (kT + 1) + c] = p[i][j];
      }
    }
    __syncthreads();
    // dV += P^T dO: rows (keys) ty*4 + i, columns tx + 16j
    const int c_end = min(kT, Sq - q0);
    for (int c = 0; c < c_end; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[c * (kT + 1) + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float o = dOs[c * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv_acc[i][j] += pv[i] * o;
      }
    }
    __syncthreads();  // P is consumed; dS takes its place
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[r * (kT + 1) + tx + 16 * j] =
            p[i][j] * (dp[i][j] - Dl[r]) * scale;
    }
    __syncthreads();
    // dK += dS^T Q
    for (int c = 0; c < c_end; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ps[c * (kT + 1) + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float qv = Qs[c * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dk_acc[i][j] += dsv[i] * qv;
      }
    }
    if (dq_part != nullptr) {
      // this K tile's share of dQ for the Q tile: dS K, rows (queries)
      // ty*4 + i, columns tx + 16j
      float dqa[4][kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) dqa[i][j] = 0.f;
      const int ck_end = min(kT, Sk - k0);
      for (int c = 0; c < ck_end; ++c) {
        float dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = Ps[(ty * 4 + i) * (kT + 1) + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float kv = Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) dqa[i][j] += dsv[i] * kv;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = q0 + ty * 4 + i;
        if (s >= Sq) continue;
        float* row = dq_part + kt * part_stride + row_index(b, s, h, Sq, H) * D;
#pragma unroll
        for (int j = 0; j < kCols; ++j) row[tx + 16 * j] = dqa[i][j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty * 4 + i;
    if (s >= Sk) continue;
    T* rk = dk + row_index(b, s, h, Sk, H) * D;
    T* rv = dv + row_index(b, s, h, Sk, H) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      rk[tx + 16 * j] = pt::from_f<T>(dk_acc[i][j]);
      rv[tx + 16 * j] = pt::from_f<T>(dv_acc[i][j]);
    }
  }
}

// dQ of the fused modes: the K tiles' contributions summed in tile order.
// Causal: K tile t wrote rows of the Q tiles from t on, so row s sums the
// tiles 0 .. s / kT.
template <typename T>
__global__ void dq_reduce_kernel(const float* __restrict__ part,
                                 T* __restrict__ dq, int Sq, int H, int D,
                                 int n_kt, int causal, size_t n) {
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) +
                    threadIdx.x;
       idx < n; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int s = static_cast<int>((idx / (static_cast<size_t>(H) * D)) % Sq);
    const int t_end = causal ? min(n_kt, s / kT + 1) : n_kt;
    float acc = 0.f;
    for (int t = 0; t < t_end; ++t) acc += part[t * n + idx];
    dq[idx] = pt::from_f<T>(acc);
  }
}

// folded entry (#10), first launch: lse and delta = rowsum(P^ dP) of each
// row from q, k, v and dO alone, with an online max over the K tiles
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_stats_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ dout,
                               float* __restrict__ lse,
                               float* __restrict__ delta, int Sq, int Sk,
                               int H, Strides qs, Strides ks, Strides vs,
                               Strides ds, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kT][D + 1]
  float* dOs = Qs + kT * (D + 1);      // [kT][D + 1]
  float* Ks = dOs + kT * (D + 1);      // [kT][D + 1]
  float* Vs = Ks + kT * (D + 1);       // [kT][D + 1]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* db = dout + b * ds.b + h * ds.h;
  load_tile<T, D>(Qs, qb, q0, Sq, qs.s, tid);
  load_tile<T, D>(dOs, db, q0, Sq, ds.s, tid);

  // per row ty*4 + i, the same in all 16 threads of the row
  float m[4], l[4], a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = pt::kNegInf;
    l[i] = 0.f;
    a[i] = 0.f;
  }
  const int k_end = causal ? min(Sk, q0 + kT) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kT) {
    __syncthreads();
    load_tile<T, D>(Ks, kb, k0, Sk, ks.s, tid);
    load_tile<T, D>(Vs, vb, k0, Sk, vs.s, tid);
    __syncthreads();
    float sacc[4][4], dp[4][4];
    tile_dot<D>(sacc, Qs, Ks, ty, tx);
    tile_dot<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float tmax = pt::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sacc[i][j] = masked_score(sacc[i][j] * scale, qi, k0 + tx + 16 * j,
                                  Sq, Sk, causal);
        tmax = fmaxf(tmax, sacc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(tmax));
      float ps = 0.f, pd = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(sacc[i][j] - m_new);
        ps += e;
        pd += e * dp[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum16(ps);
      a[i] = a[i] * alpha + row_sum16(pd);
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = q0 + ty * 4 + i;
      if (s >= Sq) continue;
      const float den = fmaxf(l[i], 1e-30f);
      lse[row_index(b, s, h, Sq, H)] = m[i] + logf(den);
      delta[row_index(b, s, h, Sq, H)] = a[i] / den;
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  void *lse, *delta, *dq, *dk, *dv, *dq_part;
  int B, Sq, Sk, H;
  Strides qs, ks, vs, ds;
  int causal;
  float scale;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D>
int launch(const Args& a, int mode, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  float* lse = static_cast<float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  const dim3 qgrid((a.Sq + kT - 1) / kT, a.H, a.B);
  const dim3 kgrid((a.Sk + kT - 1) / kT, a.H, a.B);
  cudaError_t e;
  if (mode == 0) {
    auto kernel = attention_bwd_dq_kernel<T, D>;
    if ((e = allow_smem(kernel, smem)) != cudaSuccess) return e;
    kernel<<<qgrid, kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.dq), a.Sq, a.Sk, a.H,
        a.qs, a.ks, a.vs, a.ds, a.causal, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode == 3) {
    auto stats = attention_bwd_stats_kernel<T, D>;
    const size_t smem_stats = 4 * kT * (D + 1) * sizeof(float);
    if ((e = allow_smem(stats, smem_stats)) != cudaSuccess) return e;
    stats<<<qgrid, kThreads, smem_stats, stream>>>(
        q, k, v, dout, lse, delta, a.Sq, a.Sk, a.H, a.qs, a.ks, a.vs, a.ds,
        a.causal, a.scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  float* part = mode >= 2 ? static_cast<float*>(a.dq_part) : nullptr;
  auto dkv = attention_bwd_dkv_kernel<T, D>;
  if ((e = allow_smem(dkv, smem)) != cudaSuccess) return e;
  dkv<<<kgrid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), part, a.B, a.Sq, a.Sk, a.H, a.qs, a.ks, a.vs,
      a.ds, a.causal, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess || part == nullptr) return e;
  const size_t n = static_cast<size_t>(a.B) * a.Sq * a.H * D;
  const int n_kt = (a.Sk + kT - 1) / kT;
  const size_t want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  dq_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      part, static_cast<T*>(a.dq), a.Sq, a.H, D, n_kt, a.causal, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Args& a, int D, int mode, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(a, mode, stream);
    case 128:
      return launch<T, 128>(a, mode, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// mode: 0 dQ (#7), 1 dK/dV (#8), 2 fused with lse/delta given (#6),
// 3 folded: lse/delta are written by a first launch, then as mode 2
// (#10). dq_part: [ceil(Sk/64), B, Sq, H, D] f32 scratch for modes 2-3.
extern "C" int pt_attention_bwd(const void* q, const void* k, const void* v,
                                const void* dout, void* lse, void* delta,
                                void* dq, void* dk, void* dv, void* dq_part,
                                int B, int Sq, int Sk, int H, int D, int qsb,
                                int qss, int qsh, int ksb, int kss, int ksh,
                                int vsb, int vss, int vsh, int dsb, int dss,
                                int dsh, int causal, int dtype, float scale,
                                int mode, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0 || H == 0) return 0;
  if (mode < 0 || mode > 3) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,
               k,
               v,
               dout,
               lse,
               delta,
               dq,
               dk,
               dv,
               dq_part,
               B,
               Sq,
               Sk,
               H,
               {qsb, qss, qsh},
               {ksb, kss, ksh},
               {vsb, vss, vsh},
               {dsb, dss, dsh},
               causal,
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32) return dispatch_d<float>(a, D, mode, s);
  if (dtype == pt::kBF16) return dispatch_d<__nv_bfloat16>(a, D, mode, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
