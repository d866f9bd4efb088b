// attention_fwd: causal or non-causal softmax attention forward with an
// online softmax, on the tensor cores. Reads q/k/v through strides in
// the [B, S, H, D] layout (unit head-dim stride), writes out
// [B, Sq, H, D] in q's dtype and, when asked, the row logsumexp
// [B, Sq, H] in f32, which the backward kernels read unchanged.
//
// Replaces three TPU kernels: flash_attention._fwd_kernel (streaming,
// paddle_tpu/ops/pallas/flash_attention.py:57-113),
// flash_attention._fwd_single_block_kernel (nk == 1, :116-143) and
// folded_attention._fwd_kernel (paddle_tpu/ops/pallas/
// folded_attention.py:64-82). On the TPU they were three kernels for
// reasons of the TPU alone (Mosaic's 128-lane tiling forced the
// transposes the folded kernel avoided; the single-block kernel dropped
// the online-softmax scratch). A CUDA kernel takes strides, so one
// kernel reads the projection's layout directly. The causal mask is
// diagonal-aligned (key j is visible to query i when j <= i); masked
// scores are -1e30 and the denominator is clamped at 1e-30, as on the
// TPU.
//
// What bounds it on the H100: operations, 4*Sq*Sk*D flops per (batch,
// head) (about half when causal) against 3*S*D inputs.
// - fp32 inputs run 3xTF32 on the tensor cores: each operand x is split
//   into hi = tf32(x) (round to nearest, ties away, as cvt.rna) and
//   lo = x - hi (read by the tensor core truncated to TF32, mma.cuh),
//   and each product is lo*hi + hi*lo + hi*hi accumulated in f32. That
//   keeps fp32 accuracy (single-pass TF32 keeps about 3 digits) at three
//   TF32 products: the bound is 3 * flops / 495 TFLOP/s.
// - bf16 inputs run bf16 products with f32 accumulation. P is split into
//   two bf16 terms (hi + lo) before P.V, so the probabilities keep f32
//   accuracy and only the bf16 inputs and output round: the bound is
//   flops / 989 TFLOP/s (the split P.V is extra work on top of it).
//
// Design:
// - Products: mma.sync (m16n8k8 TF32 for fp32, m16n8k16 bf16). The
//   block's 8 warps form 4 row groups of 16 query rows; the two warps of
//   a group take the two halves of every K tile. wgmma would need V
//   transposed in shared memory for the TF32 P.V (wgmma takes a TF32 B
//   operand only K-major) and a warpgroup-wide S tile; mma.sync keeps S
//   in each warp's registers, where the softmax runs, and its C fragment
//   becomes the A fragment of P.V without a trip through shared memory.
//   For TF32 the two layouts differ (C holds columns 2t, 2t+1, A wants
//   t, t+4), so the contraction index is permuted instead: logical k = t
//   reads key row 2t of the V tile and k = t + 4 reads row 2t + 1.
// - Softmax in registers: each thread holds two rows' scores; the row
//   max and sum reduce over the 4 lanes of a quad with xor shuffles
//   (the same bits in every lane), and the running max and sum stay in
//   registers. Half tiles wholly masked for a warp are skipped by that
//   warp. At the end the second warp of each row group hands its max,
//   sum and output through shared memory to the first, which merges the
//   two halves (in that order) and writes the rows.
// - Why two warps per row: a warp's 16 rows walk every K tile in turn,
//   and one warp alone cannot keep its tensor core busy (each product
//   waits on loads and TF32 splits), so that walk sets the time of the
//   longest Q tile. Halving it cut short sequences by about a fifth
//   (S=512: 64 Q tiles for 132 SMs) and left S=2048 as it was.
// - Staging: Q once, then K and V tiles double buffered with 16-byte
//   cp.async copies (zero-filled past Sk); rows padded by 16 bytes, so
//   every fragment load below is conflict-free. One barrier per K tile:
//   it publishes tile i and frees the buffer that tile i + 1 then loads
//   into while tile i computes.
// - Tiles: BQ = 64 rows, BK = 64 keys (32 for fp32 at D = 256): one
//   block of 8 warps per SM (registers: 120-255 a thread), 87-200 KB of
//   shared memory.
// - Causal tail: blocks are numbered so that the longest Q tiles (the
//   last rows of the sequence) start first, over all heads and batches;
//   K tiles wholly above the diagonal are never loaded.
// - No atomics: every sum runs in a fixed order, so the same inputs give
//   the same bits on every launch.
// The copies, splits and products are in mma.cuh, shared with the
// single-pass backward (attention_bwd.cu).
// Left for later: wgmma with TMA-fed tiles (and TMA multicast across a
// cluster), warp specialisation (a producer warp, consumer warpgroups),
// pre-splitting K and V once per tile instead of once per warp,
// ldmatrix for the bf16 V fragments, and FP8.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace pt;

constexpr int kRowGroups = 4;             // warps along the Q tile
constexpr int kWarps = 2 * kRowGroups;    // each row group: two K halves
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kRowGroups;

template <typename T, int D>
struct Tile {
  // keys per K tile (fp32 D = 256 at 64 would not fit 227 KB)
  static constexpr int kBK = (D == 256 && sizeof(T) == 4) ? 32 : 64;
  // shared-memory row: D elements padded by 16 bytes
  static constexpr int kLD = D + 16 / static_cast<int>(sizeof(T));
  static constexpr size_t kSmem =
      static_cast<size_t>(kBQ + 4 * kBK) * kLD * sizeof(T);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         float* __restrict__ lse, int Sq, int Sk, int H,
                         long long qsb, long long qss, long long qsh,
                         long long ksb, long long kss, long long ksh,
                         long long vsb, long long vss, long long vsh,
                         int causal, float scale, int write_lse) {
  constexpr int kBK = Tile<T, D>::kBK;
  constexpr int kHK = kBK / 2;  // keys of a tile each warp takes
  constexpr int kLD = Tile<T, D>::kLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kBQ][kLD]
  T* Ks = Qs + kBQ * kLD;                  // [2][kBK][kLD]
  T* Vs = Ks + 2 * kBK * kLD;              // [2][kBK][kLD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % kRowGroups;  // this warp's 16 query rows
  const int kh = warp / kRowGroups;  // and its half of every K tile
  const int h = blockIdx.x, b = blockIdx.y;
  // causal: the longest Q tiles first
  const int qt = causal ? static_cast<int>(gridDim.z - 1 - blockIdx.z)
                        : static_cast<int>(blockIdx.z);
  const int q0 = qt * kBQ;
  const int w0 = q0 + 16 * rg;  // this warp's first query row
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  // causal: K tiles wholly above this Q tile's last row are never loaded
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  load_rows<T, D, kBQ, kLD, kThreads>(Qs, qb, qss, q0, Sq, tid);
  if (n_tiles > 0) {
    load_rows<T, D, kBK, kLD, kThreads>(Ks, kb, kss, 0, Sk, tid);
    load_rows<T, D, kBK, kLD, kThreads>(Vs, vb, vss, 0, Sk, tid);
  }
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // rows w0 + g (index 0) and w0 + g + 8 (index 1), over this warp's keys
  float m[2] = {pt::kNegInf, pt::kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBK + kh * kHK, buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it is in; tile it-1's buffer is free
    if (it + 1 < n_tiles) {
      load_rows<T, D, kBK, kLD, kThreads>(Ks + (buf ^ 1) * kBK * kLD, kb,
                                          kss, (it + 1) * kBK, Sk, tid);
      load_rows<T, D, kBK, kLD, kThreads>(Vs + (buf ^ 1) * kBK * kLD, vb,
                                          vss, (it + 1) * kBK, Sk, tid);
    }
    cp_async_commit();
    // every key of this warp's half tile above every row of the warp, or
    // past Sk: nothing to add
    if ((causal && k0 > w0 + 15) || k0 >= Sk) continue;

    const int off = (buf * kBK + kh * kHK) * kLD;
    float s[kHK / 8][4];
#pragma unroll
    for (int j = 0; j < kHK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    scores<D, kHK, kLD>(s, Qs + 16 * rg * kLD, Ks + off, g, t);

    const bool masked = k0 + kHK > Sk || (causal && k0 + kHK - 1 > w0);
    float mx[2] = {pt::kNegInf, pt::kNegInf};
#pragma unroll
    for (int j = 0; j < kHK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = w0 + g + 8 * (e >> 1);
          if (col >= Sk || (causal && col > row)) x = pt::kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    // a row can have seen only masked keys so far (the second half of
    // the first tile, above the diagonal): its exponentials are taken
    // against 0, so they stay 0
    float alpha[2], sum[2] = {0.f, 0.f}, ref[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      ref[r] = m_new == pt::kNegInf ? 0.f : m_new;
      alpha[r] = expf(m[r] - ref[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kHK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - ref[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    pv<D, kHK, kLD>(o, s, Vs + off, g, t);
  }

  // the two halves of each row meet: the second warp's running max, sum
  // and output go through shared memory (the K/V buffers, now free) to
  // the first, which merges them and writes the row
  cp_async_wait_all();
  __syncthreads();
  constexpr int kM = D / 2 + 4;  // floats a thread hands over
  static_assert(kRowGroups * 32 * kM * sizeof(float) <=
                    4 * kBK * kLD * sizeof(T),
                "the merge does not fit the K/V buffers");
  float* mine = reinterpret_cast<float*>(Ks) + (rg * 32 + lane) * kM;
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float4*>(mine + 4 * n) =
          make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
    *reinterpret_cast<float4*>(mine + D / 2) =
        make_float4(m[0], m[1], l[0], l[1]);
  }
  __syncthreads();
  if (kh == 1) return;
  const float4 ml = *reinterpret_cast<const float4*>(mine + D / 2);
  const float m2[2] = {ml.x, ml.y}, l2[2] = {ml.z, ml.w};
  float a1[2], a2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mt = fmaxf(m[r], m2[r]);
    a1[r] = expf(m[r] - mt);
    a2[r] = expf(m2[r] - mt);
    l[r] = l[r] * a1[r] + l2[r] * a2[r];
    m[r] = mt;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float4 p = *reinterpret_cast<const float4*>(mine + 4 * n);
    o[n][0] = o[n][0] * a1[0] + p.x * a2[0];
    o[n][1] = o[n][1] * a1[0] + p.y * a2[0];
    o[n][2] = o[n][2] * a1[1] + p.z * a2[1];
    o[n][3] = o[n][3] * a1[1] + p.w * a2[1];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(orow + n * 8 + 2 * t, o[n][2 * r] / den, o[n][2 * r + 1] / den);
    if (write_lse && t == 0)
      lse[(static_cast<size_t>(b) * Sq + row) * H + h] = m[r] + logf(den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int Sq, int Sk, int H, const long long* st,
           int causal, float scale, int write_lse, cudaStream_t stream) {
  const size_t smem = Tile<T, D>::kSmem;
  auto kernel = attention_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
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
