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
//   lo = tf32(x - hi),
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
// Left for later: wgmma with TMA-fed tiles (and TMA multicast across a
// cluster), warp specialisation (a producer warp, consumer warpgroups),
// pre-splitting K and V once per tile instead of once per warp,
// ldmatrix for the bf16 V fragments, and FP8.
#include <math.h>

#include "common.cuh"

namespace {

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

// -- copies -------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + R) of a [rows_total, D] operand with row stride rs
// (elements) into dst [R][kLD]; rows past rows_total are zeros
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long rs,
                                          int r0, int rows_total, int tid) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = D / kVec;
  constexpr int kLD = Tile<T, D>::kLD;
  static_assert((R * kPerRow) % kThreads == 0, "tile not a thread multiple");
#pragma unroll
  for (int it = 0; it < R * kPerRow / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kPerRow, c = (i - r * kPerRow) * kVec;
    const int s = r0 + r;
    const bool ok = s < rows_total;
    cp_async16(dst + r * kLD + c,
               src + (ok ? static_cast<long long>(s) * rs : 0LL) + c, ok);
  }
}

// -- tensor-core products -----------------------------------------------------

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the bits cvt.rna.tf32.f32 gives for every finite x, in two
// integer ops. Adding half of the dropped field to the magnitude bits
// carries into the kept bits exactly when the dropped part is at least
// half a step. (The conversion instruction itself issues at a fraction
// of the integer rate; with four conversions per product it held the
// fp32 path back by about a quarter.)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo, both TF32 (round to nearest)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: the small terms first
__device__ __forceinline__ void mma3(float* c, const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (x, y) ~ hi + lo, both bf16 pairs
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16(x), hy = __float2bfloat16(y);
  hi = pack_bf16(hx, hy);
  lo = pack_bf16(__float2bfloat16(x - __bfloat162float(hx)),
                 __float2bfloat16(y - __bfloat162float(hy)));
}

// Fragment coordinates: lane = 4 g + t. An m16n8 accumulator c holds
// (row g, cols 2t, 2t+1) in c[0..1] and (row g+8, same cols) in c[2..3].

// s[j] += Q[16 rows] . K[8j .. 8j+7]^T over D, fp32 by 3xTF32.
// Q: this warp's 16 rows; K: the tile's BK rows.
template <int D, int BK>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4], const float* Q,
                                       const float* K, int g, int t) {
  constexpr int kLD = Tile<float, D>::kLD;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    // A (16x8, row-major): (g, t) (g+8, t) (g, t+4) (g+8, t+4)
    const float* q = Q + g * kLD + kk * 8 + t;
    uint32_t ah[4], al[4];
    split(q[0], ah[0], al[0]);
    split(q[8 * kLD], ah[1], al[1]);
    split(q[4], ah[2], al[2]);
    split(q[8 * kLD + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      // B (8x8, k x n) = K^T: (k = t, n = g) (k = t+4, n = g)
      const float* kp = K + (j * 8 + g) * kLD + kk * 8 + t;
      uint32_t bh[2], bl[2];
      split(kp[0], bh[0], bl[0]);
      split(kp[4], bh[1], bl[1]);
      mma3(s[j], ah, al, bh, bl);
    }
  }
}

// the same in bf16 (m16n8k16)
template <int D, int BK>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4],
                                       const __nv_bfloat16* Q,
                                       const __nv_bfloat16* K, int g, int t) {
  constexpr int kLD = Tile<__nv_bfloat16, D>::kLD;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // A (16x16): (g, 2t..2t+1) (g+8, 2t..) (g, 2t+8..) (g+8, 2t+8..)
    const __nv_bfloat16* q = Q + g * kLD + kk * 16 + 2 * t;
    const uint32_t a[4] = {ld32(q), ld32(q + 8 * kLD), ld32(q + 8),
                           ld32(q + 8 * kLD + 8)};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      // B (16x8) = K^T: (k = 2t..2t+1, n = g) (k = 2t+8.., n = g)
      const __nv_bfloat16* kp = K + (j * 8 + g) * kLD + kk * 16 + 2 * t;
      const uint32_t b[2] = {ld32(kp), ld32(kp + 8)};
      mma_bf16(s[j], a, b);
    }
  }
}

// o[n] += P[16 rows, BK keys] . V[BK, 8n .. 8n+7], fp32 by 3xTF32. P
// comes in the accumulator layout: for key chunk j the thread holds
// columns 2t, 2t+1, used as logical k = t and t + 4, so B reads V rows
// 8j + 2t and 8j + 2t + 1.
template <int D, int BK>
__device__ __forceinline__ void pv(float (&o)[D / 8][4],
                                   const float (&p)[BK / 8][4],
                                   const float* V, int g, int t) {
  constexpr int kLD = Tile<float, D>::kLD;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    uint32_t ah[4], al[4];
    split(p[j][0], ah[0], al[0]);  // (g, k = t)
    split(p[j][2], ah[1], al[1]);  // (g+8, k = t)
    split(p[j][1], ah[2], al[2]);  // (g, k = t+4)
    split(p[j][3], ah[3], al[3]);  // (g+8, k = t+4)
    const float* v = V + (j * 8 + 2 * t) * kLD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bh[2], bl[2];
      split(v[n * 8], bh[0], bl[0]);
      split(v[kLD + n * 8], bh[1], bl[1]);
      mma3(o[n], ah, al, bh, bl);
    }
  }
}

// the same in bf16: P split into hi + lo bf16 terms, two products
template <int D, int BK>
__device__ __forceinline__ void pv(float (&o)[D / 8][4],
                                   const float (&p)[BK / 8][4],
                                   const __nv_bfloat16* V, int g, int t) {
  constexpr int kLD = Tile<__nv_bfloat16, D>::kLD;
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    uint32_t ah[4], al[4];
    split_bf16(p[2 * j][0], p[2 * j][1], ah[0], al[0]);
    split_bf16(p[2 * j][2], p[2 * j][3], ah[1], al[1]);
    split_bf16(p[2 * j + 1][0], p[2 * j + 1][1], ah[2], al[2]);
    split_bf16(p[2 * j + 1][2], p[2 * j + 1][3], ah[3], al[3]);
    const __nv_bfloat16* v = V + (j * 16 + 2 * t) * kLD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* vn = v + n * 8;
      const uint32_t b[2] = {pack_bf16(vn[0], vn[kLD]),
                             pack_bf16(vn[8 * kLD], vn[9 * kLD])};
      mma_bf16(o[n], al, b);
      mma_bf16(o[n], ah, b);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
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
  load_rows<T, D, kBQ>(Qs, qb, qss, q0, Sq, tid);
  if (n_tiles > 0) {
    load_rows<T, D, kBK>(Ks, kb, kss, 0, Sk, tid);
    load_rows<T, D, kBK>(Vs, vb, vss, 0, Sk, tid);
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
      load_rows<T, D, kBK>(Ks + (buf ^ 1) * kBK * kLD, kb, kss,
                           (it + 1) * kBK, Sk, tid);
      load_rows<T, D, kBK>(Vs + (buf ^ 1) * kBK * kLD, vb, vss,
                           (it + 1) * kBK, Sk, tid);
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
    scores<D, kHK>(s, Qs + 16 * rg * kLD, Ks + off, g, t);

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
    pv<D, kHK>(o, s, Vs + off, g, t);
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
