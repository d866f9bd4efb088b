// Tensor-core building blocks of the attention kernels (attention_fwd.cu,
// attention_bwd.cu): 16-byte cp.async staging, TF32 rounding and the
// 3xTF32 split, mma.sync in TF32 and bf16, and the two warp-level
// products of an attention tile (a score tile Q K^T, and P V with P in
// the accumulator layout).
//
// Fragment coordinates: lane = 4 g + t. An m16n8 accumulator c holds
// (row g, cols 2t, 2t+1) in c[0..1] and (row g+8, same cols) in c[2..3].
#pragma once

#include "common.cuh"

namespace pt {

// -- copies -------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + R) of a [rows_total, D] operand with row stride rs
// (elements) into dst [R][LD], by THREADS threads; rows past rows_total
// are zeros
template <typename T, int D, int R, int LD, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long rs,
                                          int r0, int rows_total, int tid) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = D / kVec;
  static_assert((R * kPerRow) % THREADS == 0, "tile not a thread multiple");
#pragma unroll
  for (int it = 0; it < R * kPerRow / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / kPerRow, c = (i - r * kPerRow) * kVec;
    const int s = r0 + r;
    const bool ok = s < rows_total;
    cp_async16(dst + r * LD + c,
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

// x ~ hi + lo: hi rounded to TF32, lo = x - hi (exact in f32) passed as
// it is, since the tensor core reads a TF32 operand's top 19 bits and so
// truncates lo (|lo| <= 2^-11 |x|, so lo's own error is below 2^-21 |x|).
// Rounding lo as well costs two more integer ops per split, and the
// splits bound the fp32 attention kernels with the products.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
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

// s[j] += A[16 rows] . B[8j .. 8j+7]^T over D, fp32 by 3xTF32. A: the
// warp's 16 rows, B: N rows, both [rows][LD] in shared memory.
template <int D, int N, int LD>
__device__ __forceinline__ void scores(float (&s)[N / 8][4], const float* A,
                                       const float* B, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    // A (16x8, row-major): (g, t) (g+8, t) (g, t+4) (g+8, t+4)
    const float* a = A + g * LD + kk * 8 + t;
    uint32_t ah[4], al[4];
    split(a[0], ah[0], al[0]);
    split(a[8 * LD], ah[1], al[1]);
    split(a[4], ah[2], al[2]);
    split(a[8 * LD + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      // B (8x8, k x n) = B^T: (k = t, n = g) (k = t+4, n = g)
      const float* bp = B + (j * 8 + g) * LD + kk * 8 + t;
      uint32_t bh[2], bl[2];
      split(bp[0], bh[0], bl[0]);
      split(bp[4], bh[1], bl[1]);
      mma3(s[j], ah, al, bh, bl);
    }
  }
}

// the same in bf16 (m16n8k16)
template <int D, int N, int LD>
__device__ __forceinline__ void scores(float (&s)[N / 8][4],
                                       const __nv_bfloat16* A,
                                       const __nv_bfloat16* B, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // A (16x16): (g, 2t..2t+1) (g+8, 2t..) (g, 2t+8..) (g+8, 2t+8..)
    const __nv_bfloat16* a = A + g * LD + kk * 16 + 2 * t;
    const uint32_t af[4] = {ld32(a), ld32(a + 8 * LD), ld32(a + 8),
                            ld32(a + 8 * LD + 8)};
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      // B (16x8) = B^T: (k = 2t..2t+1, n = g) (k = 2t+8.., n = g)
      const __nv_bfloat16* bp = B + (j * 8 + g) * LD + kk * 16 + 2 * t;
      const uint32_t bf[2] = {ld32(bp), ld32(bp + 8)};
      mma_bf16(s[j], af, bf);
    }
  }
}

// o[n] += P[16 rows, BK] . V[BK, 8n .. 8n+7] for N columns, fp32 by
// 3xTF32. at(j, e) gives P in the accumulator layout of key chunk j:
// e = 0, 1 row g, columns 2t, 2t+1; e = 2, 3 row g+8. Those columns are
// used as logical k = t and t + 4, so B reads V rows 8j + 2t and
// 8j + 2t + 1 (and every fragment load is conflict-free when LD is
// D + 4).
template <int N, int BK, int LD, typename At>
__device__ __forceinline__ void pv_at(float (&o)[N / 8][4], At at,
                                      const float* V, int g, int t) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    uint32_t ah[4], al[4];
    split(at(j, 0), ah[0], al[0]);  // (g, k = t)
    split(at(j, 2), ah[1], al[1]);  // (g+8, k = t)
    split(at(j, 1), ah[2], al[2]);  // (g, k = t+4)
    split(at(j, 3), ah[3], al[3]);  // (g+8, k = t+4)
    const float* v = V + (j * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      uint32_t bh[2], bl[2];
      split(v[n * 8], bh[0], bl[0]);
      split(v[LD + n * 8], bh[1], bl[1]);
      mma3(o[n], ah, al, bh, bl);
    }
  }
}

// the same in bf16: P split into hi + lo bf16 terms, two products
template <int N, int BK, int LD, typename At>
__device__ __forceinline__ void pv_at(float (&o)[N / 8][4], At at,
                                      const __nv_bfloat16* V, int g, int t) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    uint32_t ah[4], al[4];
    split_bf16(at(2 * j, 0), at(2 * j, 1), ah[0], al[0]);
    split_bf16(at(2 * j, 2), at(2 * j, 3), ah[1], al[1]);
    split_bf16(at(2 * j + 1, 0), at(2 * j + 1, 1), ah[2], al[2]);
    split_bf16(at(2 * j + 1, 2), at(2 * j + 1, 3), ah[3], al[3]);
    const __nv_bfloat16* v = V + (j * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const __nv_bfloat16* vn = v + n * 8;
      const uint32_t b[2] = {pack_bf16(vn[0], vn[LD]),
                             pack_bf16(vn[8 * LD], vn[9 * LD])};
      mma_bf16(o[n], al, b);
      mma_bf16(o[n], ah, b);
    }
  }
}

// P held in registers, in the accumulator layout
template <int N, int BK, int LD, typename T>
__device__ __forceinline__ void pv(float (&o)[N / 8][4],
                                   const float (&p)[BK / 8][4], const T* V,
                                   int g, int t) {
  pv_at<N, BK, LD>(o, [&](int j, int e) { return p[j][e]; }, V, g, t);
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

}  // namespace pt
