// fused_argmax: greedy lm-head sampling without the [B, V] logits.
//
// Replaces the TPU kernel fused_sample._argmax_kernel
// (paddle_tpu/ops/pallas/fused_sample.py:175-225). Semantics: tokens[b]
// = argmax_v (hidden[b] . W_v + bias[v]) with the weight in either
// layout ([V, D] vocab-major, the tied embedding; or [D, V]); ties go
// to the first index and the first NaN index wins over any number,
// exactly like jnp.argmax and the reference's running carry
// (fused_sample.py:115-139, 205-221).
//
// What bounds it on the H100: bytes up to a few tens of rows (V*D
// weight values, 412 MB in fp32 at GPT-1.3B, read for 2*R flops each),
// then the fp32 products (3xTF32: three TF32 products a product).
//
// Design. As on the TPU (fused_sample.py:228-262: the [B, D] hidden block
// resident, each weight tile streamed once for every row), the rows live
// inside the block, never on the grid:
//  1. argmax_tiles_kernel: a block owns a vocab tile of VT entries and
//     computes its logits for up to RP rows at once, so one call reads W
//     from HBM once for R <= RP (RP = 256 in the largest configuration;
//     past that, once a pass of RP rows). The contraction runs in slices
//     of DK values: a [VT, DK] weight slice and an [RP, DK] hidden slice
//     a stage, STAGES - 1 stages in flight with 16-byte cp.async (plain
//     loads where a row is not 16-byte aligned: the [D, V] layout with
//     an odd V). Shared memory holds the stages only, whatever D is, and
//     the hidden slice is read from L2 once a vocab tile.
//     The products run on the tensor cores (mma.sync m16n8k8 TF32, vocab
//     on M, rows on N): fp32 operands as 3xTF32 (hi*hi + hi*lo + lo*hi),
//     bf16 operands exact in TF32, so a bf16 side needs no split (fp32 x
//     bf16 takes two products, bf16 x bf16 one). The tensor core
//     truncates its accumulator, so each k16 step starts a fresh fragment
//     (C = 0) that is added to the f32 sum with a rounded FADD: the sum
//     keeps the error of an fp32 FMA chain, which the index-exact check
//     against the plain version's fp32 logits needs.
//     Non-finite values: x - tf32(x) is NaN for x = +-inf, and hi * lo
//     with hi = inf is inf or NaN where the plain product is a number.
//     The fast split ignores them; a logit that comes out non-finite (a
//     non-finite input always makes one) sends the block's pass through
//     again with split_safe, where a non-finite value's small term is 0
//     and its hi enters the small products as 0 (hi0): only hi * hi
//     carries inf and NaN, as x * y does.
//     The epilogue stores the [RP, VT] logits in shared memory, adds the
//     bias, masks the ragged vocab edge with -1e30, and writes per row a
//     (max, first index of the max, first NaN index or -1) record to
//     [n_tiles, R] buffers.
//  2. argmax_reduce_kernel: 256 threads a row fold the records IN TILE
//     ORDER (contiguous runs, then an ordered shuffle tree and an
//     ordered merge of the warps). GPU blocks run in no order, so atomics
//     on the max would break the first-index and first-NaN rules; the
//     ordered merge keeps both.
//
// Configurations (PT_ARGMAX_CONFIGS, picked by R; VT = 16 MT WM, RP = 8
// NT WN), chosen by timing candidate tables on an H100 at R = 1-256
// (PERF.md). R <= 8 is bytes-bound, so its blocks take 512-byte runs
// of 64 weight rows a stage (DK = 128: DRAM pages read in longer runs)
// and scalar fragment loads; the tensor-core work is a few percent of
// the bound.
// Past 8 rows the products and their splits grow with R: a warp owns a
// 32-vocab x 32-row tile (MT = 2, NT = 4; 32 x 64 past 128 rows), which
// shares each split operand over more products, and loads its fragments
// four values at a time (VEC); past 64 rows, 16 warps a block share a
// 128-entry vocab tile. The n-tiles of the WN row warps interleave so
// that a partial RP keeps them balanced, and n-tiles past R are skipped.
// No FMA path: at R <= 8 the 3xTF32 products stay under the bytes bound.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kRedThreads = 256;  // reduce: threads a row

struct Best {
  float v;   // max over non-NaN values
  int i;     // first index achieving v
  int nan;   // first NaN index, -1 when none
};

// merge a (earlier vocab range) with b (later): the first NaN wins,
// then a strictly larger max; equal maxima keep the earlier index
__device__ __forceinline__ Best merge(Best a, Best b) {
  if (a.nan >= 0) return a;
  if (b.nan >= 0) return b;
  return b.v > a.v ? b : a;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x ~ hi + lo for the 3xTF32 products: hi = x rounded to TF32
// (pt::tf32), lo = x - hi exactly. For finite x only: a non-finite x
// leaves lo NaN, so every logit it reaches is NaN, and the block then
// recomputes the pass with split_safe.
__device__ __forceinline__ void split_fast(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pt::tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// the same for any x. Finite x near FLT_MAX is truncated (rounding would
// overflow). Non-finite x: hi carries it (a NaN as a canonical NaN, whose
// top 19 bits the tensor core reads as NaN), lo = 0 and hi0 = 0, so that
// the small products stay finite; hi0 = hi otherwise.
__device__ __forceinline__ void split_safe(float x, uint32_t& hi,
                                           uint32_t& hi0, uint32_t& lo) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t a = u & 0x7fffffffu;
  if (a < 0x7f7ff000u) {
    hi = pt::tf32(x);
    hi0 = hi;
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else if (a < 0x7f800000u) {
    hi = u & 0xffffe000u;
    hi0 = hi;
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = a == 0x7f800000u ? u : 0x7fffffffu;
    hi0 = 0u;
    lo = 0u;
  }
}

// an operand's TF32 terms: split fp32 (SPLIT), or a bf16 value, which
// is exact in TF32 (no small term)
template <bool SAFE, bool SPLIT>
__device__ __forceinline__ void take(float x, uint32_t& hi, uint32_t& hi0,
                                     uint32_t& lo) {
  if (SPLIT) {
    if (SAFE) {
      split_safe(x, hi, hi0, lo);
    } else {
      split_fast(x, hi, lo);
      hi0 = hi;
    }
  } else {
    hi = __float_as_uint(x);
    hi0 = SAFE && (hi & 0x7f800000u) == 0x7f800000u ? 0u : hi;
    lo = 0u;
  }
}

// d = a b (a fresh fragment: C = 0)
__device__ __forceinline__ void mma_fresh(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// c (+)= A B for one k8 step, the small terms first; FRESH starts c
// at 0
template <bool SA, bool SB, bool FRESH>
__device__ __forceinline__ void product(float* c, const uint32_t* ah,
                                        const uint32_t* ah0,
                                        const uint32_t* al,
                                        const uint32_t* bh,
                                        const uint32_t* bh0,
                                        const uint32_t* bl) {
  if (SA) {
    if (FRESH)
      mma_fresh(c, al, bh0);
    else
      pt::mma_tf32(c, al, bh0);
  }
  if (SB) {
    if (FRESH && !SA)
      mma_fresh(c, ah0, bl);
    else
      pt::mma_tf32(c, ah0, bl);
  }
  if (FRESH && !SA && !SB)
    mma_fresh(c, ah, bh);
  else
    pt::mma_tf32(c, ah, bh);
}

template <typename T>
__host__ __device__ constexpr int vec() {
  return 16 / static_cast<int>(sizeof(T));
}

// shared-memory leading dimensions (elements), chosen so that the
// fragment loads are free of bank conflicts and rows stay 16-byte
// aligned: scalar loads take a pad of 16 bytes, the 4-value loads of
// VEC (16 or 8 bytes a lane) a pad of 16 values
template <typename T, int DK, bool VEC>  // a [rows][DK] slice
__host__ __device__ constexpr int ld_k() {
  return DK + (VEC ? 16 : vec<T>());
}
template <typename T, int VT>  // a [DK][VT] slice (the [D, V] layout)
__host__ __device__ constexpr int ld_v() {
  return VT + 2 * vec<T>();
}

template <typename TH, typename TW, bool VM, int MT, int WM, int WN, int NT,
          int STAGES, int DK>
struct Cfg {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kVT = 16 * MT * WM;
  static constexpr int kRP = 8 * NT * WN;
  // 4-value fragment loads where the products, not the bytes, bound
  static constexpr bool kVec = VM && kRP >= 32;
  static constexpr int kLW = VM ? ld_k<TW, DK, kVec>() : ld_v<TW, kVT>();
  static constexpr int kLH = ld_k<TH, DK, kVec>();
  static constexpr int kW = VM ? kVT * kLW : DK * kLW;
  static constexpr int kH = kRP * kLH;
  static constexpr int kStageBytes =
      kW * static_cast<int>(sizeof(TW)) + kH * static_cast<int>(sizeof(TH));
  static constexpr int kLDL = kVT + 4;  // the epilogue's [RP][VT] logits
  static constexpr int kSmem = STAGES * kStageBytes > kRP * kLDL * 4
                                   ? STAGES * kStageBytes
                                   : kRP * kLDL * 4;
};

// one stage's copies: the weight slice [VT, DK] (or [DK, VT]) at vocab
// v0 and contraction d0, and the hidden slice [rows, DK] at row r0.
// Rows past R and vocab entries past V are not copied (their logits are
// never read unmasked); contraction values past D are zero on both sides.
template <typename TH, typename TW, bool VM, int VT, int DK, int LW, int LH,
          int THREADS>
__device__ __forceinline__ void load_stage(
    TW* ws, TH* hs, const TW* __restrict__ w, const TH* __restrict__ hidden,
    int v0, int d0, int r0, int rows, int D, int V, bool w16, bool h16,
    int tid) {
  if (VM) {
    constexpr int LD = LW;
    if (w16) {
      constexpr int kPer = DK / vec<TW>();
#pragma unroll
      for (int i = tid; i < VT * kPer; i += THREADS) {
        const int r = i / kPer, c = (i - r * kPer) * vec<TW>();
        const int v = v0 + r, d = d0 + c;
        if (v < V)
          pt::cp_async16(ws + r * LD + c,
                         w + (d < D ? static_cast<size_t>(v) * D + d : 0),
                         d < D);
      }
    } else {
      for (int i = tid; i < VT * DK; i += THREADS) {
        const int r = i / DK, c = i - r * DK;
        const int v = v0 + r, d = d0 + c;
        if (v < V)
          ws[r * LD + c] =
              d < D ? w[static_cast<size_t>(v) * D + d] : pt::from_f<TW>(0.f);
      }
    }
  } else {
    constexpr int LD = LW;
    if (w16) {
      constexpr int kPer = VT / vec<TW>();
#pragma unroll
      for (int i = tid; i < DK * kPer; i += THREADS) {
        const int k = i / kPer, c = (i - k * kPer) * vec<TW>();
        const int d = d0 + k, v = v0 + c;
        if (v < V)
          pt::cp_async16(ws + k * LD + c,
                         w + (d < D ? static_cast<size_t>(d) * V + v : 0),
                         d < D);
      }
    } else {
      for (int i = tid; i < DK * VT; i += THREADS) {
        const int k = i / VT, c = i - k * VT;
        const int d = d0 + k, v = v0 + c;
        if (v < V)
          ws[k * LD + c] =
              d < D ? w[static_cast<size_t>(d) * V + v] : pt::from_f<TW>(0.f);
      }
    }
  }
  if (h16) {
    constexpr int kPer = DK / vec<TH>();
    for (int i = tid; i < rows * kPer; i += THREADS) {
      const int r = i / kPer, c = (i - r * kPer) * vec<TH>();
      const int d = d0 + c;
      pt::cp_async16(
          hs + r * LH + c,
          hidden + (d < D ? static_cast<size_t>(r0 + r) * D + d : 0), d < D);
    }
  } else {
    for (int i = tid; i < rows * DK; i += THREADS) {
      const int r = i / DK, c = i - r * DK;
      const int d = d0 + c;
      hs[r * LH + c] = d < D ? hidden[static_cast<size_t>(r0 + r) * D + d]
                             : pt::from_f<TH>(0.f);
    }
  }
}

// four consecutive values of a row in shared memory, as floats
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// two k8 steps (k16) of the warp's MT x NT fragments from a stage in
// shared memory, into one fresh fragment a tile that is then added to
// acc with a rounded FADD. A (16 vocab x 8 contraction), row-major:
// (g, t) (g+8, t) (g, t+4) (g+8, t+4); B (8 contraction x 8 rows) =
// hidden^T: (k = t, n = g) (k = t+4, n = g). VEC permutes the
// contraction inside the k16 block, the same way for A and B (a sum
// over k in any order): step s takes columns 4t + 2s and 4t + 2s + 1 as
// its k = t and t + 4, so a lane's four values of a row are adjacent and
// come in one load. The WN row warps take interleaved n-tiles.
template <bool SAFE, bool VEC, typename TH, typename TW, bool VM, int MT,
          int WN, int NT, int LW, int LH>
__device__ __forceinline__ void k16_step(float (&acc)[MT][NT][4],
                                         const TW* ws, const TH* hs, int k16,
                                         int n8, int m0, int wn, int g,
                                         int t) {
  constexpr bool SA = sizeof(TW) == 4;  // fp32 weight: split
  constexpr bool SB = sizeof(TH) == 4;  // fp32 hidden: split
  const int kb = k16 * 16;
  uint32_t ah[2][MT][4], ah0[2][MT][4], al[2][MT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int m = m0 + mi * 16 + g;
    float x[2][4];  // [step][(g, t) (g+8, t) (g, t+4) (g+8, t+4)]
    if (VEC) {
      float r0[4], r8[4];
      load4(ws + m * LW + kb + 4 * t, r0);
      load4(ws + (m + 8) * LW + kb + 4 * t, r8);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        x[s][0] = r0[2 * s];
        x[s][1] = r8[2 * s];
        x[s][2] = r0[2 * s + 1];
        x[s][3] = r8[2 * s + 1];
      }
    } else {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int k = kb + s * 8 + t;
        if (VM) {
          x[s][0] = pt::to_f(ws[m * LW + k]);
          x[s][1] = pt::to_f(ws[(m + 8) * LW + k]);
          x[s][2] = pt::to_f(ws[m * LW + k + 4]);
          x[s][3] = pt::to_f(ws[(m + 8) * LW + k + 4]);
        } else {
          x[s][0] = pt::to_f(ws[k * LW + m]);
          x[s][1] = pt::to_f(ws[k * LW + m + 8]);
          x[s][2] = pt::to_f(ws[(k + 4) * LW + m]);
          x[s][3] = pt::to_f(ws[(k + 4) * LW + m + 8]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        take<SAFE, SA>(x[s][e], ah[s][mi][e], ah0[s][mi][e], al[s][mi][e]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int nt = j * WN + wn;
    if (nt < n8) {
      // [step][(k = t) (k = t+4)]
      float y[2][2];
      const int row = (nt * 8 + g) * LH;
      if (VEC) {
        float u[4];
        load4(hs + row + kb + 4 * t, u);
        y[0][0] = u[0];
        y[0][1] = u[1];
        y[1][0] = u[2];
        y[1][1] = u[3];
      } else {
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            y[s][e] = pt::to_f(hs[row + kb + s * 8 + t + 4 * e]);
      }
      uint32_t bh[2][2], bh0[2][2], bl[2][2];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          take<SAFE, SB>(y[s][e], bh[s][e], bh0[s][e], bl[s][e]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        float c[4];
        product<SA, SB, true>(c, ah[0][mi], ah0[0][mi], al[0][mi], bh[0],
                              bh0[0], bl[0]);
        product<SA, SB, false>(c, ah[1][mi], ah0[1][mi], al[1][mi], bh[1],
                               bh0[1], bl[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] += c[e];
      }
    }
  }
}

// one pass's contraction over D: acc = W[v0 : v0 + VT] . hidden[r0 :
// r0 + rows]^T, STAGES - 1 stages in flight. Ends with every warp done
// with the stage buffers.
template <bool SAFE, typename TH, typename TW, bool VM, int MT, int WM,
          int WN, int NT, int STAGES, int DK>
__device__ __forceinline__ void contract(
    float (&acc)[MT][NT][4], unsigned char* smem, const TW* __restrict__ w,
    const TH* __restrict__ hidden, int v0, int r0, int rows, int n8, int D,
    int V, bool w16, bool h16, int tid, int wm, int wn, int g, int t) {
  using C = Cfg<TH, TW, VM, MT, WM, WN, NT, STAGES, DK>;
  constexpr int kThreads = C::kThreads, VT = C::kVT;
  const int n_k = (D + DK - 1) / DK;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  auto ws_at = [&](int s) {
    return reinterpret_cast<TW*>(smem + s * C::kStageBytes);
  };
  auto hs_at = [&](int s) {
    return reinterpret_cast<TH*>(smem + s * C::kStageBytes +
                                 C::kW * sizeof(TW));
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k)
      load_stage<TH, TW, VM, VT, DK, C::kLW, C::kLH, kThreads>(
          ws_at(s), hs_at(s), w, hidden, v0, s * DK, r0, rows, D, V, w16,
          h16, tid);
    pt::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free
    {
      const int nx = kt + STAGES - 1;
      if (nx < n_k)
        load_stage<TH, TW, VM, VT, DK, C::kLW, C::kLH, kThreads>(
            ws_at(nx % STAGES), hs_at(nx % STAGES), w, hidden, v0, nx * DK,
            r0, rows, D, V, w16, h16, tid);
      pt::cp_async_commit();
    }
    const TW* ws = ws_at(kt % STAGES);
    const TH* hs = hs_at(kt % STAGES);
    if (SAFE) {
#pragma unroll 1
      for (int k16 = 0; k16 < DK / 16; ++k16)
        k16_step<true, C::kVec, TH, TW, VM, MT, WN, NT, C::kLW, C::kLH>(
            acc, ws, hs, k16, n8, wm * MT * 16, wn, g, t);
    } else {
#pragma unroll
      for (int k16 = 0; k16 < DK / 16; ++k16)
        k16_step<false, C::kVec, TH, TW, VM, MT, WN, NT, C::kLW, C::kLH>(
            acc, ws, hs, k16, n8, wm * MT * 16, wn, g, t);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// the accumulators into the [RP][VT] logits (m = g, n = 2t, 2t+1;
// m = g+8, same n); whether a logit of a live row and vocab entry is not
// finite
template <int MT, int WN, int NT, int LDL>
__device__ __forceinline__ bool store_logits(const float (&acc)[MT][NT][4],
                                             float* lg, int m0, int v0,
                                             int V, int rows, int n8, int wn,
                                             int g, int t) {
  bool bad = false;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int nt = j * WN + wn;
      if (nt < n8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + mi * 16 + g + (e >> 1) * 8;
          const int n = nt * 8 + 2 * t + (e & 1);
          const float x = acc[mi][j][e];
          lg[n * LDL + m] = x;
          bad |= n < rows && v0 + m < V && (isnan(x) || isinf(x));
        }
      }
    }
  return bad;
}

template <typename TH, typename TW, bool VM, int MT, int WM, int WN, int NT,
          int STAGES, int DK>
__global__ void __launch_bounds__(32 * WM * WN)
    argmax_tiles_kernel(const TH* __restrict__ hidden,
                        const TW* __restrict__ w, const TW* __restrict__ bias,
                        float* __restrict__ tile_max,
                        int* __restrict__ tile_arg, int* __restrict__ tile_nan,
                        int R, int D, int V, int has_bias, int w16, int h16) {
  using C = Cfg<TH, TW, VM, MT, WM, WN, NT, STAGES, DK>;
  constexpr int kThreads = C::kThreads, VT = C::kVT, RP = C::kRP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int tile = blockIdx.x;
  const int v0 = tile * VT;
  const int m0 = wm * MT * 16;
  float* lg = reinterpret_cast<float*>(smem);

  for (int r0 = 0; r0 < R; r0 += RP) {
    const int rows = min(RP, R - r0);
    const int n8 = (rows + 7) / 8;  // live n-tiles of the pass
    float acc[MT][NT][4];
    contract<false, TH, TW, VM, MT, WM, WN, NT, STAGES, DK>(
        acc, smem, w, hidden, v0, r0, rows, n8, D, V, w16, h16, tid, wm, wn,
        g, t);
    const bool bad = store_logits<MT, WN, NT, C::kLDL>(acc, lg, m0, v0, V,
                                                       rows, n8, wn, g, t);
    if (__syncthreads_or(bad)) {
      // a non-finite input reached a logit: the pass again with the
      // split that keeps inf and NaN out of the small products
      contract<true, TH, TW, VM, MT, WM, WN, NT, STAGES, DK>(
          acc, smem, w, hidden, v0, r0, rows, n8, D, V, w16, h16, tid, wm,
          wn, g, t);
      store_logits<MT, WN, NT, C::kLDL>(acc, lg, m0, v0, V, rows, n8, wn, g,
                                        t);
      __syncthreads();
    }

    // per row: the tile's (max, first max, first NaN), 32 entries at a
    // time in order
    float bv[VT / 32];
#pragma unroll
    for (int c = 0; c < VT / 32; ++c) {
      const int v = v0 + c * 32 + lane;
      bv[c] = has_bias && v < V ? pt::to_f(bias[v]) : 0.f;
    }
    for (int r = warp; r < rows; r += kThreads / 32) {
      Best best{0.f, 0, -1};
#pragma unroll
      for (int c = 0; c < VT / 32; ++c) {
        const int vc = v0 + c * 32;
        float x = lg[r * C::kLDL + c * 32 + lane] + bv[c];
        if (vc + lane >= V) x = pt::kNegInf;  // the ragged edge, as on the TPU
        const bool is_nan = isnan(x);
        const unsigned nan_mask = __ballot_sync(0xffffffffu, is_nan);
        const float mx = pt::warp_max(is_nan ? pt::kNegInf : x);
        const unsigned at_max =
            __ballot_sync(0xffffffffu, !is_nan && x == mx);
        const Best here{mx, vc + __ffs(at_max) - 1,
                        nan_mask ? vc + __ffs(nan_mask) - 1 : -1};
        best = c == 0 ? here : merge(best, here);
      }
      if (lane == 0) {
        const size_t o = static_cast<size_t>(tile) * R + r0 + r;
        tile_max[o] = best.v;
        tile_arg[o] = best.i;
        tile_nan[o] = best.nan;
      }
    }
    __syncthreads();  // the next pass reuses the shared memory
  }
}

// lane L merges with lane L + off (a later range), in order; a lane with
// nothing yet takes the other side as it is
__device__ __forceinline__ void ordered_tree(Best& me, bool& empty,
                                             int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    Best other;
    other.v = __shfl_down_sync(0xffffffffu, me.v, off);
    other.i = __shfl_down_sync(0xffffffffu, me.i, off);
    other.nan = __shfl_down_sync(0xffffffffu, me.nan, off);
    const bool other_empty =
        __shfl_down_sync(0xffffffffu, static_cast<int>(empty), off) != 0;
    if ((lane % (2 * off)) == 0 && lane + off < 32 && !other_empty) {
      me = empty ? other : merge(me, other);
      empty = false;
    }
  }
}

__global__ void __launch_bounds__(kRedThreads)
    argmax_reduce_kernel(const float* __restrict__ tile_max,
                         const int* __restrict__ tile_arg,
                         const int* __restrict__ tile_nan,
                         int* __restrict__ out, int B, int n_tiles) {
  __shared__ Best part[kRedThreads / 32];
  __shared__ int part_empty[kRedThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int per = (n_tiles + kRedThreads - 1) / kRedThreads;
  const int t0 = tid * per, t1 = min(n_tiles, t0 + per);
  // the reference's carry starts at (-1e30, index 0): only a strictly
  // larger tile max (or a NaN) replaces it
  Best me{pt::kNegInf, 0, -1};
  bool empty = tid != 0;
  for (int t = t0; t < t1; ++t) {
    const size_t o = static_cast<size_t>(t) * B + b;
    const Best x{tile_max[o], tile_arg[o], tile_nan[o]};
    me = empty ? x : merge(me, x);
    empty = false;
  }
  ordered_tree(me, empty, lane);
  if (lane == 0) {
    part[warp] = me;
    part_empty[warp] = empty;
  }
  __syncthreads();
  if (warp == 0) {
    empty = true;
    if (lane < kRedThreads / 32) {
      me = part[lane];
      empty = part_empty[lane] != 0;
    }
    ordered_tree(me, empty, lane);
    if (lane == 0) out[b] = me.nan >= 0 ? me.nan : me.i;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename TH, typename TW, bool VM, int MT, int WM, int WN, int NT,
          int STAGES, int DK>
int launch_tiles(const void* hidden, const void* w, const void* bias,
                 float* tile_max, int* tile_arg, int* tile_nan, int B, int D,
                 int V, int has_bias, int n_tiles, cudaStream_t stream) {
  using C = Cfg<TH, TW, VM, MT, WM, WN, NT, STAGES, DK>;
  if (n_tiles != (V + C::kVT - 1) / C::kVT)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w16 = aligned16(w) &&
                  (static_cast<size_t>(VM ? D : V) * sizeof(TW)) % 16 == 0;
  const int h16 =
      aligned16(hidden) && (static_cast<size_t>(D) * sizeof(TH)) % 16 == 0;
  cudaFuncSetAttribute(
      argmax_tiles_kernel<TH, TW, VM, MT, WM, WN, NT, STAGES, DK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  argmax_tiles_kernel<TH, TW, VM, MT, WM, WN, NT, STAGES, DK>
      <<<n_tiles, C::kThreads, C::kSmem, stream>>>(
          static_cast<const TH*>(hidden), static_cast<const TW*>(w),
          static_cast<const TW*>(bias), tile_max, tile_arg, tile_nan, B, D,
          V, has_bias, w16, h16);
  return static_cast<int>(cudaGetLastError());
}

// the configuration by rows: (id, largest R, MT, WM, WN, NT, STAGES, DK)
#define PT_ARGMAX_CONFIGS(X)       \
  X(0, 8, 1, 4, 1, 1, 3, 128)      \
  X(1, 64, 2, 2, 2, 4, 3, 32)      \
  X(2, 128, 2, 4, 4, 4, 2, 32)     \
  X(3, 1 << 30, 2, 4, 4, 8, 2, 32)

int config_of(int B) {
#define PT_PICK(id, rows, MT, WM, WN, NT, S, DK) \
  if (B <= (rows)) return id;
  PT_ARGMAX_CONFIGS(PT_PICK)
#undef PT_PICK
  return 3;
}

int vocab_tile(int config) {
#define PT_VT(id, rows, MT, WM, WN, NT, S, DK) \
  if (config == id) return 16 * MT * WM;
  PT_ARGMAX_CONFIGS(PT_VT)
#undef PT_VT
  return 0;
}

template <typename TH, typename TW, bool VM>
int launch_layout(const void* hidden, const void* w, const void* bias,
                  float* tile_max, int* tile_arg, int* tile_nan, int B, int D,
                  int V, int has_bias, int n_tiles, cudaStream_t stream) {
  const int config = config_of(B);
#define PT_LAUNCH(id, rows, MT, WM, WN, NT, S, DK)                           \
  if (config == id)                                                        \
    return launch_tiles<TH, TW, VM, MT, WM, WN, NT, S, DK>(                \
        hidden, w, bias, tile_max, tile_arg, tile_nan, B, D, V, has_bias, \
        n_tiles, stream);
  PT_ARGMAX_CONFIGS(PT_LAUNCH)
#undef PT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TH, typename TW>
int launch(const void* hidden, const void* w, const void* bias,
           float* tile_max, int* tile_arg, int* tile_nan, int* out, int B,
           int D, int V, int vocab_major, int has_bias, int n_tiles,
           cudaStream_t stream) {
  const int e =
      vocab_major
          ? launch_layout<TH, TW, true>(hidden, w, bias, tile_max, tile_arg,
                                        tile_nan, B, D, V, has_bias, n_tiles,
                                        stream)
          : launch_layout<TH, TW, false>(hidden, w, bias, tile_max, tile_arg,
                                         tile_nan, B, D, V, has_bias, n_tiles,
                                         stream);
  if (e != 0) return e;
  argmax_reduce_kernel<<<B, kRedThreads, 0, stream>>>(
      tile_max, tile_arg, tile_nan, out, B, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vocab tiles of a call with B rows: the records are [n_tiles, B]
extern "C" int pt_argmax_tile_count(int V, int B) {
  const int vt = vocab_tile(config_of(B));
  return (V + vt - 1) / vt;
}

extern "C" int pt_fused_argmax(const void* hidden, const void* weight,
                               const void* bias, void* tile_max,
                               void* tile_arg, void* tile_nan, void* out,
                               int B, int D, int V, int vocab_major,
                               int h_dtype, int w_dtype, int has_bias,
                               int n_tiles, void* stream) {
  if (B == 0) return 0;
  if (n_tiles != pt_argmax_tile_count(V, B)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* tm = static_cast<float*>(tile_max);
  int* ta = static_cast<int*>(tile_arg);
  int* tn = static_cast<int*>(tile_nan);
  int* o = static_cast<int*>(out);
  if (h_dtype == pt::kF32 && w_dtype == pt::kF32)
    return launch<float, float>(hidden, weight, bias, tm, ta, tn, o, B, D, V,
                                vocab_major, has_bias, n_tiles, st);
  if (h_dtype == pt::kF32 && w_dtype == pt::kBF16)
    return launch<float, __nv_bfloat16>(hidden, weight, bias, tm, ta, tn, o,
                                        B, D, V, vocab_major, has_bias,
                                        n_tiles, st);
  if (h_dtype == pt::kBF16 && w_dtype == pt::kF32)
    return launch<__nv_bfloat16, float>(hidden, weight, bias, tm, ta, tn, o,
                                        B, D, V, vocab_major, has_bias,
                                        n_tiles, st);
  if (h_dtype == pt::kBF16 && w_dtype == pt::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(hidden, weight, bias, tm, ta,
                                                tn, o, B, D, V, vocab_major,
                                                has_bias, n_tiles, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
