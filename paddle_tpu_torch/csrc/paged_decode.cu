// paged_decode: single-token ragged paged attention over a block-paged
// KV pool, as a split page walk with a fixed-order combine.
//
// Replaces the TPU kernel paged_attention._decode_kernel (its body
// _walk_pages, paddle_tpu/ops/pallas/paged_attention.py:75-160) and the
// attention half of _decode_fused_kernel (:163-193). Semantics: for
// sequence b and head h, softmax(q . K^T * scale) . V over the first
// len positions of the ceil(len/page) pages of the sequence's
// page-table row, in f32, rounded once to the output dtype; int8 pages
// are dequantized as q * scale / 127 with one scale per (page row,
// head), the scale taken out of the dot product; len 0 gives zeros,
// never NaN (the engine parks idle slots at len 0 on the scratch page).
//
// What bounds it on the H100: bytes. Each sequence reads its own
// len*H*D K and V values once (plus the scales of int8 pages) and does
// 4*D flops per value pair, far below the card's flops/byte balance
// point. The TPU walks a sequence's pages in series, one grid step per
// sequence with the next page's DMA in flight; one block per (b, h)
// doing the same here left the launch as long as the longest walk, with
// a few hundred bytes in flight per block.
//
// The split walk:
// - Work unit (b, h, split). A split is pages_per_split consecutive
//   pages of the sequence's table row (the wrapper's
//   paged_decode_split: PAGED_SPLIT_TOKENS positions in whole pages).
//   The partition depends only on the sequence's length and the page
//   size, never on B, H, the card or the other sequences, so a
//   sequence's context has the same bits alone or in any batch. Grid
//   (ceil(max_pages / pages_per_split), H, B); a block whose split lies
//   past its sequence's last page loads nothing (split 0 of a len-0
//   sequence writes the zeros).
// - Bytes in flight: every K or V row is read with 16-byte vector loads,
//   neighbouring lanes on neighbouring head-dim elements (one fp32 D=128
//   row per warp load, two bf16 rows, four int8 rows). A warp issues
//   kUnroll loads of K and kUnroll of V before it uses any of them; the
//   rows past len are never read.
// - Each warp keeps its own online softmax (m, l, acc) per row slot
//   (the lanes of one row), with no block barrier in the walk. At the
//   end of the split the row slots merge by shuffles and the warps in
//   warp order through shared memory.
// - Combine, no float atomics: a sequence of one split writes its
//   normalised context directly. Otherwise each split writes its partial
//   (m, l, acc[D]) in f32 to the wrapper's workspace and draws an
//   integer ticket for its (b, h) with atomicInc(ticket, n_splits - 1),
//   which wraps back to 0 on the last draw, so every launch leaves its
//   tickets at 0; the block that draws the last ticket merges the
//   partials in split order and writes the context. One launch a call,
//   because the decode step is paced by its host launches and a second
//   combine launch would add one a layer; the fence and the atomic a
//   block were not timed against such a second launch. An empty
//   partial (m = -1e30, l = 0) merges with weight exp(-1e30 - m) = 0 or
//   adds 0 * 1, never NaN.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// 16-byte loads of K (and as many of V) a lane has in flight
constexpr int kUnroll = 8;

template <typename T>
struct Vec;  // elements in 16 bytes
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};
template <>
struct Vec<int8_t> {
  static constexpr int n = 16;
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float* x);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& r, float* x) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& r,
                                                      float* x) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// int8 to float, exactly, without the quarter-rate integer conversion:
// the byte plus 128 becomes the low mantissa bits of 2^23 (one byte
// permute), then 2^23 + 128 comes off (one add)
template <>
__device__ __forceinline__ void unpack<int8_t>(const uint4& r, float* x) {
  const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u,
                         r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[4 * i + j] =
          __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540u | j)) -
          8388736.f;
}

// (m, l, acc) <- (m, l, acc) merged with (m2, l2, acc2), in that order
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float* acc,
                                      float m2, float l2,
                                      const float* acc2) {
  const float mn = fmaxf(m, m2);
  const float c1 = expf(m - mn), c2 = expf(m2 - mn);
  l = l * c1 + l2 * c2;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = acc[i] * c1 + acc2[i] * c2;
  m = mn;
}

template <typename TQ, typename TKV, bool QUANT, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                        const TKV* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ table,
                        const int* __restrict__ lens, TQ* __restrict__ out,
                        float* __restrict__ ws,
                        unsigned* __restrict__ tickets,
                        int H, int page, int max_pages, int pages_per_split,
                        float scale) {
  constexpr int VEC = Vec<TKV>::n;
  constexpr int G = D / VEC;  // lanes of one row
  constexpr int R = 32 / G;   // rows per warp load
  constexpr int ROWS = kUnroll * R;  // positions per warp iteration
  static_assert(D % VEC == 0 && 32 % G == 0, "row must tile the warp");
  __shared__ float s_acc[kWarps][D];
  __shared__ float s_m[kWarps], s_l[kWarps];
  __shared__ int s_last;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = lane / G, col = (lane % G) * VEC;
  const int bh = b * H + h;
  int len = lens[b];
  len = max(0, min(len, max_pages * page));
  const int n_pages = (len + page - 1) / page;
  const int n_splits = (n_pages + pages_per_split - 1) / pages_per_split;
  TQ* o = out + static_cast<size_t>(bh) * D;
  if (split >= n_splits) {
    if (split == 0)
      for (int d = tid; d < D; d += kThreads) o[d] = pt::from_f<TQ>(0.f);
    return;
  }
  const int t0 = split * pages_per_split * page;
  const int t1 = min(len, t0 + pages_per_split * page);
  const int* row = table + static_cast<size_t>(b) * max_pages;

  float qv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    qv[i] = pt::to_f(q[static_cast<size_t>(bh) * D + col + i]);
  float m = pt::kNegInf, l = 0.f, acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int base = t0 + warp * ROWS; base < t1; base += kWarps * ROWS) {
    uint4 kr[kUnroll], vr[kUnroll];
    float ksc[kUnroll], vsc[kUnroll];
    // every load first: a position past t1 re-reads the split's last
    // valid row (owned, cached) and is masked below
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = min(base + u * R + slot, t1 - 1);
      const size_t pos =
          static_cast<size_t>(row[t / page]) * page + t % page;
      const size_t off = (pos * H + h) * D + col;
      kr[u] = load16(kp + off);
      vr[u] = load16(vp + off);
      if (QUANT) {
        ksc[u] = __ldg(ks + pos * H + h);
        vsc[u] = __ldg(vs + pos * H + h);
      }
    }
    float s[kUnroll];
    float cmax = pt::kNegInf;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float x[VEC];
      unpack<TKV>(kr[u], x);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) dot += qv[i] * x[i];
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (QUANT) dot *= ksc[u] / 127.f;
      s[u] = base + u * R + slot < t1 ? dot * scale : pt::kNegInf;
      cmax = fmaxf(cmax, s[u]);
    }
    const float m_new = fmaxf(m, cmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * R + slot < t1) {
        float p = expf(s[u] - m_new);
        l += p;
        if (QUANT) p *= vsc[u] / 127.f;
        float x[VEC];
        unpack<TKV>(vr[u], x);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += p * x[i];
      }
    }
    m = m_new;
  }

  // the warp's row slots, slot 0 first
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    float a2[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      a2[i] = __shfl_xor_sync(0xffffffffu, acc[i], off);
    merge<VEC>(m, l, acc, m2, l2, a2);
  }
  if (slot == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) s_acc[warp][col + i] = acc[i];
    if (lane == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
  }
  __syncthreads();

  // the warps in warp order; one split is the whole walk
  if (n_splits == 1) {
    for (int d = tid; d < D; d += kThreads) {
      float mm = s_m[0], ll = s_l[0], a = s_acc[0][d];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        merge<1>(mm, ll, &a, s_m[w], s_l[w], &s_acc[w][d]);
      o[d] = pt::from_f<TQ>(a / fmaxf(ll, 1e-30f));
    }
    return;
  }
  // partial (m, l) pairs after the B * H * splits acc rows
  const size_t first = static_cast<size_t>(bh) * gridDim.x;
  float* ws_ml = ws + static_cast<size_t>(gridDim.z) * H * gridDim.x * D;
  for (int d = tid; d < D; d += kThreads) {
    float mm = s_m[0], ll = s_l[0], a = s_acc[0][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      merge<1>(mm, ll, &a, s_m[w], s_l[w], &s_acc[w][d]);
    ws[(first + split) * D + d] = a;
    if (d == 0) {
      ws_ml[(first + split) * 2] = mm;
      ws_ml[(first + split) * 2 + 1] = ll;
    }
  }

  // the last split of (b, h) to finish merges the partials in split
  // order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned last = n_splits - 1;
    s_last = atomicInc(tickets + bh, last) == last;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int d = tid; d < D; d += kThreads) {
    float mm = __ldcg(ws_ml + first * 2), ll = __ldcg(ws_ml + first * 2 + 1);
    float a = __ldcg(ws + first * D + d);
    for (int s2 = 1; s2 < n_splits; ++s2) {
      const float a2 = __ldcg(ws + (first + s2) * D + d);
      merge<1>(mm, ll, &a, __ldcg(ws_ml + (first + s2) * 2),
               __ldcg(ws_ml + (first + s2) * 2 + 1), &a2);
    }
    o[d] = pt::from_f<TQ>(a / fmaxf(ll, 1e-30f));
  }
}

template <typename TQ, typename TKV, bool QUANT, int D>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* table, const void* lens, void* out,
           void* ws, void* tickets, int B, int H, int page, int max_pages,
           int pages_per_split, float scale, cudaStream_t stream) {
  const int splits = max(1, (max_pages + pages_per_split - 1) /
                                pages_per_split);
  const dim3 grid(splits, H, B);
  paged_decode_kernel<TQ, TKV, QUANT, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<TQ*>(out),
      static_cast<float*>(ws), static_cast<unsigned*>(tickets), H, page,
      max_pages, pages_per_split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool QUANT>
int dispatch_d(const void* q, const void* kp, const void* vp,
               const void* ks, const void* vs, const void* table,
               const void* lens, void* out, void* ws, void* tickets, int B,
               int H, int D, int page, int max_pages, int pages_per_split,
               float scale, cudaStream_t stream) {
  if (D == 64)
    return launch<TQ, TKV, QUANT, 64>(q, kp, vp, ks, vs, table, lens, out,
                                      ws, tickets, B, H, page, max_pages,
                                      pages_per_split, scale, stream);
  if (D == 128)
    return launch<TQ, TKV, QUANT, 128>(q, kp, vp, ks, vs, table, lens, out,
                                       ws, tickets, B, H, page, max_pages,
                                       pages_per_split, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TQ>
int dispatch_kv(const void* q, const void* kp, const void* vp,
                const void* ks, const void* vs, const void* table,
                const void* lens, void* out, void* ws, void* tickets, int B,
                int H, int D, int page, int max_pages, int pages_per_split,
                int kv_dtype, float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case pt::kF32:
      return dispatch_d<TQ, float, false>(q, kp, vp, ks, vs, table, lens,
                                          out, ws, tickets, B, H, D, page,
                                          max_pages, pages_per_split, scale,
                                          stream);
    case pt::kBF16:
      return dispatch_d<TQ, __nv_bfloat16, false>(
          q, kp, vp, ks, vs, table, lens, out, ws, tickets, B, H, D, page,
          max_pages, pages_per_split, scale, stream);
    case pt::kI8:
      return dispatch_d<TQ, int8_t, true>(q, kp, vp, ks, vs, table, lens,
                                          out, ws, tickets, B, H, D, page,
                                          max_pages, pages_per_split, scale,
                                          stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ws: f32 workspace of B * H * splits * (D + 2) values, splits =
// ceil(max_pages / pages_per_split) (unused, may be null, when splits
// is 1); tickets: B * H 32-bit counters, 0 on entry and left 0 on exit.
extern "C" int pt_paged_decode(const void* q, const void* k_pages,
                               const void* v_pages, const void* k_scale,
                               const void* v_scale, const void* page_table,
                               const void* seq_lens, void* out, void* ws,
                               void* tickets, int B, int H, int D, int page,
                               int max_pages, int pages_per_split,
                               int q_dtype, int kv_dtype, float scale,
                               void* stream) {
  if (B == 0 || H == 0) return 0;
  if (page <= 0 || pages_per_split <= 0 || max_pages < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == pt::kF32)
    return dispatch_kv<float>(q, k_pages, v_pages, k_scale, v_scale,
                              page_table, seq_lens, out, ws, tickets, B, H,
                              D, page, max_pages, pages_per_split, kv_dtype,
                              scale, st);
  if (q_dtype == pt::kBF16)
    return dispatch_kv<__nv_bfloat16>(q, k_pages, v_pages, k_scale, v_scale,
                                      page_table, seq_lens, out, ws, tickets,
                                      B, H, D, page, max_pages,
                                      pages_per_split, kv_dtype, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
