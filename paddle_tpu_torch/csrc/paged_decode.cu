// paged_decode: single-token ragged paged attention over a block-paged
// KV pool.
//
// Replaces the TPU kernel paged_attention._decode_kernel (its body
// _walk_pages, paddle_tpu/ops/pallas/paged_attention.py:75-160) and the
// attention half of _decode_fused_kernel (:163-193). Semantics: for
// sequence b and head h, walk the ceil(len/page) pages of the
// sequence's page-table row with an online softmax in f32 and return
// the normalised context rounded to the output dtype; int8 pages are
// dequantized as q * scale / 127 with one scale per (page row, head);
// len 0 gives zeros, never NaN (the engine parks idle slots at len 0 on
// the scratch page).
//
// What bounds it on the H100: bytes. Each sequence reads its own
// len*H*D K and V values once (plus the scales for int8 pages) and does
// 4*D flops per value pair, far below the card's ~20 flops/byte
// balance point in fp32. The design streams only the pages a sequence
// owns (the ragged skip is the whole bandwidth win), with neighbouring
// threads on neighbouring head-dim elements so every K/V row read is
// one coalesced 512-byte transaction at D=128.
//
// Layout: grid (B, H), 128 threads. The TPU's sequential grid over
// sequences becomes parallel blocks; the page walk stays a loop inside
// the block. Per page: each warp scores a quarter of the page's
// positions (lanes split the head dim, one shuffle reduction per
// position), the block then takes the page max, rescales, and every
// thread accumulates the V rows for its own head-dim elements.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDPerThread = 2;  // D <= 256

template <typename TQ, typename TKV, bool QUANT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                        const TKV* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ table,
                        const int* __restrict__ lens, TQ* __restrict__ out,
                        int H, int D, int page, int max_pages, float scale) {
  extern __shared__ float smem[];
  float* sq = smem;      // [D] the query row in f32
  float* sp = smem + D;  // [page] scores, then probabilities
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;

  for (int d = tid; d < D; d += kThreads)
    sq[d] = pt::to_f(q[(static_cast<size_t>(b) * H + h) * D + d]);
  int len = lens[b];
  if (len < 0) len = 0;
  int n_pages = (len + page - 1) / page;
  // never read a page-table entry past the row (the append clamps
  // lengths to max_pages * page, so this only guards bad input)
  if (n_pages > max_pages) n_pages = max_pages;
  const int* row = table + static_cast<size_t>(b) * max_pages;

  float acc[kMaxDPerThread];
#pragma unroll
  for (int i = 0; i < kMaxDPerThread; ++i) acc[i] = 0.f;
  float m = pt::kNegInf, l = 0.f;
  __syncthreads();

  for (int pi = 0; pi < n_pages; ++pi) {
    const size_t base = static_cast<size_t>(row[pi]) * page;
    const int nvalid = min(page, len - pi * page);
    // scores of this page's valid positions
    for (int p = warp; p < nvalid; p += nwarps) {
      const TKV* kr = kp + ((base + p) * H + h) * D;
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += sq[d] * pt::to_f(kr[d]);
      part = pt::warp_sum(part);
      if (QUANT) part *= ks[(base + p) * H + h] / 127.f;
      if (lane == 0) sp[p] = part * scale;
    }
    __syncthreads();
    float pmax = pt::kNegInf;
    for (int p = 0; p < nvalid; ++p) pmax = fmaxf(pmax, sp[p]);
    const float m_new = fmaxf(m, pmax);
    const float alpha = expf(m - m_new);
    __syncthreads();  // every thread has read the scores
    for (int p = tid; p < nvalid; p += kThreads)
      sp[p] = expf(sp[p] - m_new);
    __syncthreads();
    float psum = 0.f;
    for (int p = 0; p < nvalid; ++p) psum += sp[p];
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < kMaxDPerThread; ++i) {
      const int d = tid + i * kThreads;
      if (d < D) {
        float a = acc[i] * alpha;
        const TKV* vr = vp + (base * H + h) * D + d;
        const size_t vstride = static_cast<size_t>(H) * D;
#pragma unroll 8
        for (int p = 0; p < nvalid; ++p) {
          float v = pt::to_f(vr[p * vstride]);
          if (QUANT) v *= vs[(base + p) * H + h] / 127.f;
          a += sp[p] * v;
        }
        acc[i] = a;
      }
    }
    m = m_new;
    __syncthreads();  // sp is rewritten by the next page
  }
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kMaxDPerThread; ++i) {
    const int d = tid + i * kThreads;
    if (d < D)
      out[(static_cast<size_t>(b) * H + h) * D + d] =
          pt::from_f<TQ>(acc[i] / den);
  }
}

template <typename TQ, typename TKV, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* table, const void* lens, void* out,
           int B, int H, int D, int page, int max_pages, float scale,
           cudaStream_t stream) {
  const dim3 grid(B, H);
  const size_t smem = static_cast<size_t>(D + page) * sizeof(float);
  paged_decode_kernel<TQ, TKV, QUANT><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<TQ*>(out), H, D, page,
      max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int dispatch_kv(const void* q, const void* kp, const void* vp,
                const void* ks, const void* vs, const void* table,
                const void* lens, void* out, int B, int H, int D, int page,
                int max_pages, int kv_dtype, float scale,
                cudaStream_t stream) {
  switch (kv_dtype) {
    case pt::kF32:
      return launch<TQ, float, false>(q, kp, vp, ks, vs, table, lens, out,
                                      B, H, D, page, max_pages, scale,
                                      stream);
    case pt::kBF16:
      return launch<TQ, __nv_bfloat16, false>(q, kp, vp, ks, vs, table,
                                              lens, out, B, H, D, page,
                                              max_pages, scale, stream);
    case pt::kI8:
      return launch<TQ, int8_t, true>(q, kp, vp, ks, vs, table, lens, out,
                                      B, H, D, page, max_pages, scale,
                                      stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int pt_paged_decode(const void* q, const void* k_pages,
                               const void* v_pages, const void* k_scale,
                               const void* v_scale, const void* page_table,
                               const void* seq_lens, void* out, int B, int H,
                               int D, int page, int max_pages, int q_dtype,
                               int kv_dtype, float scale, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (D > kThreads * kMaxDPerThread) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == pt::kF32)
    return dispatch_kv<float>(q, k_pages, v_pages, k_scale, v_scale,
                              page_table, seq_lens, out, B, H, D, page,
                              max_pages, kv_dtype, scale, st);
  if (q_dtype == pt::kBF16)
    return dispatch_kv<__nv_bfloat16>(q, k_pages, v_pages, k_scale, v_scale,
                                      page_table, seq_lens, out, B, H, D,
                                      page, max_pages, kv_dtype, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
