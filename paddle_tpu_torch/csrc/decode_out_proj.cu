// decode_out_proj: the attention block's output projection after a
// decode step, out[b, n] = ctx[b, :] @ W[:, n] + bias[n] with f32
// accumulation (ctx already rounded to the output dtype by
// paged_decode).
//
// Replaces the epilogue half of the TPU kernel
// paged_attention._decode_fused_kernel
// (paddle_tpu/ops/pallas/paged_attention.py:180-193). The TPU kept W
// resident in VMEM across a sequential grid over sequences, so one HBM
// read of W served every sequence. On Hopper blocks run in parallel,
// and fusing the product into each sequence's attention block would
// re-read W (16 MB in fp32 at E=2048) once per sequence; it is
// therefore a separate launch right after paged_decode, inside one
// paged_attention_fused call.
//
// What bounds it on the H100: bytes. At decode batch sizes the product
// is [B, E] x [E, E_out] with B <= 64: W is read once (E*E_out values)
// for 2*B flops per value. The design reads W exactly once per batch
// chunk of 8 rows: a block owns 32 output columns (one coalesced
// 128-byte row segment per warp) and splits the contraction over 8
// thread rows, whose partial sums meet in shared memory. The ctx
// values are the same for all 32 threads of a warp (broadcast loads).
// Limit of this design: batch chunks sit on blockIdx.y, so W is read
// ceil(B/8) times in all; with more than 8 slots the kernel moves that
// many times the bound's bytes.
#include "common.cuh"

namespace {

constexpr int kCols = 32;   // output columns per block
constexpr int kSlices = 8;  // contraction slices per block
constexpr int kRows = 8;    // batch rows per block

template <typename TA, typename TW>
__global__ void __launch_bounds__(kCols* kSlices)
    out_proj_kernel(const TA* __restrict__ ctx, const TW* __restrict__ w,
                    const TW* __restrict__ bias, TA* __restrict__ out,
                    int B, int K, int N, int has_bias) {
  __shared__ float red[kSlices][kRows][kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n = blockIdx.x * kCols + tx;
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  const int kper = (K + kSlices - 1) / kSlices;
  const int k0 = ty * kper, k1 = min(K, k0 + kper);
  if (n < N) {
    const TA* c0 = ctx + static_cast<size_t>(b0) * K;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float wv = pt::to_f(w[static_cast<size_t>(k) * N + n]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (i < nb) acc[i] += pt::to_f(c0[static_cast<size_t>(i) * K + k]) * wv;
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) red[ty][i][tx] = acc[i];
  __syncthreads();
  if (ty == 0 && n < N) {
    const float bv = has_bias ? pt::to_f(bias[n]) : 0.f;
    for (int i = 0; i < nb; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kSlices; ++j) s += red[j][i][tx];
      out[static_cast<size_t>(b0 + i) * N + n] = pt::from_f<TA>(s + bv);
    }
  }
}

template <typename TA, typename TW>
int launch(const void* ctx, const void* w, const void* bias, void* out,
           int B, int K, int N, int has_bias, cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols, (B + kRows - 1) / kRows);
  const dim3 block(kCols, kSlices);
  out_proj_kernel<TA, TW><<<grid, block, 0, stream>>>(
      static_cast<const TA*>(ctx), static_cast<const TW*>(w),
      static_cast<const TW*>(bias), static_cast<TA*>(out), B, K, N,
      has_bias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pt_decode_out_proj(const void* ctx, const void* w,
                                  const void* bias, void* out, int B, int K,
                                  int N, int act_dtype, int w_dtype,
                                  int has_bias, void* stream) {
  if (B == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act_dtype == pt::kF32 && w_dtype == pt::kF32)
    return launch<float, float>(ctx, w, bias, out, B, K, N, has_bias, st);
  if (act_dtype == pt::kF32 && w_dtype == pt::kBF16)
    return launch<float, __nv_bfloat16>(ctx, w, bias, out, B, K, N,
                                        has_bias, st);
  if (act_dtype == pt::kBF16 && w_dtype == pt::kF32)
    return launch<__nv_bfloat16, float>(ctx, w, bias, out, B, K, N,
                                        has_bias, st);
  if (act_dtype == pt::kBF16 && w_dtype == pt::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(ctx, w, bias, out, B, K, N,
                                                has_bias, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
