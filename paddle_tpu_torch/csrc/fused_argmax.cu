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
// What bounds it on the H100: bytes. Every weight value is read once
// (V*D values, 412 MB in fp32 at GPT-1.3B) for 2*B flops each.
// Limit of this design: batch rows sit on blockIdx.y in chunks of 8,
// so W is read once per chunk, ceil(B/8) times in all. With more than
// 8 slots the kernel moves that many times the bound's bytes; looping
// over the batch chunks inside the block would read W once.
//
// Two launches, both counted as this kernel by the wrapper:
//  1. grid over vocab tiles of 32 entries (x) and batch chunks of 8
//     rows (y). The block stages its hidden rows in shared memory,
//     computes the [rows, 32] tile logits in f32 from its weight tile
//     (vocab-major: a warp per vocab row, lanes along D; feature-major:
//     32 columns x 8 contraction slices, lanes along V), adds the bias,
//     masks the ragged edge, and writes a per-tile (max, first index of
//     the max, first NaN index or -1).
//  2. one warp per batch row reduces the tiles IN TILE ORDER: each lane
//     folds a contiguous run of tiles, then an ordered shuffle tree
//     merges earlier with later runs. GPU blocks run in no order, so a
//     single pass with atomics would break the first-index and
//     first-NaN rules; the ordered merge keeps both.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 32;    // vocab entries per tile
constexpr int kRows = 8;     // batch rows per block
constexpr int kThreads = 256;

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

template <typename TH, typename TW, bool VOCAB_MAJOR>
__global__ void __launch_bounds__(kThreads)
    argmax_tiles_kernel(const TH* __restrict__ hidden,
                        const TW* __restrict__ w, const TW* __restrict__ bias,
                        float* __restrict__ tile_max,
                        int* __restrict__ tile_arg, int* __restrict__ tile_nan,
                        int B, int D, int V, int has_bias) {
  extern __shared__ float smem[];
  float* hs = smem;                       // [kRows, D]
  float* lg = smem + kRows * D;           // [kRows, kTile]
  float* red = lg + kRows * kTile;        // [8, kRows, kTile] (feature-major)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x;
  const int v0 = t * kTile;
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int i = idx / D, d = idx - i * D;
    hs[idx] = i < nb ? pt::to_f(hidden[static_cast<size_t>(b0 + i) * D + d])
                     : 0.f;
  }
  __syncthreads();

  if (VOCAB_MAJOR) {
    // warp w owns vocab rows v0 + w, v0 + w + 8, ... (4 rows each)
    for (int r = warp; r < kTile; r += kThreads / 32) {
      const int v = v0 + r;
      float part[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) part[i] = 0.f;
      if (v < V) {
        const TW* wr = w + static_cast<size_t>(v) * D;
        for (int d = lane; d < D; d += 32) {
          const float wv = pt::to_f(wr[d]);
#pragma unroll
          for (int i = 0; i < kRows; ++i) part[i] += hs[i * D + d] * wv;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float s = pt::warp_sum(part[i]);
        if (lane == 0) lg[i * kTile + r] = s;
      }
    }
  } else {
    // 32 columns (lane = column) x 8 contraction slices (warp = slice)
    const int v = v0 + lane;
    const int kper = (D + 7) / 8;
    const int d0 = warp * kper, d1 = min(D, d0 + kper);
    float part[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) part[i] = 0.f;
    if (v < V) {
#pragma unroll 4
      for (int d = d0; d < d1; ++d) {
        const float wv = pt::to_f(w[static_cast<size_t>(d) * V + v]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) part[i] += hs[i * D + d] * wv;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      red[(warp * kRows + i) * kTile + lane] = part[i];
    __syncthreads();
    for (int idx = tid; idx < kRows * kTile; idx += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += red[j * kRows * kTile + idx];
      lg[idx] = s;
    }
  }
  __syncthreads();

  // per-row tile reduction: warp i handles batch row i
  if (warp < nb) {
    const int v = v0 + lane;
    const bool valid = v < V;
    float x = lg[warp * kTile + lane];
    if (valid && has_bias) x += pt::to_f(bias[v]);
    if (!valid) x = pt::kNegInf;  // the ragged edge, masked as on the TPU
    const bool is_nan = isnan(x);
    const unsigned nan_mask = __ballot_sync(0xffffffffu, is_nan);
    const float mx = pt::warp_max(is_nan ? pt::kNegInf : x);
    const unsigned at_max =
        __ballot_sync(0xffffffffu, !is_nan && x == mx);
    if (lane == 0) {
      const size_t o = static_cast<size_t>(t) * B + b0 + warp;
      tile_max[o] = mx;
      tile_arg[o] = v0 + __ffs(at_max) - 1;
      tile_nan[o] = nan_mask ? v0 + __ffs(nan_mask) - 1 : -1;
    }
  }
}

__global__ void argmax_reduce_kernel(const float* __restrict__ tile_max,
                                     const int* __restrict__ tile_arg,
                                     const int* __restrict__ tile_nan,
                                     int* __restrict__ out, int B,
                                     int n_tiles) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const int per = (n_tiles + 31) / 32;
  const int t0 = lane * per, t1 = min(n_tiles, t0 + per);
  // the reference's carry starts at (-1e30, index 0): only a strictly
  // larger tile max (or a NaN) replaces it
  Best me{pt::kNegInf, 0, -1};
  bool empty = lane != 0;
  for (int t = t0; t < t1; ++t) {
    const size_t o = static_cast<size_t>(t) * B + b;
    const Best x{tile_max[o], tile_arg[o], tile_nan[o]};
    me = empty ? x : merge(me, x);
    empty = false;
  }
  // ordered tree: lane L merges with lane L + off (a later range)
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
  if (lane == 0) out[b] = me.nan >= 0 ? me.nan : me.i;
}

template <typename TH, typename TW>
int launch(const void* hidden, const void* w, const void* bias,
           float* tile_max, int* tile_arg, int* tile_nan, int* out, int B,
           int D, int V, int vocab_major, int has_bias, int n_tiles,
           cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kRows * D + kRows * kTile + 8 * kRows * kTile) *
      sizeof(float);
  const dim3 grid(n_tiles, (B + kRows - 1) / kRows);
  if (vocab_major) {
    cudaFuncSetAttribute(argmax_tiles_kernel<TH, TW, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    argmax_tiles_kernel<TH, TW, true><<<grid, kThreads, smem, stream>>>(
        static_cast<const TH*>(hidden), static_cast<const TW*>(w),
        static_cast<const TW*>(bias), tile_max, tile_arg, tile_nan, B, D, V,
        has_bias);
  } else {
    cudaFuncSetAttribute(argmax_tiles_kernel<TH, TW, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    argmax_tiles_kernel<TH, TW, false><<<grid, kThreads, smem, stream>>>(
        static_cast<const TH*>(hidden), static_cast<const TW*>(w),
        static_cast<const TW*>(bias), tile_max, tile_arg, tile_nan, B, D, V,
        has_bias);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  argmax_reduce_kernel<<<B, 32, 0, stream>>>(tile_max, tile_arg, tile_nan,
                                             out, B, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pt_argmax_tile_count(int V) { return (V + kTile - 1) / kTile; }

extern "C" int pt_fused_argmax(const void* hidden, const void* weight,
                               const void* bias, void* tile_max,
                               void* tile_arg, void* tile_nan, void* out,
                               int B, int D, int V, int vocab_major,
                               int h_dtype, int w_dtype, int has_bias,
                               int n_tiles, void* stream) {
  if (B == 0) return 0;
  if (n_tiles != pt_argmax_tile_count(V)) return cudaErrorInvalidValue;
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
