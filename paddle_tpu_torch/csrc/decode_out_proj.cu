// decode_out_proj: the attention block's output projection after a
// decode step, out[b, n] = ctx[b, :] @ W[:, n] + bias[n] with f32
// accumulation, rounded once to ctx's dtype (ctx already rounded to the
// output dtype by paged_decode).
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
// What bounds it on the H100: bytes. At decode batch sizes (B <= 64)
// the product reads W once (K*N values) for 2*B flops per value, far
// below the ~20 flops per byte where the TF32 tensor cores would start
// to matter, so the bound is the bytes of ctx, W, bias and out at
// 3.35 TB/s (5.05 us at B=8, E=2048, fp32).
//
// Design: one pass over W at the card's bandwidth, in one launch.
// - Split K as well as N. A block owns a [kper, 8 * kVec] slice of W
//   (kVec = 16 bytes of W: 4 fp32 or 8 bf16 columns); kper and the split
//   count come from the wrapper (decode_out_proj_split in
//   ops/kernels/paged_attention.py, whose OUT_PROJ_* constants mirror the
//   tile constants below), which sizes the grid to one wave of the card
//   (256 blocks at N=2048 with fp32 W on 132 SMs, two per SM; 128 with
//   bf16 W).
// - Each thread loads its W rows of a pass (up to 16; a pass is the 512
//   rows the block's 32 row threads hold) as 16-byte vectors, all in
//   flight together, into registers before it computes anything: 256
//   bytes a thread. Lanes 0-7 of a warp read one 128-byte row segment,
//   lanes 8-31 the next three rows.
// - W is read once per launch at any B when kper <= 512 (E <= 4096): the
//   block loops over chunks of kRB batch rows (8 with fp32 W, 4 with bf16
//   W) against the W values held in registers. Each chunk's K slice of
//   ctx is staged once in shared memory, transposed ([k][row]), and
//   shared by all the block's columns: a thread reads the chunk's rows of
//   one k as 16-byte vectors (one shared load per 4 rows, not one per
//   row). The partial sums of up to 64 rows stay in shared memory for one
//   exchange across the cluster.
// - Wider contractions (kper > 512) take several passes of 512 rows per
//   group of 64 batch rows, each pass adding to the partial sums in
//   order: W is still read once for B <= 64, and once per group above.
//   They are a separate instantiation (kPasses), so the one-pass kernel
//   keeps its W rows hoisted in registers without spilling.
// - Deterministic split-K in one launch: the blocks of one column slice
//   form a thread-block cluster along K (at most 8, the portable size).
//   Inside a warp the 4 row threads of a column group reduce-scatter
//   their sums over lane bits 4 and 3 (each keeps a quarter: 24 shuffles,
//   against 64 for an all-reduce); the 8 warps then meet in shared memory
//   in order; then every block of the cluster reads all the blocks'
//   partial sums through distributed shared memory, in split order, for
//   its share of the outputs, adds the bias once and rounds. No atomics,
//   no workspace.
// Left for later: a chunk issues more staging, reduction and barrier
// instructions than FMAs, so at B=64 (8 chunks) the launch takes a few
// times the one-chunk time; a chunk of more rows needs W out of
// registers (shared memory, TMA bulk copies), and the next chunk's ctx
// could load while one computes. With bf16 W the 16 W rows and the
// unpacked values do not fit the 128 registers two blocks per SM would
// leave, so that instantiation runs one block per SM.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 8;                       // lanes along N
constexpr int kRowThreads = kThreads / kColThreads;  // 32 along K
constexpr int kRows = 16;    // W rows a thread holds
constexpr int kWarps = kThreads / 32;
constexpr int kPass = kRowThreads * kRows;  // W rows a block holds: 512
constexpr int kMaxSplits = 8;                        // portable cluster
constexpr int kGroup = 64;   // batch rows per exchange across the cluster

// this thread's W rows kp + ky + 32 i of one pass, all loads in flight
template <typename TW>
__device__ __forceinline__ void load_w(uint4 (&wv)[kRows],
                                       const TW* __restrict__ w, int kp,
                                       int kp1, int ky, int n0, int N) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kk = kp + ky + kRowThreads * i;
    wv[i] = (kk < kp1 && n0 < N)
                ? __ldg(reinterpret_cast<const uint4*>(
                      w + static_cast<size_t>(kk) * N + n0))
                : make_uint4(0u, 0u, 0u, 0u);
  }
}

// 16 bytes of W as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename TA, typename TW, bool kPasses>
__global__ void __launch_bounds__(kThreads, sizeof(TW) == 4 ? 2 : 1)
    out_proj_kernel(const TA* __restrict__ ctx, const TW* __restrict__ w,
                    const TW* __restrict__ bias, TA* __restrict__ out,
                    int B, int K, int N, int kper, int has_bias) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(TW));
  constexpr int kNT = kColThreads * kVec;  // columns per block
  constexpr int kRB = 32 / kVec;           // batch rows per chunk
  constexpr int kAcc = kRB * kVec;         // sums a thread keeps
  constexpr int kRedLD = kNT + 4;          // padded row of red
  // ctx chunk of this K slice, transposed: a thread reads the kRB rows
  // of one k as 16-byte vectors
  __shared__ __align__(16) float cs[kPass][kRB];
  __shared__ __align__(16) float red[kWarps][kRB * kRedLD];
  __shared__ float part[kGroup * kNT];     // this block's partial sums

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(gridDim.y);  // the cluster's size
  const int split = static_cast<int>(blockIdx.y);  // its rank in it
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cx = lane & 7;                // column group
  const int ky = warp * 4 + (lane >> 3);  // row thread, 0..31
  const int n0 = blockIdx.x * kNT + cx * kVec;
  const int k0 = split * kper, k1 = min(K, k0 + kper);

  const int npass = kPasses ? (k1 - k0 + kPass - 1) / kPass : 1;

  // one pass: its W rows stay in registers across every group
  uint4 wv[kRows];
  if (!kPasses) load_w(wv, w, k0, k1, ky, n0, N);

  // the lanes that share a column group: lane bits 3 and 4
  const bool up16 = lane & 16, up8 = lane & 8;
  const int base = (up16 ? kAcc / 2 : 0) + (up8 ? kAcc / 4 : 0);
  for (int g0 = 0; g0 < B; g0 += kGroup) {
    const int ng = min(kGroup, B - g0);
    for (int p = 0; p < npass; ++p) {
      const int kp = k0 + p * kPass, kp1 = kPasses ? min(k1, kp + kPass) : k1;
      if (kPasses) load_w(wv, w, kp, kp1, ky, n0, N);
      for (int b0 = g0; b0 < g0 + ng; b0 += kRB) {
        const int nb = min(kRB, g0 + ng - b0);
        __syncthreads();  // the previous chunk's cs and red are consumed
        // four rows of one k per thread: coalesced reads along k, one
        // 16-byte store
#pragma unroll
        for (int it = 0; it < kRB * kPass / (4 * kThreads); ++it) {
          const int i = tid + it * kThreads;
          const int c = i % kPass, r0 = 4 * (i / kPass);
          float x[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const size_t at = static_cast<size_t>(b0 + r0 + j) * K + kp + c;
            x[j] = (r0 + j < nb && kp + c < kp1) ? pt::to_f(ctx[at]) : 0.f;
          }
          *reinterpret_cast<float4*>(&cs[c][r0]) =
              make_float4(x[0], x[1], x[2], x[3]);
        }
        __syncthreads();

        float acc[kAcc];  // (row r, column v) at r * kVec + v
#pragma unroll
        for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float wf[kVec];
          unpack(wv[i], wf);
          const float* crow = cs[ky + kRowThreads * i];
#pragma unroll
          for (int r4 = 0; r4 < kRB; r4 += 4) {
            const float4 c4 = *reinterpret_cast<const float4*>(crow + r4);
            const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int v = 0; v < kVec; ++v)
                acc[(r4 + j) * kVec + v] += cv[j] * wf[v];
          }
        }
        // the 4 row threads of a column group in the warp, reduce-scatter:
        // over lane bit 4 each lane keeps half of the sums, over bit 3 a
        // quarter (a fixed order, so the same bits on every launch)
        float h1[kAcc / 2];
#pragma unroll
        for (int j = 0; j < kAcc / 2; ++j) {
          const float lo = acc[j], hi = acc[j + kAcc / 2];
          h1[j] = (up16 ? hi : lo) +
                  __shfl_xor_sync(0xffffffffu, up16 ? lo : hi, 16);
        }
        float h2[kAcc / 4];
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j) {
          const float lo = h1[j], hi = h1[j + kAcc / 4];
          h2[j] = (up8 ? hi : lo) +
                  __shfl_xor_sync(0xffffffffu, up8 ? lo : hi, 8);
        }
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j) {
          const int a = base + j, r = a / kVec, v = a - r * kVec;
          red[warp][r * kRedLD + cx * kVec + v] = h2[j];
        }
        __syncthreads();
        // the 8 warps in order
        for (int i = tid; i < kRB * kNT; i += kThreads) {
          const int r = i / kNT, c = i - r * kNT;
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < kWarps; ++j) s += red[j][r * kRedLD + c];
          float& dst = part[(b0 - g0) * kNT + i];  // passes in order
          dst = kPasses && p > 0 ? dst + s : s;
        }
      }
    }
    cluster.sync();  // every split's partial sums of the group are in
    // the splits in order; each output by one thread of the cluster
    for (int i = split * kThreads + tid; i < ng * kNT;
         i += splits * kThreads) {
      const int r = i / kNT, c = i - r * kNT;
      const int n = blockIdx.x * kNT + c;
      if (n >= N) continue;
      float s = 0.f;
      for (int j = 0; j < splits; ++j)
        s += cluster.map_shared_rank(part, j)[i];
      if (has_bias) s += pt::to_f(bias[n]);
      out[static_cast<size_t>(g0 + r) * N + n] = pt::from_f<TA>(s);
    }
    cluster.sync();  // the partial sums are read before the next group
  }
}

template <typename TA, typename TW>
int launch(const void* ctx, const void* w, const void* bias, void* out,
           int B, int K, int N, int has_bias, int splits, int kper,
           cudaStream_t stream) {
  constexpr int kNT = kColThreads * 16 / static_cast<int>(sizeof(TW));
  if (kper <= 0 || splits <= 0 || splits > kMaxSplits ||
      static_cast<long long>(splits) * kper < K ||
      (K > 0 && static_cast<long long>(splits - 1) * kper >= K))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kNT - 1) / kNT, splits, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kper > kPass ? out_proj_kernel<TA, TW, true>
                         : out_proj_kernel<TA, TW, false>,
      static_cast<const TA*>(ctx), static_cast<const TW*>(w),
      static_cast<const TW*>(bias), static_cast<TA*>(out), B, K, N, kper,
      has_bias);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pt_decode_out_proj(const void* ctx, const void* w,
                                  const void* bias, void* out, int B, int K,
                                  int N, int act_dtype, int w_dtype,
                                  int has_bias, int splits, int kper,
                                  void* stream) {
  if (B == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act_dtype == pt::kF32 && w_dtype == pt::kF32)
    return launch<float, float>(ctx, w, bias, out, B, K, N, has_bias,
                                splits, kper, st);
  if (act_dtype == pt::kF32 && w_dtype == pt::kBF16)
    return launch<float, __nv_bfloat16>(ctx, w, bias, out, B, K, N,
                                        has_bias, splits, kper, st);
  if (act_dtype == pt::kBF16 && w_dtype == pt::kF32)
    return launch<__nv_bfloat16, float>(ctx, w, bias, out, B, K, N,
                                        has_bias, splits, kper, st);
  if (act_dtype == pt::kBF16 && w_dtype == pt::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(ctx, w, bias, out, B, K, N,
                                                has_bias, splits, kper, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
