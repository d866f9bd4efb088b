// fused_bottleneck: a ResNet stride-1 identity bottleneck block in eval
// mode, BN folded into the weights, in one launch:
//
//   y1  = relu(x @ w1 + b1)                    1x1 conv, [HW, C] -> [HW, M]
//   y2  = relu(im2col3x3(y1) @ w2 + b2)        3x3 conv, pad 1
//   out = relu(y2 @ w3 + b3 + x)               1x1 conv + residual
//
// on NHWC x [N, H, W, C] with w1 [C, M], w2 [9M, M] (taps ky-major, then
// input channel), w3 [M, C] in x's storage type and f32 biases. Sums
// are f32; y1 and y2 are rounded to the storage type after their relu,
// and the output is written in it, where the TPU kernel rounds.
//
// Replaces the TPU kernel fused_conv_block._block_kernel
// (paddle_tpu/ops/pallas/fused_conv_block.py:70-114, launched at :143).
// That design held a whole image's [H*W, C] plane in VMEM (3.2 MB at
// ResNet-50 stage 1 in fp32) and built the 3x3 im2col from flat row
// shifts and masks. An H100 block has 227 KB of shared memory, so here
// one block owns a strip of TR output rows of one image:
//
// - conv1 computes y1 for the rows r0-1 .. r0+TR into shared memory
//   (the one-row halo on each side is recomputed by the neighbouring
//   strips; rows outside the image are zero, which is conv2's padding);
// - conv2 reads tap (dy, dx) of output (r, c) as y1[r+dy][c+dx] straight
//   from the 2-D tile, zero where c+dx leaves [0, W), into y2 in shared
//   memory;
// - conv3 adds b3 and the residual x read from global memory, applies
//   relu and writes the output.
//
// Each product is one loop over 64x64 output tiles: 256 threads, each
// with a 4x4 register tile; the A operand (x, the y1 taps, or y2) and
// the weights (read from global memory, which stays in L2: 1.2 MB at
// most in fp32) are staged in 16-deep shared-memory K chunks, read back
// as float4, 2 loads per 16 FMAs. Every output is one f32 FMA chain in
// K order: no atomics, the same bits on every run.
//
// What bounds it on the H100: fp32 FMA operations. At N=128 either
// ResNet-50 stage gives 2*N*HW*(2CM + 9M^2) = 5.59e10 flops, 0.834 ms
// at 67 TFLOP/s, against 0.245 ms (stage 1) of bytes. The recomputed
// halo adds 2/TR of conv1's work. This is the simple first design;
// bf16 wgmma, TMA and larger strips are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTP = 64;         // output positions per tile
constexpr int kTN = 64;         // output channels per tile
constexpr int kKC = 16;         // contraction depth of a staged chunk
constexpr int kAS = kTP + 4;    // row stride of the staged A chunk
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use
constexpr int kMinRows = 96;    // aim for >= 96 output positions a strip

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// floats of dynamic shared memory for a strip of tr rows
__host__ __device__ inline int smem_floats(int tr, int W, int M) {
  return round4((tr + 2) * W * M) + round4(tr * W * M) + kKC * kAS +
         kKC * kTN;
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return pt::to_f(pt::from_f<T>(v));
}

// C[p, n] = sum_k A[p, k] * B[k, n] over one kTP x kTN output tile at
// (p0, n0). A comes from load_a(p, k); B is row-major [K, Nn] in global
// memory. epi(p, n, acc) consumes every output inside [0, P) x [0, Nn).
template <typename T, typename LoadA, typename Epi>
__device__ __forceinline__ void gemm_tile(int p0, int n0, int P, int Nn,
                                          int K, const T* __restrict__ B,
                                          LoadA load_a, Epi epi, float* As,
                                          float* Bs) {
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int a_p = t / 4, a_k = (t % 4) * 4;
  const int b_k = t / 16, b_n = (t % 16) * 4;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    {
      const int p = p0 + a_p;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + a_k + j;
        As[(a_k + j) * kAS + a_p] = (p < P && k < K) ? load_a(p, k) : 0.f;
      }
    }
    {
      const int k = k0 + b_k;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + b_n + j;
        Bs[b_k * kTN + b_n + j] =
            (k < K && n < Nn) ? pt::to_f(B[static_cast<size_t>(k) * Nn + n])
                              : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(As + kk * kAS + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(Bs + kk * kTN + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Nn) epi(p, n, acc[i][j]);
    }
  }
}

template <typename T>
struct Args {
  const T* x;
  const T* w1;
  const float* b1;
  const T* w2;
  const float* b2;
  const T* w3;
  const float* b3;
  T* out;
  int H, W, C, M, TR;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bottleneck_kernel(const Args<T> a) {
  extern __shared__ float4 smem4[];
  float* y1 = reinterpret_cast<float*>(smem4);
  const int H = a.H, W = a.W, C = a.C, M = a.M;
  float* y2 = y1 + round4((a.TR + 2) * W * M);
  float* As = y2 + round4(a.TR * W * M);
  float* Bs = As + kKC * kAS;
  const int r0 = blockIdx.x * a.TR;
  const int rows = min(a.TR, H - r0);
  const size_t img = static_cast<size_t>(blockIdx.y) * H * W * C;
  const T* __restrict__ xi = a.x + img;
  T* __restrict__ oi = a.out + img;

  // conv1 over the strip and its halo: local row l is image row r0-1+l
  const int P1 = (rows + 2) * W;
  auto load_x = [&](int p, int k) -> float {
    const int r = r0 - 1 + p / W;
    if (r < 0 || r >= H) return 0.f;
    return pt::to_f(xi[(static_cast<size_t>(r) * W + p % W) * C + k]);
  };
  auto put_y1 = [&](int p, int n, float v) {
    const int r = r0 - 1 + p / W;
    y1[p * M + n] =
        (r < 0 || r >= H) ? 0.f : round_to<T>(fmaxf(v + a.b1[n], 0.f));
  };
  for (int p0 = 0; p0 < P1; p0 += kTP)
    for (int n0 = 0; n0 < M; n0 += kTN)
      gemm_tile<T>(p0, n0, P1, M, C, a.w1, load_x, put_y1, As, Bs);
  __syncthreads();

  // conv2: output (lr, c) reads y1 local row lr + ky, column c + kx - 1
  const int P2 = rows * W;
  auto load_tap = [&](int p, int k) -> float {
    const int tap = k / M, ci = k - tap * M;
    const int ky = tap / 3, c = p % W + tap % 3 - 1;
    if (c < 0 || c >= W) return 0.f;
    return y1[((p / W + ky) * W + c) * M + ci];
  };
  auto put_y2 = [&](int p, int n, float v) {
    y2[p * M + n] = round_to<T>(fmaxf(v + a.b2[n], 0.f));
  };
  for (int p0 = 0; p0 < P2; p0 += kTP)
    for (int n0 = 0; n0 < M; n0 += kTN)
      gemm_tile<T>(p0, n0, P2, M, 9 * M, a.w2, load_tap, put_y2, As, Bs);
  __syncthreads();

  // conv3 + b3 + residual, relu, out
  const size_t base = static_cast<size_t>(r0) * W * C;
  auto load_y2 = [&](int p, int k) -> float { return y2[p * M + k]; };
  auto put_out = [&](int p, int n, float v) {
    const size_t o = base + static_cast<size_t>(p) * C + n;
    oi[o] = pt::from_f<T>(fmaxf(v + a.b3[n] + pt::to_f(xi[o]), 0.f));
  };
  for (int p0 = 0; p0 < P2; p0 += kTP)
    for (int n0 = 0; n0 < C; n0 += kTN)
      gemm_tile<T>(p0, n0, P2, C, M, a.w3, load_y2, put_out, As, Bs);
}

// rows per strip: the fewest (a power of two, at most 8 and at most H)
// that give kMinRows output positions, halved while the strip's shared
// memory does not fit; 0 when not even one row fits
int strip_rows(int H, int W, int M) {
  int tr = 1;
  while (tr < 8 && tr * W < kMinRows) tr *= 2;
  if (tr > H) tr = H;
  while (tr > 1 && smem_floats(tr, W, M) * 4 > kMaxSmem) tr /= 2;
  return smem_floats(tr, W, M) * 4 > kMaxSmem ? 0 : tr;
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, void* out, int N,
           int H, int W, int C, int M, cudaStream_t stream) {
  const int tr = strip_rows(H, W, M);
  if (tr == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_floats(tr, W, M) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args<T> a{static_cast<const T*>(x),      static_cast<const T*>(w1),
            static_cast<const float*>(b1), static_cast<const T*>(w2),
            static_cast<const float*>(b2), static_cast<const T*>(w3),
            static_cast<const float*>(b3), static_cast<T*>(out),
            H, W, C, M, tr};
  const dim3 grid((H + tr - 1) / tr, N);
  bottleneck_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pt_fused_bottleneck(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, const void* w3,
                                   const void* b3, void* out, int N, int H,
                                   int W, int C, int M, int dtype,
                                   void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (C <= 0 || M <= 0 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32)
    return launch<float>(x, w1, b1, w2, b2, w3, b3, out, N, H, W, C, M, st);
  if (dtype == pt::kBF16)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, out, N, H, W, C,
                                 M, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
