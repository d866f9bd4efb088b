// int8 execution: the quantized linear and the quantized NCHW convolution
// (csrc counterparts of paddle_tpu/quantization/quant.py Int8Linear and
// Int8Conv2D, :217-316). No TPU kernel is replaced: the JAX package runs
// both as XLA dot_general / conv_general_dilated with int32 accumulation
// on the MXU. PyTorch has no int8 convolution with int32 accumulation on
// CUDA, and torch._int_mm covers only the linear's product, leaving the
// activation quantization and the dequantizing epilogue as eager passes;
// so both are written here.
//
// Each call is two launches:
//   1. int8_quantize_kernel: qx = clip(rint(x / s * 127), -127, 127) with
//      s = max(act_scale, 1e-8), true division and half-to-even rounding,
//      one pass over x (fp32 or bf16, promoted to fp32 as jnp does);
//   2. the product on int8 mma.sync (m16n8k32, s8 x s8 -> s32) with the
//      dequantizing epilogue fused:
//        out = float(acc) * ((act_scale / 127) * (w_scale / 127)) + bias
//      in that order, each step rounded once (__fmul_rn / __fadd_rn: the
//      compiler may not contract them into an fma), so the fp32 output is
//      bit for bit the plain version's.
// The linear is a GEMM over [M, K] x [K, N]; the weight [K, N] is
// transposed into shared memory as it is loaded. The convolution is an
// implicit GEMM per group: rows N*OH*OW, columns M/groups, depth
// C/groups*kh*kw, the im2col gather made while the A tile is loaded.
// Convolutions with at most kDirectCols output channels a group (LeNet's
// first, MobileNet's depthwise layers) take a direct kernel instead: a
// thread an output, the same integer sum.
//
// Bound: the products at 1979 TOPS int8 for the large layers, the bytes of
// x and out (fp32) for the small ones. This first version keeps one
// 64x64x64 tile in shared memory with no pipelining (a later PR moves it
// to wgmma and TMA).
#include "common.cuh"

namespace pt {
namespace {

constexpr int kBM = 64, kBN = 64, kBK = 64, kLds = kBK + 16;
constexpr int kThreads = 128;
constexpr int kDirectCols = 8;

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__global__ void int8_quantize_kernel(const T* __restrict__ x,
                                     int8_t* __restrict__ q, long long n,
                                     const float* __restrict__ act_scale) {
  const float s = fmaxf(*act_scale, 1e-8f);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += stride) {
    float v = rintf(__fmul_rn(__fdiv_rn(to_f(x[i]), s), 127.0f));
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    q[i] = static_cast<int8_t>(static_cast<int>(v));
  }
}

struct Shape {
  int rows, cols, depth;  // GEMM M, N (a group's), K
  int total_cols;         // the output's channels (conv) or N (linear)
  // convolution only
  int C, H, W, kh, kw, OH, OW, sh, sw, ph, pw, dh, dw, cg;
};

__device__ __forceinline__ float dequant(int acc, float scale) {
  return __fmul_rn(__int2float_rn(acc), scale);
}

// the epilogue's scale of output column col: (act_scale / 127) *
// (w_scale / 127), w_scale per column or one for the tensor
__device__ __forceinline__ float col_scale(const float* w_scale,
                                           bool per_col, int col,
                                           float a127) {
  return __fmul_rn(a127, __fdiv_rn(w_scale[per_col ? col : 0], 127.0f));
}

// One block: a kBM x kBN tile of the group blockIdx.z's output, its rows
// on blockIdx.x (up to 2^31 - 1 tiles: a convolution's rows are
// N * OH * OW) and its columns on blockIdx.y; four warps, each 32 x 32
// (2 x 4 mma tiles of 16 x 8).
template <bool CONV>
__global__ void __launch_bounds__(kThreads)
    int8_gemm_kernel(const int8_t* __restrict__ qa,
                     const int8_t* __restrict__ wq,
                     const float* __restrict__ w_scale,
                     const float* __restrict__ act_scale,
                     const float* __restrict__ bias, float* __restrict__ out,
                     Shape s, int has_bias) {
  __shared__ __align__(16) int8_t As[kBM * kLds];
  __shared__ __align__(16) int8_t Bs[kBN * kLds];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int grp = blockIdx.z;
  const int K = s.depth;

  // Loads: neighbouring threads on neighbouring addresses. The linear's
  // A [M, K] runs along k and its B [K, N] along n; the convolution's
  // gathered A runs along the output pixels and its B [cols][K] along k.
  // kThreads is twice kBM = kBN = kBK, so each thread keeps one index
  // fixed and takes every other value of the other.
  const int fixed = tid % 64, step0 = tid / 64;
  const int khw = s.kh * s.kw;
  // convolution: the thread's A row (output pixel), its image and origin
  const int arow = m0 + fixed;
  const bool arow_ok = CONV && arow < s.rows;
  long long abase = 0;
  int ih0 = 0, iw0 = 0;
  if (arow_ok) {
    const int plane = s.OH * s.OW;
    const int n = arow / plane, p = arow - n * plane;
    const int oh = p / s.OW, ow = p - oh * s.OW;
    abase = (static_cast<long long>(n) * s.C + grp * s.cg) *
            static_cast<long long>(s.H) * s.W;
    ih0 = oh * s.sh - s.ph;
    iw0 = ow * s.sw - s.pw;
  }

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll 4
    for (int i = 0; i < 32; ++i) {
      const int other = step0 + 2 * i;
      int8_t va = 0, vb = 0;
      if (CONV) {
        // A: row `fixed`, k `other`; B: column `other`, k `fixed`
        const int k = k0 + other;
        if (arow_ok && k < K) {
          const int c = k / khw, rem = k - c * khw;
          const int ky = rem / s.kw, kx = rem - ky * s.kw;
          const int ih = ih0 + ky * s.dh, iw = iw0 + kx * s.dw;
          if (ih >= 0 && ih < s.H && iw >= 0 && iw < s.W)
            va = qa[abase + (static_cast<long long>(c) * s.H + ih) * s.W +
                    iw];
        }
        As[fixed * kLds + other] = va;
        const int col = n0 + other, kb = k0 + fixed;
        if (col < s.cols && kb < K)
          vb = wq[(static_cast<long long>(grp) * s.cols + col) * K + kb];
        Bs[other * kLds + fixed] = vb;
      } else {
        // A: row `other`, k `fixed`; B: k `other`, column `fixed`
        const int row = m0 + other, k = k0 + fixed;
        if (row < s.rows && k < K)
          va = qa[static_cast<long long>(row) * K + k];
        As[other * kLds + fixed] = va;
        const int col = n0 + fixed, kb = k0 + other;
        if (col < s.cols && kb < K)
          vb = wq[static_cast<long long>(kb) * s.cols + col];
        Bs[fixed * kLds + other] = vb;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = As + (wm + mi * 16 + g) * kLds + ks + 4 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = Bs + (wn + ni * 8 + g) * kLds + ks + 4 * t;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  const float a127 = __fdiv_rn(*act_scale, 127.0f);
  const int plane = CONV ? s.OH * s.OW : 1;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn + ni * 8 + 2 * t + e;
      if (col >= s.cols) continue;
      const int ocol = grp * s.cols + col;  // the output channel
      const float sc = col_scale(w_scale, !CONV, ocol, a127);
      const float bv = has_bias ? bias[ocol] : 0.0f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm + mi * 16 + g + 8 * h;
          if (row >= s.rows) continue;
          float v = dequant(acc[mi][ni][2 * h + e], sc);
          if (has_bias) v = __fadd_rn(v, bv);
          long long o;
          if (CONV) {
            const int n = row / plane, p = row - n * plane;
            o = (static_cast<long long>(n) * s.total_cols + ocol) * plane + p;
          } else {
            o = static_cast<long long>(row) * s.total_cols + ocol;
          }
          out[o] = v;
        }
      }
    }
  }
}

// A thread an output of a convolution with few channels a group.
__global__ void int8_conv_direct_kernel(const int8_t* __restrict__ qa,
                                        const int8_t* __restrict__ wq,
                                        const float* __restrict__ w_scale,
                                        const float* __restrict__ act_scale,
                                        const float* __restrict__ bias,
                                        float* __restrict__ out, Shape s,
                                        int batch, int has_bias) {
  const long long total = static_cast<long long>(batch) * s.total_cols *
                          s.OH * s.OW;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= total) return;
  const int ow = static_cast<int>(i % s.OW);
  long long r = i / s.OW;
  const int oh = static_cast<int>(r % s.OH);
  r /= s.OH;
  const int m = static_cast<int>(r % s.total_cols);
  const int n = static_cast<int>(r / s.total_cols);
  const int grp = m / s.cols;
  const int8_t* x = qa + (static_cast<long long>(n) * s.C + grp * s.cg) *
                             static_cast<long long>(s.H) * s.W;
  const int8_t* w = wq + static_cast<long long>(m) * s.cg * s.kh * s.kw;
  int acc = 0;
  for (int c = 0; c < s.cg; ++c) {
    for (int ky = 0; ky < s.kh; ++ky) {
      const int ih = oh * s.sh - s.ph + ky * s.dh;
      if (ih < 0 || ih >= s.H) continue;
      for (int kx = 0; kx < s.kw; ++kx) {
        const int iw = ow * s.sw - s.pw + kx * s.dw;
        if (iw < 0 || iw >= s.W) continue;
        acc += static_cast<int>(x[(static_cast<long long>(c) * s.H + ih) *
                                     s.W + iw]) *
               static_cast<int>(w[(c * s.kh + ky) * s.kw + kx]);
      }
    }
  }
  const float a127 = __fdiv_rn(*act_scale, 127.0f);
  float v = dequant(acc, col_scale(w_scale, false, m, a127));
  if (has_bias) v = __fadd_rn(v, bias[m]);
  out[i] = v;
}

cudaError_t quantize(const void* x, int8_t* q, long long n, int x_dtype,
                     const float* act_scale, cudaStream_t st) {
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65535 * 8 ? want : 65535 * 8);
  if (x_dtype == kBF16)
    int8_quantize_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), q, n, act_scale);
  else
    int8_quantize_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const float*>(x), q, n, act_scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pt

extern "C" {

// x [M, K] (fp32 or bf16) -> out [M, N] fp32; qx is an int8 [M, K]
// workspace; w_scale [N]; act_scale and the bias fp32
int pt_int8_linear(const void* x, void* qx, const void* wq,
                   const void* w_scale, const void* act_scale,
                   const void* bias, void* out, int M, int K, int N,
                   int x_dtype, int has_bias, void* stream) {
  using namespace pt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = quantize(x, static_cast<int8_t*>(qx),
                             static_cast<long long>(M) * K, x_dtype,
                             static_cast<const float*>(act_scale), st);
  if (err != cudaSuccess || M == 0 || N == 0) return err;
  Shape s{};
  s.rows = M;
  s.cols = N;
  s.depth = K;
  s.total_cols = N;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, 1);
  int8_gemm_kernel<false><<<grid, kThreads, 0, st>>>(
      static_cast<const int8_t*>(qx), static_cast<const int8_t*>(wq),
      static_cast<const float*>(w_scale),
      static_cast<const float*>(act_scale),
      static_cast<const float*>(bias), static_cast<float*>(out), s,
      has_bias);
  return cudaGetLastError();
}

// x [B, C, H, W] (fp32 or bf16) -> out [B, M, OH, OW] fp32; qx an int8
// workspace of x's size; wq [M, C/groups, kh, kw]; w_scale and act_scale
// one fp32 each; pads are the top and left ones (the bottom and right
// ones are implied by OH and OW)
int pt_int8_conv2d(const void* x, void* qx, const void* wq,
                   const void* w_scale, const void* act_scale,
                   const void* bias, void* out, int B, int C, int H, int W,
                   int M, int kh, int kw, int OH, int OW, int sh, int sw,
                   int ph, int pw, int dh, int dw, int groups, int x_dtype,
                   int has_bias, void* stream) {
  using namespace pt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = quantize(
      x, static_cast<int8_t*>(qx),
      static_cast<long long>(B) * C * H * W, x_dtype,
      static_cast<const float*>(act_scale), st);
  const long long rows = static_cast<long long>(B) * OH * OW;
  if (err != cudaSuccess || rows == 0 || M == 0) return err;
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  Shape s{};
  s.rows = static_cast<int>(rows);
  s.cols = M / groups;
  s.cg = C / groups;
  s.depth = s.cg * kh * kw;
  s.total_cols = M;
  s.C = C; s.H = H; s.W = W; s.kh = kh; s.kw = kw; s.OH = OH; s.OW = OW;
  s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw; s.dh = dh; s.dw = dw;
  const int8_t* q = static_cast<const int8_t*>(qx);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* ws = static_cast<const float*>(w_scale);
  const float* as = static_cast<const float*>(act_scale);
  const float* bs = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (s.cols <= kDirectCols) {
    const long long total = rows * M;
    const int threads = 256;
    int8_conv_direct_kernel<<<static_cast<unsigned>((total + threads - 1) /
                                                    threads),
                              threads, 0, st>>>(q, w, ws, as, bs, o, s, B,
                                                has_bias);
  } else {
    dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM),
              (s.cols + kBN - 1) / kBN, groups);
    int8_gemm_kernel<true><<<grid, kThreads, 0, st>>>(q, w, ws, as, bs, o, s,
                                                      has_bias);
  }
  return cudaGetLastError();
}

}  // extern "C"
