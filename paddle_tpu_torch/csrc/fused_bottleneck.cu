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
// and the output is written in it.
//
// Replaces the TPU kernel fused_conv_block._block_kernel
// (paddle_tpu/ops/pallas/fused_conv_block.py:70-114, launched at :143),
// which held a whole image's plane in fast memory. An H100 block has
// 227 KB of shared memory, so here one block owns a tile of TR rows by
// TC columns of one image (fused_bottleneck_config in
// ops/kernels/fused_conv_block.py chooses them and the shared bytes,
// and passes them in):
//
// - conv1 computes y1 for the tile and a one-position halo on all four
//   sides into shared memory, a (TR+2) x (TC+2) x M tile whose positions
//   outside the image are zero (conv2's padding). The halo is recomputed
//   by the neighbouring tiles.
// - conv2 is an implicit im2col: tap (ky, kx) of output (r, c) is y1
//   tile position (r+ky, c+kx), a constant offset per tap, with no mask
//   and no divide in the product loop. y2 goes to shared memory.
// - conv3: the residual x of a 64-channel pass comes into the output
//   stage by 16-byte cp.async with the pass's first weight chunk; each
//   sum then takes b3 and its residual, relu and the rounding in place,
//   and the stage goes out with 16-byte stores.
//
// What bounds it on the H100: operations in fp32, bytes in bf16. At
// N=128 either ResNet-50 stage (56x56 C=256 M=64, 28x28 C=512 M=128)
// gives 2*N*HW*(2CM + 9M^2) = 5.59e10 flops: as 3xTF32 (three TF32
// products each) 0.339 ms at 495 TFLOP/s, against 0.245 ms of bytes in
// fp32 at stage 1; in bf16 0.057 ms at 989 TFLOP/s against 0.123 ms of
// bytes. The recomputed halo adds (P1 - P) / P of conv1's work
// (P = TR*TC, P1 = (TR+2)*(TC+2)); the configuration reports it.
//
// Design:
// - All three products on the tensor cores with mma.sync (mma.cuh):
//   m16n8k8 3xTF32 for fp32 (hi/lo split of both operands, small terms
//   first), m16n8k16 bf16 with ldmatrix.trans for the weight fragments.
//   Each product is computed transposed, out^T[channel][position] =
//   W^T act^T: channels (multiples of 16) are the MMA's rows and
//   positions its 8-wide columns, so positions pad to 8, not 16 or 64.
// - fp32 sums: the tensor core truncates its accumulator toward zero on
//   every product it adds, and over conv2's 9M = 4608 deep sum (M=512)
//   that bias put the output 2.45e-4 off the plain f32 version
//   (chip_smoke.py, PERF.md). So kFreshK8 k8 steps of products go into
//   a fresh fragment, which is added to the sum in f32, rounded to
//   nearest: the error is then that of a plain f32 sum.
// - 8 warps: 2 along channels (32 each, a 64-channel pass) by 4 along
//   positions. A pass gives each position warp an equal share of its
//   8-position tiles (at most 4 a warp in conv1, kNT in conv2 and
//   conv3); the warp's tile count selects a compile-time instantiation,
//   so the product loops carry no branch. The per-thread row offsets of
//   the tiles are computed once a pass.
// - Staging: the weight K-chunks (32 deep, 64 channels) and conv1's x
//   chunks (128 positions) come in by 16-byte cp.async in a ring of
//   kStages buffers, one barrier a chunk; the weights stay in L2 (1.2 MB
//   at most in fp32 at the 224x224 shapes). Rows are padded by 16 bytes,
//   so the fragment loads are conflict-free (positions at a row wrap of
//   the im2col excepted).
// - Shared memory: y1 (storage type), later conv3's output stage; y2
//   (storage type), earlier conv1's x chunks; the weight chunks. bf16
//   keeps y1/y2 in bf16, which is exact (they are rounded there), takes
//   7 position tiles a warp and 32-bit shared addresses to fit 128
//   registers, and so runs two blocks an SM; fp32 runs one (about 255
//   registers).
// - No atomics: every output is one fixed-order sum, the same bits on
//   every run.
// Left for later: wgmma with TMA-fed tiles, splitting each staged weight
// chunk once per block instead of once per warp, and overlapping one
// tile's staging and epilogues with another's products at one block an
// SM (fp32), which without its products still takes about half its time.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPosWarps = 4;         // warps along positions
constexpr int kBC = 64;              // channels of a pass: 2 warps x 32
constexpr int kKC = 32;              // contraction depth of a staged chunk
constexpr int kStages = 3;           // staged chunks in the ring
// fp32: k8 steps whose 3xTF32 products a fresh fragment gathers before
// they are added to the sum in f32, rounded to nearest. The tensor core
// truncates its accumulator toward zero on every product it adds; over
// a 9M = 4608 deep sum that bias put the output 2.45e-4 off the plain
// f32 version on an H100 (PERF.md).
constexpr int kFreshK8 = 2;
constexpr int kNT1 = 4;              // 8-position tiles a warp, conv1
constexpr int kXP = kPosWarps * kNT1 * 8;  // positions of a conv1 pass
constexpr int kMaxSmem = 232448;     // 227 KB, the most a block may use

template <typename T>
struct Lay {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLDW = kBC + 8;      // staged weight rows
  static constexpr int kLDX = kKC + kVec;   // staged x rows
  static constexpr int kLDO = kBC + kVec;   // output stage rows
  // 8-position tiles a warp in conv2 and conv3 (bf16's accumulators must
  // leave room in 128 registers), and the positions of such a pass
  static constexpr int kNT = sizeof(T) == 2 ? 7 : 8;
  static constexpr int kOP = kPosWarps * kNT * 8;
};

__host__ __device__ inline long long align16(long long b) {
  return (b + 15) & ~15LL;
}

__host__ __device__ inline long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

__host__ __device__ inline long long lmin(long long a, long long b) {
  return a < b ? a : b;
}

// bytes of the three shared-memory regions of a TR x TC tile:
// r1 = y1 | conv3's output stage, r2 = y2 | conv1's x chunks,
// r3 = the weight chunks (ops/kernels/fused_conv_block.py repeats this)
struct Regions {
  long long r1, r2, r3;
  __host__ __device__ long long total() const { return r1 + r2 + r3; }
};

template <typename T>
__host__ __device__ inline Regions regions(int TR, int TC, int M) {
  const long long es = sizeof(T);
  const long long ld = M + Lay<T>::kVec;
  const long long p1 = static_cast<long long>(TR + 2) * (TC + 2);
  const long long p = static_cast<long long>(TR) * TC;
  const long long p8 = (p + 7) / 8 * 8;
  const long long xp = lmin((p1 + 31) / 32 * 32, kXP);
  Regions s;
  s.r1 = align16(lmax(p1 * ld, lmin(p8, Lay<T>::kOP) * Lay<T>::kLDO) * es);
  s.r2 = align16(lmax(p * ld * es, kStages * xp * Lay<T>::kLDX * es));
  s.r3 = static_cast<long long>(kStages) * kKC * Lay<T>::kLDW * es;
  return s;
}

// -- warp products --------------------------------------------------------

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t lds32(unsigned addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// acc[i][j] += sum over the chunk's K8 groups of 8 (kKC / 8, or nk8 when
// K8 is 0) of W[k][ch] act[pos][k]: i over the warp's two 16-channel
// tiles (ws at the warp's first channel of the staged chunk
// [kKC][kLDW]; channels past N are zero-filled), j over its CNT 8-position
// tiles, whose rows start at act + boff[j]. The counts are compile-time,
// so the loops carry no branch and the next tile's loads are scheduled
// ahead of this tile's products. fp32 by 3xTF32: the weight fragments of
// kFreshK8 steps are split once for all the warp's position tiles.
template <int CNT, int K8, int NT>
__device__ __forceinline__ void chunk_mma(float (&acc)[2][NT][4],
                                          const float* ws, const float* act,
                                          const int (&boff)[NT], int nk8,
                                          int lane) {
  constexpr int LDW = Lay<float>::kLDW;
  const int g = lane >> 2, t = lane & 3;
  const int n = K8 ? K8 : nk8;
#pragma unroll
  for (int k0 = 0; k0 < kKC / 8; k0 += kFreshK8) {
    if (k0 >= n) break;
    // A (16x8, channel x k) = W^T: (g, t) (g+8, t) (g, t+4) (g+8, t+4),
    // for the group's k8 steps
    uint32_t ah[kFreshK8][2][4], al[kFreshK8][2][4];
#pragma unroll
    for (int q = 0; q < kFreshK8; ++q) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* w = ws + ((k0 + q) * 8 + t) * LDW + i * 16 + g;
        pt::split(w[0], ah[q][i][0], al[q][i][0]);
        pt::split(w[8], ah[q][i][1], al[q][i][1]);
        pt::split(w[4 * LDW], ah[q][i][2], al[q][i][2]);
        pt::split(w[4 * LDW + 8], ah[q][i][3], al[q][i][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < CNT; ++j) {
      // the group's products go into fresh sums, added to acc rounded
      // to nearest (see kFreshK8)
      float f[2][4] = {};
#pragma unroll
      for (int q = 0; q < kFreshK8; ++q) {
        if (K8 == 0 && k0 + q >= n) break;
        // B (8x8, k x position): (k = t, n = g) (k = t+4, n = g)
        const float* b = act + boff[j] + (k0 + q) * 8 + t;
        uint32_t bh[2], bl[2];
        pt::split(b[0], bh[0], bl[0]);
        pt::split(b[4], bh[1], bl[1]);
        pt::mma3(f[0], ah[q][0], al[q][0], bh, bl);
        pt::mma3(f[1], ah[q][1], al[q][1], bh, bl);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += f[i][e];
    }
  }
}

// the same in bf16 (m16n8k16); an odd group count leaves the upper half
// of the last step zero (its weight rows are zero-filled, its act words
// not read)
template <int CNT, int K8, int NT>
__device__ __forceinline__ void chunk_mma(float (&acc)[2][NT][4],
                                          const __nv_bfloat16* ws,
                                          const __nv_bfloat16* act,
                                          const int (&boff)[NT], int nk8,
                                          int lane) {
  constexpr int LDW = Lay<__nv_bfloat16>::kLDW;
  const int t = lane & 3;
  const int n = K8 ? K8 : nk8;
  // ldmatrix: lanes 8m..8m+7 address the rows of matrix m; matrix m
  // holds k rows 8 (m >> 1) .. +7 and channels 8 (m & 1) .. +7, so the
  // transposed loads give a0..a3 of the A (channel x k) fragment
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const int lcol = ((lane >> 3) & 1) << 3;
  // act's shared-memory address (32 bits: a pointer would take two
  // registers a tile, and bf16's 128-register budget has none to spare)
  const unsigned abase =
      static_cast<unsigned>(__cvta_generic_to_shared(act)) + 4 * t;
#pragma unroll
  for (int kk = 0; kk < kKC / 16; ++kk) {
    if (2 * kk >= n) break;
    const bool upper = K8 || 2 * kk + 1 < n;
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldsm_x4_trans(af[i], ws + (kk * 16 + lrow) * LDW + i * 16 + lcol);
#pragma unroll
    for (int j = 0; j < CNT; ++j) {
      // B (16x8, k x position): (k = 2t..2t+1, n = g) (k = 2t+8.., n = g)
      const unsigned b = abase + 2 * (boff[j] + kk * 16);
      const uint32_t bf[2] = {lds32(b), upper ? lds32(b + 16) : 0u};
      pt::mma_bf16(acc[0][j], af[0], bf);
      pt::mma_bf16(acc[1][j], af[1], bf);
    }
  }
}

// chunk_mma with the warp's tile count cnt (0..NT) and group count nk8
// made compile-time: a full chunk takes the fixed kKC / 8 groups
template <int NT, int CNT = NT, typename T>
__device__ __forceinline__ void chunk_dispatch(float (&acc)[2][NT][4],
                                               const T* ws, const T* act,
                                               const int (&boff)[NT],
                                               int cnt, int nk8, int lane) {
  if constexpr (CNT > 0) {
    if (cnt == CNT) {
      if (nk8 == kKC / 8)
        chunk_mma<CNT, kKC / 8>(acc, ws, act, boff, nk8, lane);
      else
        chunk_mma<CNT, 0>(acc, ws, act, boff, nk8, lane);
    } else {
      chunk_dispatch<NT, CNT - 1>(acc, ws, act, boff, cnt, nk8, lane);
    }
  }
}

// -- staging --------------------------------------------------------------

// rows [k0, k0 + kc) of W [K][N], channels [ch0, ch0 + kBC), into
// ws [kKC][kLDW]; rows past kc and channels past N are zeros
template <typename T>
__device__ __forceinline__ void stage_w(T* ws, const T* __restrict__ W,
                                        int N, int k0, int kc, int ch0,
                                        int tid) {
  constexpr int V = Lay<T>::kVec, SEGS = kBC / V;
#pragma unroll
  for (int it = 0; it < kKC * SEGS / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / SEGS, c = (i % SEGS) * V;
    const bool ok = r < kc && ch0 + c < N;
    pt::cp_async16(ws + r * Lay<T>::kLDW + c,
                   W + (ok ? static_cast<size_t>(k0 + r) * N + ch0 + c : 0),
                   ok);
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
  // TR x TC: the largest tile, which sizes shared memory; the image is
  // cut into strips x col_tiles tiles, tile (i, j) rows
  // [i H / strips, (i+1) H / strips) and columns [j W / col_tiles, ...)
  int H, W, C, M, TR, TC, strips, col_tiles;
};

// the 8-position tiles [a8, b8) of a pass, shared out evenly over the
// position warps: this warp's first tile and count
__device__ __forceinline__ void warp_share(int a8, int b8, int wp, int& first,
                                           int& cnt) {
  const int n = b8 - a8;
  first = a8 + n * wp / kPosWarps;
  cnt = a8 + n * (wp + 1) / kPosWarps - first;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the chunk loop of one pass over a ring of kStages buffers: stage(c, buf)
// issues chunk c's copies into buffer buf, compute(c, buf) runs its
// products. kStages - 1 chunks are in flight while one computes; one
// barrier a chunk.
template <typename Stage, typename Compute>
__device__ __forceinline__ void k_loop(int nchunks, Stage stage,
                                       Compute compute) {
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks) stage(c, c);
    pt::cp_async_commit();  // empty groups keep the count uniform
  }
  int buf = 0, next = kStages - 1;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c is in; chunk c-1's buffer is free
    if (c + kStages - 1 < nchunks) stage(c + kStages - 1, next);
    pt::cp_async_commit();
    compute(c, buf);
    buf = buf + 1 == kStages ? 0 : buf + 1;
    next = next + 1 == kStages ? 0 : next + 1;
  }
}

// blocks an SM must hold at once: the register budget of a thread
// (fp32 needs about 255 registers for its 3xTF32 fragments, so one
// block; bf16 fits two blocks in 128 registers)
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 2 ? 2 : 1;

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
    bottleneck_kernel(const Args<T> a) {
  constexpr int V = Lay<T>::kVec;
  constexpr int LDW = Lay<T>::kLDW, LDX = Lay<T>::kLDX, kNT = Lay<T>::kNT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, W = a.W, C = a.C, M = a.M;
  const Regions reg = regions<T>(a.TR, a.TC, M);
  T* y1 = reinterpret_cast<T*>(smem);
  T* ost = reinterpret_cast<T*>(smem);
  T* y2 = reinterpret_cast<T*>(smem + reg.r1);
  T* xs = y2;
  T* wst = reinterpret_cast<T*>(smem + reg.r1 + reg.r2);

  // this block's tile: TR x TC from (r0, c0), at most a.TR x a.TC
  const int tiles = a.strips * a.col_tiles;
  const int img = blockIdx.x / tiles, tile = blockIdx.x - img * tiles;
  const int ti = tile / a.col_tiles, tj = tile - ti * a.col_tiles;
  const int r0 = static_cast<int>(static_cast<long long>(ti) * H / a.strips);
  const int c0 =
      static_cast<int>(static_cast<long long>(tj) * W / a.col_tiles);
  const int TR =
      static_cast<int>(static_cast<long long>(ti + 1) * H / a.strips) - r0;
  const int TC =
      static_cast<int>(static_cast<long long>(tj + 1) * W / a.col_tiles) -
      c0;
  const int TC2 = TC + 2, ld = M + V;
  const int P1 = (TR + 2) * TC2, P = TR * TC;
  const size_t plane = static_cast<size_t>(H) * W * C;
  const T* __restrict__ xi = a.x + img * plane;
  T* __restrict__ oi = a.out + img * plane;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wc = warp & 1, wp = warp >> 1;

  // ---- conv1: y1 over the tile and its halo (local row l, col j is
  // image row r0-1+l, col c0-1+j) ----
  {
    constexpr int SEGX = kKC / V;                 // 16-byte pieces a row
    constexpr int XR = kXP * SEGX / kThreads;     // pieces a thread
    const int n8 = (P1 + 7) / 8;
    const int passes = (n8 + kPosWarps * kNT1 - 1) / (kPosWarps * kNT1);
    const int nchunks = (C + kKC - 1) / kKC;
    // rows of a staged x chunk (regions() sizes kStages of them)
    const int xp = min(kXP, (P1 + 31) / 32 * 32);
    const int xseg = (tid % SEGX) * V;
    for (int pass = 0; pass < passes; ++pass) {
      const int a8 = n8 * pass / passes, b8 = n8 * (pass + 1) / passes;
      const int q0 = a8 * 8, nq = min(b8 * 8, P1) - q0;
      // this thread's x pieces (one 16-byte column of the chunk, rows
      // tid / SEGX + kThreads / SEGX * it): offset of the source row in
      // the image plane (-1: zeros)
      int xsrc[XR];
#pragma unroll
      for (int it = 0; it < XR; ++it) {
        const int row = tid / SEGX + it * (kThreads / SEGX);
        const int q = q0 + row;
        const int lr = q / TC2, lc = q - lr * TC2;
        const int r = r0 - 1 + lr, c = c0 - 1 + lc;
        const bool in = row < nq && r >= 0 && r < H && c >= 0 && c < W;
        xsrc[it] = in ? (r * W + c) * C + xseg : -1;
      }
      int first, cnt;
      warp_share(a8, b8, wp, first, cnt);
      int boff[kNT1];
#pragma unroll
      for (int j = 0; j < kNT1; ++j)
        boff[j] = ((first - a8 + j) * 8 + g) * LDX;
      for (int ch0 = 0; ch0 < M; ch0 += kBC) {
        const int wch = ch0 + 32 * wc;
        const bool busy = wch < M;
        float acc[2][kNT1][4] = {};
        auto stage = [&](int c, int buf) {
          const int k0 = c * kKC, kc = min(kKC, C - k0);
          stage_w<T>(wst + buf * kKC * LDW, a.w1, M, k0, kc, ch0, tid);
          T* xb = xs + buf * xp * LDX + xseg;
#pragma unroll
          for (int it = 0; it < XR; ++it) {
            const int row = tid / SEGX + it * (kThreads / SEGX);
            if (row >= xp) break;
            const bool ok = xsrc[it] >= 0 && xseg < kc;
            pt::cp_async16(xb + row * LDX, xi + (ok ? xsrc[it] + k0 : 0), ok);
          }
        };
        auto compute = [&](int c, int buf) {
          if (!busy) return;
          const int nk8 = min(kKC, C - c * kKC) / 8;
          chunk_dispatch<kNT1>(acc, wst + buf * kKC * LDW + 32 * wc,
                               xs + buf * xp * LDX, boff, cnt, nk8, lane);
        };
        k_loop(nchunks, stage, compute);
        if (busy) {
#pragma unroll
          for (int j = 0; j < kNT1; ++j) {
            if (j >= cnt) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int q = (first + j) * 8 + 2 * t + e;
              if (q >= P1) continue;
              const int lr = q / TC2, lc = q - lr * TC2;
              const int r = r0 - 1 + lr, c = c0 - 1 + lc;
              const bool in = r >= 0 && r < H && c >= 0 && c < W;
#pragma unroll
              for (int i = 0; i < 2; ++i) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int ch = wch + 16 * i + 8 * h + g;
                  if (ch >= M) continue;
                  const float v =
                      fmaxf(acc[i][j][2 * h + e] + a.b1[ch], 0.f);
                  y1[q * ld + ch] = pt::from_f<T>(in ? v : 0.f);
                }
              }
            }
          }
        }
        __syncthreads();
      }
    }
  }

  // ---- conv2: tap (ky, kx) of output position (lr, lc) is y1 tile
  // position (lr + ky, lc + kx) ----
  {
    const int n8 = (P + 7) / 8;
    const int passes = (n8 + kPosWarps * kNT - 1) / (kPosWarps * kNT);
    const int cpt = (M + kKC - 1) / kKC;  // chunks a tap
    for (int pass = 0; pass < passes; ++pass) {
      const int a8 = n8 * pass / passes, b8 = n8 * (pass + 1) / passes;
      int first, cnt;
      warp_share(a8, b8, wp, first, cnt);
      int boff[kNT];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int p = min((first + j) * 8 + g, P - 1);
        const int lr = p / TC;
        boff[j] = (lr * TC2 + p - lr * TC) * ld;
      }
      for (int ch0 = 0; ch0 < M; ch0 += kBC) {
        const int wch = ch0 + 32 * wc;
        const bool busy = wch < M;
        float acc[2][kNT][4] = {};
        auto stage = [&](int c, int buf) {
          const int tap = c / cpt, ci0 = (c - tap * cpt) * kKC;
          stage_w<T>(wst + buf * kKC * LDW, a.w2, M, tap * M + ci0,
                     min(kKC, M - ci0), ch0, tid);
        };
        auto compute = [&](int c, int buf) {
          if (!busy) return;
          const int tap = c / cpt, ci0 = (c - tap * cpt) * kKC;
          const int ky = tap / 3, kx = tap - 3 * ky;
          chunk_dispatch<kNT>(acc, wst + buf * kKC * LDW + 32 * wc,
                              y1 + (ky * TC2 + kx) * ld + ci0, boff, cnt,
                              min(kKC, M - ci0) / 8, lane);
        };
        k_loop(9 * cpt, stage, compute);
        if (busy) {
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            if (j >= cnt) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int p = (first + j) * 8 + 2 * t + e;
              if (p >= P) continue;
#pragma unroll
              for (int i = 0; i < 2; ++i) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int ch = wch + 16 * i + 8 * h + g;
                  if (ch >= M) continue;
                  y2[p * ld + ch] = pt::from_f<T>(
                      fmaxf(acc[i][j][2 * h + e] + a.b2[ch], 0.f));
                }
              }
            }
          }
        }
        __syncthreads();
      }
    }
  }

  // ---- conv3: the residual x comes into the output stage with the first
  // weight chunk of each 64-channel pass; each sum then takes b3 and its
  // residual, relu and the rounding in place, and the stage goes out in
  // 16-byte pieces ----
  {
    constexpr int LDO = Lay<T>::kLDO;
    const int n8 = (P + 7) / 8;
    const int passes = (n8 + kPosWarps * kNT - 1) / (kPosWarps * kNT);
    const int nchunks = (M + kKC - 1) / kKC;
    constexpr int G = kBC / V;  // 16-byte pieces of a pass's channels
    for (int pass = 0; pass < passes; ++pass) {
      const int a8 = n8 * pass / passes, b8 = n8 * (pass + 1) / passes;
      const int p0 = a8 * 8, np = min(b8 * 8, P) - p0;
      int first, cnt;
      warp_share(a8, b8, wp, first, cnt);
      int boff[kNT];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        boff[j] = min((first + j) * 8 + g, P - 1) * ld;
      // the 16-byte pieces of the pass's output rows: stage slot and
      // image offset at channel 0, by piece i = tid + kThreads * k
      auto piece = [&](int i, int ch0, int& slot, size_t& off) {
        const int lp = i / G, cv = (i - lp * G) * V;
        const int p = p0 + lp, lr = p / TC;
        slot = lp * LDO + cv;
        off = (static_cast<size_t>(r0 + lr) * W + c0 + p - lr * TC) * C +
              ch0 + cv;
        return ch0 + cv < C;
      };
      for (int ch0 = 0; ch0 < C; ch0 += kBC) {
        const int wch = ch0 + 32 * wc;
        const bool busy = wch < C;
        // the residual joins the first chunk's group of copies
        for (int i = tid; i < np * G; i += kThreads) {
          int slot;
          size_t off;
          const bool ok = piece(i, ch0, slot, off);
          pt::cp_async16(ost + slot, xi + (ok ? off : 0), ok);
        }
        float acc[2][kNT][4] = {};
        auto stage = [&](int c, int buf) {
          const int k0 = c * kKC;
          stage_w<T>(wst + buf * kKC * LDW, a.w3, C, k0, min(kKC, M - k0),
                     ch0, tid);
        };
        auto compute = [&](int c, int buf) {
          if (!busy) return;
          const int k0 = c * kKC;
          chunk_dispatch<kNT>(acc, wst + buf * kKC * LDW + 32 * wc, y2 + k0,
                              boff, cnt, min(kKC, M - k0) / 8, lane);
        };
        k_loop(nchunks, stage, compute);
        if (busy) {
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            if (j >= cnt) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int lp = (first + j) * 8 + 2 * t + e - p0;
#pragma unroll
              for (int i = 0; i < 2; ++i) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int chl = 32 * wc + 16 * i + 8 * h + g;
                  if (ch0 + chl >= C) continue;
                  T* o = ost + lp * LDO + chl;
                  *o = pt::from_f<T>(fmaxf(
                      acc[i][j][2 * h + e] + a.b3[ch0 + chl] + pt::to_f(*o),
                      0.f));
                }
              }
            }
          }
        }
        __syncthreads();
        for (int i = tid; i < np * G; i += kThreads) {
          int slot;
          size_t off;
          if (piece(i, ch0, slot, off))
            *reinterpret_cast<uint4*>(oi + off) =
                *reinterpret_cast<const uint4*>(ost + slot);
        }
        __syncthreads();
      }
    }
  }
}

}  // namespace

namespace {

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, void* out, int N,
           int H, int W, int C, int M, int TR, int TC, int strips,
           int col_tiles, int smem, cudaStream_t stream) {
  if (M % 8 != 0 || C % 8 != 0 || strips < 1 || strips > H ||
      col_tiles < 1 || col_tiles > W || TR > H || TC > W ||
      (H + strips - 1) / strips > TR || (W + col_tiles - 1) / col_tiles > TC)
    return static_cast<int>(cudaErrorInvalidValue);
  // the caller's shared bytes must be this layout's, and fit a block
  if (regions<T>(TR, TC, M).total() != smem || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  // block indices and offsets inside an image plane are 32-bit
  const long long blocks = static_cast<long long>(strips) * col_tiles * N;
  if (blocks > 0x7fffffffLL ||
      static_cast<long long>(H) * W * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args<T> a{static_cast<const T*>(x),      static_cast<const T*>(w1),
            static_cast<const float*>(b1), static_cast<const T*>(w2),
            static_cast<const float*>(b2), static_cast<const T*>(w3),
            static_cast<const float*>(b3), static_cast<T*>(out),
            H, W, C, M, TR, TC, strips, col_tiles};
  bottleneck_kernel<T>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, bottleneck_kernel<T>, kThreads, smem));
}

}  // namespace

// tr x tc: the largest tile; strips x col_tiles: the tiles of an image;
// smem: the tile's shared bytes (all from fused_bottleneck_config)
extern "C" int pt_fused_bottleneck(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, const void* w3,
                                   const void* b3, void* out, int N, int H,
                                   int W, int C, int M, int tr, int tc,
                                   int strips, int col_tiles, int smem,
                                   int dtype, void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (N < 0 || C <= 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32)
    return launch<float>(x, w1, b1, w2, b2, w3, b3, out, N, H, W, C, M, tr,
                         tc, strips, col_tiles, smem, st);
  if (dtype == pt::kBF16)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, out, N, H, W, C,
                                 M, tr, tc, strips, col_tiles, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// blocks of the kernel an SM holds at once with smem shared bytes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks
extern "C" int pt_fused_bottleneck_occupancy(int smem, int dtype,
                                             void* blocks) {
  int* b = static_cast<int*>(blocks);
  if (dtype == pt::kF32) return occupancy<float>(smem, b);
  if (dtype == pt::kBF16) return occupancy<__nv_bfloat16>(smem, b);
  return static_cast<int>(cudaErrorInvalidValue);
}
