// attention_bwd: the softmax-attention backward (FlashAttention-2
// formulas) in four entries, reading q/k/v/dO through strides in the
// [B, S, H, D] layout and writing dQ/dK/dV [B, S, H, D] in the storage
// type, with every sum in fp32.
//
// Replaces four TPU kernels of paddle_tpu/ops/pallas/:
//   mode 0  dQ pass           flash_attention._bwd_dq_kernel    (:146, #7)
//   mode 1  dK/dV pass        flash_attention._bwd_dkv_kernel   (:250, #8)
//   mode 2  fused, nq == 1    flash_attention._bwd_fused_kernel (:186, #6)
//   mode 3  folded            folded_attention._bwd_kernel      (:85, #10)
//
// With P = exp(S*scale - lse), dP = dO V^T and dS = P (dP - delta) scale:
// dV = P^T dO, dK = dS^T Q, dQ = dS K. Modes 0-2 take lse and delta =
// rowsum(dO*O) - g_lse from the caller (the JAX package computes delta
// outside Pallas too). Mode 3 receives no lse: like the TPU kernel it
// recomputes the softmax from q, k, v and dO, in a first launch that
// walks the K tiles with an online max and writes lse and delta =
// rowsum(P^ dP) per row.
//
// Launches per call: mode 0 and mode 1 one each; mode 2 two (the single
// pass, then the dQ sum); mode 3 three (the statistics first).
//
// Blocks run in no order on the card, so where the TPU carried a dQ sum
// in scratch across its sequential grid, the single pass lets the block
// of each K tile write its dQ share to a per-tile fp32 buffer, and a
// last launch sums the tiles in a fixed order. There are no float
// atomics: every output element is summed in one fixed order, so two
// runs give the same bits. The scores and their exp are computed
// once per (q, k) pair in the single pass, as on the TPU.
//
// What bounds it on the H100: operations. 6 (dQ), 8 (dK/dV) or 10
// (single pass) flops per (q, k) pair and head-dim element against 4-5
// rows of input per position.
//
// All four run on the tensor cores with the forward's building blocks
// (mma.cuh): mma.sync m16n8k8 in 3xTF32 for fp32 (hi and lo TF32 parts
// rounded to nearest, three products, as exact as fp32 FMA) and
// m16n8k16 bf16 for bf16, with P and dS carried as two bf16 terms
// (hi + lo) into their products; f32 accumulation throughout. Rows are
// staged with 16-byte cp.async copies into shared memory padded by 16
// bytes, so every fragment load is conflict-free.
// - Key-major (modes 1-3): one block of 8 warps per (h, b, K tile of 64
//   keys) walks the Q tiles that see it. A warp computes S^T = K Q^T and
//   dP^T = V dO^T, so P^T and dS^T are already A operands of dV += P^T
//   dO and dK += dS^T Q, with the forward's permuted contraction index
//   (accumulator columns 2t, 2t+1 are the TF32 A fragment's t, t+4). K
//   and V are staged once per block; Q, dO, lse and delta are double
//   buffered, so the next Q tile arrives while the current one is
//   multiplied. The single pass (modes 2, 3) also stages dS^T for the
//   block's dQ share dS K; the dK/dV pass (mode 1) is the same kernel
//   without the share. fp32 D=128 takes 216 KB of shared memory: one
//   block of 8 warps per SM. Causal: blocks are numbered so that the K
//   tiles with the longest Q walk (the first keys) start first, over all
//   heads and batches.
// - Query-major (mode 0, and mode 3's statistics launch): the forward's
//   structure (attention_fwd.cu), one block of 8 warps per (h, b, Q
//   tile), 4 row groups of 16 queries, the two warps of a group taking
//   the two halves of every K tile; Q and dO staged once, K and V double
//   buffered. The dQ pass computes S = Q K^T and dP = dO V^T, keeps P
//   and dS in the accumulator layout (lse is given, so there is no
//   online softmax) and adds dQ += dS K with K in the place of the
//   forward's V. Causal: the longest Q tiles (the last rows) start
//   first; K tiles wholly above the diagonal are never loaded.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace pt;

constexpr int kT = 64;         // rows of a q tile and of a k tile
constexpr int kThreads = 256;  // 8 warps

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ size_t row_index(int b, int s, int h, int S,
                                            int H) {
  return (static_cast<size_t>(b) * S + s) * H + h;
}

template <typename T, int D>
struct Tc {
  // shared-memory row of a q/k/v/dO tile: D elements padded by 16 bytes,
  // so every fragment load of scores() and pv_at() is conflict-free
  static constexpr int kLD = D + 16 / static_cast<int>(sizeof(T));
  // row of the staged dS^T tile (one key, 64 queries, f32): 68 floats
  // make the dQ share's permuted fragment loads conflict-free
  static constexpr int kLDS = kT + 4;
  static constexpr size_t kTile = static_cast<size_t>(kT) * kLD * sizeof(T);
  // K, V once; Q, dO double buffered; dS^T; lse, delta double buffered
  static constexpr size_t kSmemFused =
      6 * kTile + (static_cast<size_t>(kT) * kLDS + 4 * kT) * sizeof(float);
  // query-major: Q, dO once; K, V double buffered
  static constexpr size_t kSmemQMajor = 6 * kTile;
};

// The key-major pass. Single pass (#6, and #10 after the statistics;
// kShare): one block of 8 warps per (h, b, K tile) walks the Q tiles
// that see its 64 keys. Warp w owns keys 16 (w % 4) .. +15 and, of every
// Q tile, queries 32 (w / 4) .. +31: it computes S^T = K Q^T and dP^T =
// V dO^T for that 16 x 32 patch, so its accumulators hold P^T and dS^T
// in the layout of an A operand,
// and adds dV += P^T dO and dK += dS^T Q over its 32 queries into
// registers (16 keys x D each). dS^T goes to shared memory once per Q
// tile, before the products (dK reads its A operand back from there, so
// that dS^T does not hold registers beside dK and dV); then, after a
// barrier, warp w computes this K tile's dQ share dS K for queries
// 16 (w % 4) .. +15 and half w / 4 of D, and writes it to
// dq_part[K tile] (f32), which dq_reduce_kernel sums in tile order. At
// the end the two warps of a key group hand each other half of their
// partial sums over the two query halves (query half 0 + half 1, in
// that order) and write dK and dV. The dK/dV pass (#8, !kShare) is the
// same walk without the dQ share: no barrier between the products, no
// dq_part; each warp reads back only its own staged dS^T.
template <typename T, int D, bool kShare>
__device__ __forceinline__ void key_major_pass(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_part,
    int B, int Sq, int Sk, int H, Strides qs, Strides ks, Strides vs,
    Strides ds, int causal, float scale) {
  constexpr int kLD = Tc<T, D>::kLD;
  constexpr int kLDS = Tc<T, D>::kLDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [kT][kLD]
  T* Vs = Ks + kT * kLD;                    // [kT][kLD]
  T* Qs = Vs + kT * kLD;                    // [2][kT][kLD]
  T* dOs = Qs + 2 * kT * kLD;               // [2][kT][kLD]
  float* dsT = reinterpret_cast<float*>(dOs + 2 * kT * kLD);  // [kT][kLDS]
  float* Ls = dsT + kT * kLDS;              // [2][kT] lse
  float* Dl = Ls + 2 * kT;                  // [2][kT] delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3;  // key rows 16 rg .. (and dQ share query rows)
  const int qh = warp >> 2;  // query half of a Q tile (and dQ share D half)
  const int h = blockIdx.x, b = blockIdx.y;
  // causal: K tile 0 walks the most Q tiles, so the first tiles of every
  // head and batch are launched first
  const int kt = blockIdx.z, k0 = kt * kT;
  const int kw = k0 + 16 * rg;  // this warp's first key
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* db = dout + b * ds.b + h * ds.h;

  // causal: query rows below k0 see none of this K tile
  const int q_start = causal ? k0 : 0;
  const int n_q = q_start < Sq ? (Sq - q_start + kT - 1) / kT : 0;
  auto load_q_tile = [&](int buf, int q0) {
    load_rows<T, D, kT, kLD, kThreads>(Qs + buf * kT * kLD, qb, qs.s, q0,
                                       Sq, tid);
    load_rows<T, D, kT, kLD, kThreads>(dOs + buf * kT * kLD, db, ds.s, q0,
                                       Sq, tid);
    if (tid < 2 * kT) {
      const int r = tid & (kT - 1), s = q0 + r;
      const bool in = s < Sq;
      const float* src = (tid < kT ? lse : delta) +
                         (in ? row_index(b, s, h, Sq, H) : 0);
      cp_async4((tid < kT ? Ls : Dl) + buf * kT + r, src, in);
    }
  };
  load_rows<T, D, kT, kLD, kThreads>(Ks, kb, ks.s, k0, Sk, tid);
  load_rows<T, D, kT, kLD, kThreads>(Vs, vb, vs.s, k0, Sk, tid);
  if (n_q > 0) load_q_tile(0, q_start);
  cp_async_commit();

  // rows kw + g (e < 2) and kw + g + 8, columns 8n + 2t (+1); partial
  // sums over this warp's query half of every Q tile
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; it < n_q; ++it) {
    const int q0 = q_start + it * kT, buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // Q tile it is in; tile it-1 and its dS^T consumed
    if (it + 1 < n_q) load_q_tile(buf ^ 1, q0 + kT);
    cp_async_commit();
    const T* Qb = Qs + (buf * kT + 32 * qh) * kLD;    // this warp's queries
    const T* dOb = dOs + (buf * kT + 32 * qh) * kLD;
    const float* Lb = Ls + buf * kT + 32 * qh;
    const float* Db = Dl + buf * kT + 32 * qh;
    const int qw = q0 + 32 * qh;  // this warp's first query

    // S^T and dP^T, then P^T and dS^T in place: rows (keys) kw + g (+8),
    // columns (queries) qw + 8j + 2t (+1)
    float* stage = dsT + (16 * rg + g) * kLDS + 32 * qh + 2 * t;
    // nothing to add when the patch is past Sk or Sq, or every query of
    // it is above every key (causal): its dS^T is zeros
    if (kw < Sk && qw < Sq && !(causal && qw + 31 < kw)) {
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      scores<D, 32, kLD>(st, Ks + 16 * rg * kLD, Qb, g, t);
      scores<D, 32, kLD>(dpt, Vs + 16 * rg * kLD, dOb, g, t);
      const bool edge =
          kw + 16 > Sk || qw + 32 > Sq || (causal && qw < kw + 15);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          float x = st[j][e] * scale;
          if (edge) {
            const int key = kw + g + 8 * (e >> 1), query = qw + c;
            if (key >= Sk || query >= Sq || (causal && key > query))
              x = kNegInf;
          }
          const float p = expf(x - Lb[c]);
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - Db[c]) * scale;
        }
      // dS^T into the staged tile now, so that it leaves the registers
      // before the products; the warp reads its own patch back for dK
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        store2(stage + 8 * j, dpt[j][0], dpt[j][1]);
        store2(stage + 8 * kLDS + 8 * j, dpt[j][2], dpt[j][3]);
      }
      __syncwarp();
      pv<D, 32, kLD>(dva, st, dOb, g, t);  // dV += P^T dO
      pv_at<D, 32, kLD>(                   // dK += dS^T Q
          dka,
          [&](int j, int e) {
            return stage[8 * (e >> 1) * kLDS + 8 * j + (e & 1)];
          },
          Qb, g, t);
    } else if constexpr (kShare) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        store2(stage + 8 * j, 0.f, 0.f);
        store2(stage + 8 * kLDS + 8 * j, 0.f, 0.f);
      }
    }
    if constexpr (kShare) {
      __syncthreads();  // dS^T complete

      // this K tile's dQ share dS K: rows (queries) q0 + 16 rg + g (+8),
      // columns (D / 2) qh + 8n + 2t (+1) in two passes of D / 4 (fewer
      // live registers beside dK and dV), A read from dS^T transposed
      const int qr = q0 + 16 * rg;
      if (qr < Sq) {
        const float* a = dsT + 16 * rg + g;
        auto at = [&](int j, int e) {
          return a[(8 * j + 2 * t + (e & 1)) * kLDS + 8 * (e >> 1)];
        };
#pragma unroll 1
        for (int pass = 0; pass < 2; ++pass) {
          const int c0 = (D / 2) * qh + (D / 4) * pass;
          float acc[D / 32][4];
#pragma unroll
          for (int n = 0; n < D / 32; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
          pv_at<D / 4, kT, kLD>(acc, at, Ks + c0, g, t);
          float* part = dq_part +
                        kt * (static_cast<size_t>(B) * Sq * H * D) + c0 +
                        2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int s = qr + g + 8 * r;
            if (s >= Sq) continue;
            float* row = part + row_index(b, s, h, Sq, H) * D;
#pragma unroll
            for (int n = 0; n < D / 32; ++n)
              store2(row + 8 * n, acc[n][2 * r], acc[n][2 * r + 1]);
          }
        }
      }
    }
  }

  // the two query halves meet: warp qh = 0 hands its dV partial to the
  // warp qh = 1 of its key group, which hands back its dK partial
  // (through the Q/dO buffers, now free); each sums half 0 + half 1
  cp_async_wait_all();
  __syncthreads();
  constexpr int kHand = D / 2;  // floats a thread hands over
  static_assert(kThreads * kHand * sizeof(float) <= 4 * Tc<T, D>::kTile,
                "the hand-over does not fit the Q/dO buffers");
  float* slot = reinterpret_cast<float*>(Qs) + (warp * 32 + lane) * kHand;
  float* other = reinterpret_cast<float*>(Qs) +
                 ((warp ^ 4) * 32 + lane) * kHand;  // the other query half
  // each branch names its arrays, so both stay in registers
  auto hand = [&](const float(&give)[D / 8][4]) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float4*>(slot + 4 * n) =
          make_float4(give[n][0], give[n][1], give[n][2], give[n][3]);
  };
  auto add = [&](float(&keep)[D / 8][4], const float* from) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float4 o = *reinterpret_cast<const float4*>(from + 4 * n);
      keep[n][0] += o.x;
      keep[n][1] += o.y;
      keep[n][2] += o.z;
      keep[n][3] += o.w;
    }
  };
  auto write = [&](const float(&keep)[D / 8][4], T* out) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = kw + g + 8 * r;
      if (s >= Sk) continue;
      T* row = out + row_index(b, s, h, Sk, H) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(row + 8 * n, keep[n][2 * r], keep[n][2 * r + 1]);
    }
  };
  if (qh == 0)
    hand(dva);
  else
    hand(dka);
  __syncthreads();
  // half 0 + half 1 (two terms: the same bits in either order)
  if (qh == 0)
    add(dka, other);
  else
    add(dva, other);
  if (qh == 0)
    write(dka, dk);
  else
    write(dva, dv);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_fused_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv,
                               float* __restrict__ dq_part, int B, int Sq,
                               int Sk, int H, Strides qs, Strides ks,
                               Strides vs, Strides ds, int causal,
                               float scale) {
  key_major_pass<T, D, true>(q, k, v, dout, lse, delta, dk, dv, dq_part, B,
                             Sq, Sk, H, qs, ks, vs, ds, causal, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_dkv_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int Sq,
                             int Sk, int H, Strides qs, Strides ks,
                             Strides vs, Strides ds, int causal,
                             float scale) {
  key_major_pass<T, D, false>(q, k, v, dout, lse, delta, dk, dv, nullptr, 1,
                              Sq, Sk, H, qs, ks, vs, ds, causal, scale);
}

// dQ pass (#7), query-major: warp w takes queries w0 = q0 + 16 (w % 4)
// .. +15 and, of every K tile, the keys 32 (w / 4) .. +31. S = Q K^T
// and dP = dO V^T for that 16 x 32 patch, then P = exp(S scale - lse)
// and dS = P (dP - delta) scale in place, the causal and ragged edges
// masked to -1e30 before the exp (so P is 0 there), and dQ += dS K
// (pv(): dS is the A operand in the accumulator layout, K the B operand
// read as the forward reads V). Half tiles wholly above the diagonal or
// past Sk are skipped by the warp. At the end the warp of the second K
// half hands its 16 x D partial sum to the first through the (now free)
// K/V buffers, which adds it (first half + second) and writes the rows.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int Sq, int Sk, int H,
                            Strides qs, Strides ks, Strides vs, Strides ds,
                            int causal, float scale) {
  constexpr int kLD = Tc<T, D>::kLD;
  constexpr int kHK = kT / 2;  // keys of a tile each warp takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kT][kLD]
  T* dOs = Qs + kT * kLD;                  // [kT][kLD]
  T* Ks = dOs + kT * kLD;                  // [2][kT][kLD]
  T* Vs = Ks + 2 * kT * kLD;               // [2][kT][kLD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3;  // this warp's 16 query rows
  const int kh = warp >> 2;  // and its half of every K tile
  const int h = blockIdx.x, b = blockIdx.y;
  // causal: the longest Q tiles first
  const int qt = causal ? static_cast<int>(gridDim.z - 1 - blockIdx.z)
                        : static_cast<int>(blockIdx.z);
  const int q0 = qt * kT, w0 = q0 + 16 * rg;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* db = dout + b * ds.b + h * ds.h;

  const int k_end = causal ? min(Sk, q0 + kT) : Sk;
  const int n_tiles = (k_end + kT - 1) / kT;
  load_rows<T, D, kT, kLD, kThreads>(Qs, qb, qs.s, q0, Sq, tid);
  load_rows<T, D, kT, kLD, kThreads>(dOs, db, ds.s, q0, Sq, tid);
  if (n_tiles > 0) {
    load_rows<T, D, kT, kLD, kThreads>(Ks, kb, ks.s, 0, Sk, tid);
    load_rows<T, D, kT, kLD, kThreads>(Vs, vb, vs.s, 0, Sk, tid);
  }
  cp_async_commit();

  // lse and delta of rows w0 + g (index 0) and w0 + g + 8 (index 1)
  float L[2], Dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    const bool in = row < Sq;
    L[r] = in ? lse[row_index(b, row, h, Sq, H)] : 0.f;
    Dl[r] = in ? delta[row_index(b, row, h, Sq, H)] : 0.f;
  }
  // rows w0 + g, w0 + g + 8, columns 8n + 2t (+1), over this warp's keys
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kT + kh * kHK, buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it is in; tile it-1's buffer is free
    if (it + 1 < n_tiles) {
      const int next = (it + 1) * kT;
      load_rows<T, D, kT, kLD, kThreads>(Ks + (buf ^ 1) * kT * kLD, kb,
                                         ks.s, next, Sk, tid);
      load_rows<T, D, kT, kLD, kThreads>(Vs + (buf ^ 1) * kT * kLD, vb,
                                         vs.s, next, Sk, tid);
    }
    cp_async_commit();
    if ((causal && k0 > w0 + 15) || k0 >= Sk) continue;

    const int off = (buf * kT + kh * kHK) * kLD;
    float s[kHK / 8][4], dp[kHK / 8][4];
#pragma unroll
    for (int j = 0; j < kHK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    scores<D, kHK, kLD>(s, Qs + 16 * rg * kLD, Ks + off, g, t);
    scores<D, kHK, kLD>(dp, dOs + 16 * rg * kLD, Vs + off, g, t);

    const bool masked = k0 + kHK > Sk || (causal && k0 + kHK - 1 > w0);
#pragma unroll
    for (int j = 0; j < kHK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = w0 + g + 8 * (e >> 1);
          if (col >= Sk || (causal && col > row)) x = kNegInf;
        }
        const float p = expf(x - L[e >> 1]);
        s[j][e] = p * (dp[j][e] - Dl[e >> 1]) * scale;  // dS
      }
    pv<D, kHK, kLD>(acc, s, Ks + off, g, t);
  }

  // the second K half's warp hands its partial sum to the first through
  // the (now free) K/V buffers
  cp_async_wait_all();
  __syncthreads();
  constexpr int kHand = D / 2;  // floats a thread hands over
  static_assert(4 * 32 * kHand * sizeof(float) <= 4 * Tc<T, D>::kTile,
                "the hand-over does not fit the K/V buffers");
  float* mine = reinterpret_cast<float*>(Ks) + (rg * 32 + lane) * kHand;
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float4*>(mine + 4 * n) =
          make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
  }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const float4 o = *reinterpret_cast<const float4*>(mine + 4 * n);
    acc[n][0] += o.x;
    acc[n][1] += o.y;
    acc[n][2] += o.z;
    acc[n][3] += o.w;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= Sq) continue;
    T* out = dq + row_index(b, row, h, Sq, H) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(out + 8 * n, acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// Folded entry (#10), first launch: each row's lse and delta =
// rowsum(P^ dP) from q, k, v and dO alone, in the forward's structure
// (attention_fwd.cu): one block of 8 warps per (h, b, Q tile), 4 row
// groups of 16 queries, the two warps of a group taking the two halves
// of every K tile; S = Q K^T and dP = dO V^T on the tensor cores, an
// online max with the sums l = rowsum(e) and a = rowsum(e dP) rescaled
// alongside, the two halves merged (first half, then second) at the end.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_stats_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ dout,
                               float* __restrict__ lse,
                               float* __restrict__ delta, int Sq, int Sk,
                               int H, Strides qs, Strides ks, Strides vs,
                               Strides ds, int causal, float scale) {
  constexpr int kLD = Tc<T, D>::kLD;
  constexpr int kHK = kT / 2;  // keys of a tile each warp takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kT][kLD]
  T* dOs = Qs + kT * kLD;                  // [kT][kLD]
  T* Ks = dOs + kT * kLD;                  // [2][kT][kLD]
  T* Vs = Ks + 2 * kT * kLD;               // [2][kT][kLD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3;  // this warp's 16 query rows
  const int kh = warp >> 2;  // and its half of every K tile
  const int h = blockIdx.x, b = blockIdx.y;
  // causal: the longest Q tiles first
  const int qt = causal ? static_cast<int>(gridDim.z - 1 - blockIdx.z)
                        : static_cast<int>(blockIdx.z);
  const int q0 = qt * kT, w0 = q0 + 16 * rg;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const T* db = dout + b * ds.b + h * ds.h;

  const int k_end = causal ? min(Sk, q0 + kT) : Sk;
  const int n_tiles = (k_end + kT - 1) / kT;
  load_rows<T, D, kT, kLD, kThreads>(Qs, qb, qs.s, q0, Sq, tid);
  load_rows<T, D, kT, kLD, kThreads>(dOs, db, ds.s, q0, Sq, tid);
  if (n_tiles > 0) {
    load_rows<T, D, kT, kLD, kThreads>(Ks, kb, ks.s, 0, Sk, tid);
    load_rows<T, D, kT, kLD, kThreads>(Vs, vb, vs.s, 0, Sk, tid);
  }
  cp_async_commit();

  // rows w0 + g (index 0) and w0 + g + 8 (index 1), over this warp's keys
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kT + kh * kHK, buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it is in; tile it-1's buffer is free
    if (it + 1 < n_tiles) {
      const int next = (it + 1) * kT;
      load_rows<T, D, kT, kLD, kThreads>(Ks + (buf ^ 1) * kT * kLD, kb,
                                         ks.s, next, Sk, tid);
      load_rows<T, D, kT, kLD, kThreads>(Vs + (buf ^ 1) * kT * kLD, vb,
                                         vs.s, next, Sk, tid);
    }
    cp_async_commit();
    if ((causal && k0 > w0 + 15) || k0 >= Sk) continue;

    const int off = (buf * kT + kh * kHK) * kLD;
    float s[kHK / 8][4], dp[kHK / 8][4];
#pragma unroll
    for (int j = 0; j < kHK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    scores<D, kHK, kLD>(s, Qs + 16 * rg * kLD, Ks + off, g, t);
    scores<D, kHK, kLD>(dp, dOs + 16 * rg * kLD, Vs + off, g, t);

    const bool masked = k0 + kHK > Sk || (causal && k0 + kHK - 1 > w0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kHK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          const int row = w0 + g + 8 * (e >> 1);
          if (col >= Sk || (causal && col > row)) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    // a row that has seen only masked keys so far takes its exponentials
    // against 0, so they stay 0
    float alpha[2], ref[2], sum[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      ref[r] = m_new == kNegInf ? 0.f : m_new;
      alpha[r] = expf(m[r] - ref[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kHK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - ref[e >> 1]);
        sum[e >> 1] += p;
        pd[e >> 1] += p * dp[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
      a[r] = a[r] * alpha[r] + quad_sum(pd[r]);
    }
  }

  // the second warp of each row group hands its max and sums to the first
  // through the (now free) K buffers
  cp_async_wait_all();
  __syncthreads();
  float* mine = reinterpret_cast<float*>(Ks) + (rg * 32 + lane) * 8;
  if (kh == 1) {
    *reinterpret_cast<float4*>(mine) = make_float4(m[0], m[1], l[0], l[1]);
    *reinterpret_cast<float2*>(mine + 4) = make_float2(a[0], a[1]);
  }
  __syncthreads();
  if (kh == 1 || t != 0) return;
  const float4 ml = *reinterpret_cast<const float4*>(mine);
  const float2 a2v = *reinterpret_cast<const float2*>(mine + 4);
  const float m2[2] = {ml.x, ml.y}, l2[2] = {ml.z, ml.w};
  const float a2[2] = {a2v.x, a2v.y};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= Sq) continue;
    const float mt = fmaxf(m[r], m2[r]);
    const float f1 = expf(m[r] - mt), f2 = expf(m2[r] - mt);
    const float den = fmaxf(l[r] * f1 + l2[r] * f2, 1e-30f);
    lse[row_index(b, row, h, Sq, H)] = mt + logf(den);
    delta[row_index(b, row, h, Sq, H)] = (a[r] * f1 + a2[r] * f2) / den;
  }
}

// dQ of the single pass: the K tiles' shares summed in tile order, four
// elements a thread. Causal: K tile t wrote rows of the Q tiles from t
// on, so row s sums the tiles 0 .. s / kT.
template <typename T>
__global__ void dq_reduce_kernel(const float* __restrict__ part,
                                 T* __restrict__ dq, int Sq, int H, int D,
                                 int n_kt, int causal, size_t n) {
  const size_t n4 = n / 4;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) +
                  threadIdx.x;
       i < n4; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t idx = 4 * i;
    const int s = static_cast<int>((idx / (static_cast<size_t>(H) * D)) % Sq);
    const int t_end = causal ? min(n_kt, s / kT + 1) : n_kt;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < t_end; ++t) {
      const float4 p = *reinterpret_cast<const float4*>(part + t * n + idx);
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    store2(dq + idx, acc.x, acc.y);
    store2(dq + idx + 2, acc.z, acc.w);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  void *lse, *delta, *dq, *dk, *dv, *dq_part;
  int B, Sq, Sk, H;
  Strides qs, ks, vs, ds;
  int causal;
  float scale;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// mode 0: the dQ pass; mode 1: the dK/dV pass; modes 2 and 3: [the
// statistics (mode 3),] the single pass, the dQ sum
template <typename T, int D>
int launch(const Args& a, int mode, cudaStream_t stream) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  float* lse = static_cast<float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  const int n_qt = (a.Sq + kT - 1) / kT, n_kt = (a.Sk + kT - 1) / kT;
  cudaError_t e;
  if (mode == 0) {
    auto kernel = attention_bwd_dq_kernel<T, D>;
    const size_t smem = Tc<T, D>::kSmemQMajor;
    if ((e = allow_smem(kernel, smem)) != cudaSuccess) return e;
    kernel<<<dim3(a.H, a.B, n_qt), kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, static_cast<T*>(a.dq), a.Sq, a.Sk, a.H,
        a.qs, a.ks, a.vs, a.ds, a.causal, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode == 1) {
    auto kernel = attention_bwd_dkv_kernel<T, D>;
    const size_t smem = Tc<T, D>::kSmemFused;
    if ((e = allow_smem(kernel, smem)) != cudaSuccess) return e;
    kernel<<<dim3(a.H, a.B, n_kt), kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, a.Sq, a.Sk, a.H, a.qs, a.ks, a.vs,
        a.ds, a.causal, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode == 3) {
    auto stats = attention_bwd_stats_kernel<T, D>;
    const size_t smem = Tc<T, D>::kSmemQMajor;
    if ((e = allow_smem(stats, smem)) != cudaSuccess) return e;
    stats<<<dim3(a.H, a.B, n_qt), kThreads, smem, stream>>>(
        q, k, v, dout, lse, delta, a.Sq, a.Sk, a.H, a.qs, a.ks, a.vs, a.ds,
        a.causal, a.scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  float* part = static_cast<float*>(a.dq_part);
  auto fused = attention_bwd_fused_kernel<T, D>;
  const size_t smem = Tc<T, D>::kSmemFused;
  if ((e = allow_smem(fused, smem)) != cudaSuccess) return e;
  fused<<<dim3(a.H, a.B, n_kt), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, part, a.B, a.Sq, a.Sk, a.H, a.qs,
      a.ks, a.vs, a.ds, a.causal, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t n = static_cast<size_t>(a.B) * a.Sq * a.H * D;
  const size_t want = (n / 4 + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  dq_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      part, static_cast<T*>(a.dq), a.Sq, a.H, D, n_kt, a.causal, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Args& a, int D, int mode, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(a, mode, stream);
    case 128:
      return launch<T, 128>(a, mode, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// mode: 0 dQ (#7), 1 dK/dV (#8), 2 single pass with lse/delta given (#6),
// 3 folded: lse/delta are written by a first launch, then as mode 2
// (#10). dq_part: [ceil(Sk/64), B, Sq, H, D] f32 scratch for modes 2-3.
extern "C" int pt_attention_bwd(const void* q, const void* k, const void* v,
                                const void* dout, void* lse, void* delta,
                                void* dq, void* dk, void* dv, void* dq_part,
                                int B, int Sq, int Sk, int H, int D, int qsb,
                                int qss, int qsh, int ksb, int kss, int ksh,
                                int vsb, int vss, int vsh, int dsb, int dss,
                                int dsh, int causal, int dtype, float scale,
                                int mode, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0 || H == 0) return 0;
  if (mode < 0 || mode > 3) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,
               k,
               v,
               dout,
               lse,
               delta,
               dq,
               dk,
               dv,
               dq_part,
               B,
               Sq,
               Sk,
               H,
               {qsb, qss, qsh},
               {ksb, kss, ksh},
               {vsb, vss, vsh},
               {dsb, dss, dsh},
               causal,
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32) return dispatch_d<float>(a, D, mode, s);
  if (dtype == pt::kBF16) return dispatch_d<__nv_bfloat16>(a, D, mode, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
