// The bf16 attention backward tile loops on Hopper's tensor cores: dQ
// (`dq_tc_kernel`) and dK/dV (`dkv_tc_kernel`), used by
// csrc/flash_attention.cu (`fa_bwd_dq`, `fa_bwd_dkv`). The mask is a
// policy type, as in the forward of attn_fwd_sm90.cuh; see `dkv_tc_kernel`
// for what a policy provides.
//
// What they compute, per (batch*head) slice of contiguous (BH, S, D) bf16
// operands, from the forward's lse and delta = rowsum(dO * O) (fp32 (BH,
// sq) vectors): S = Q K^T, P = exp(S * scale - lse) over the pairs the
// policy keeps (0 elsewhere), dP = dO V^T, dS = P (dP - delta) scale; dQ =
// dS K, dK = dS^T Q and dV = P^T dO, written in bf16. This is the TPU
// backward (`_bwd_dq_kernel`, `_bwd_dkv_kernel` of paddle_tpu/ops/
// flash_attention.py) with the sequential axis of each grid turned into a
// loop inside the block. dQ has its own kernel, as there: nothing is
// reduced across blocks, no atomics, and results repeat from run to run.
//
// Design (mma.sync m16n8k16, bf16 in and fp32 accumulators; 4 warps of 16
// rows; tiles of 64 rows of DP bf16 in shared memory, swizzled and copied
// by cp.async as in the forward, whose PTX helpers and tile loader this
// header uses):
//   * dQ: one block per (batch*head, 64-row q tile), batch*head fastest,
//     the longest causal rows first. Q and dO are copied once; K and V go
//     through a ring of two stages, the next kept tile's copies issued
//     right after the one barrier of each tile. S = Q K^T and dP = dO V^T
//     take K and V by ldmatrix; P and dS are made in registers, in the
//     log2 domain (scale * log2(e) folded into S, lse * log2(e)
//     subtracted); dQ += dS K takes dS from the C fragments of S as A
//     fragments (the C layout of m16n8 is the A layout of m16n8k16) and K
//     by ldmatrix.trans. dS never leaves the registers.
//   * dK/dV: one block per (batch*head, 64-key tile), batch*head fastest,
//     the first k tiles first (under causal they visit the most q tiles);
//     warp w owns keys 16w .. 16w+15. K and V are copied once; Q, dO and
//     the q tile's lse and delta stream through the ring. Each q tile is
//     taken in two halves of 32 rows: S^T = K Q^T and dP^T = V dO^T come
//     out with keys as rows, so P^T and dS^T are A fragments in registers
//     for dV += P^T dO and dK += dS^T Q, with dO and Q by ldmatrix.trans.
//     lse and delta are per column here, read from the staged vectors.
//     Registers: the two 16 x DP fp32 accumulators take 128 a thread at
//     DP = 128. The halves and the k-steps of S^T and dP^T are loops, not
//     unrolled: unrolled, the kernel spilled 40-56 bytes at DP = 128
//     under the launch bound of two blocks an SM (255 registers; the
//     unrolled loop's lane-dependent ldmatrix offsets are the likely
//     cause); as loops it takes 252 and spills nothing.
//   * Masking selects 0 for every dropped pair after its product, so a
//     row past sq (lse and delta zero-filled) or a row that keeps nothing
//     (lse = -1e30) never brings an inf into a sum.
//   * Precision: S and dP multiply bf16 operands exactly. P and dS enter
//     their products as two bf16 terms, hi = bf16(x) and lo = bf16(x -
//     hi), 16 bits of each, as P does in the forward: the TPU kernels
//     multiply them in fp32, and one bf16 term moved outputs of rows (or
//     keys) that see few partners past the bf16 tolerance in the forward.
//
// What bounds it: 6 (dQ) and 8 (dK/dV) flops per kept pair and head dim
// against each operand byte once, hundreds of flops a byte at training
// shapes, so the bf16 tensor-core rate (989 TFLOP/s dense); the hi + lo
// terms make the tensor cores execute 8 and 12. mma.sync reaches a part
// of that rate; wgmma with TMA is the step after this one.
#pragma once

#include "attn_fwd_sm90.cuh"

namespace attn_bwd_sm90 {

using attn_fwd_sm90::cp_async4;
using attn_fwd_sm90::cp_async_commit;
using attn_fwd_sm90::cp_async_wait;
using attn_fwd_sm90::fast_exp2;
using attn_fwd_sm90::in_span;
using attn_fwd_sm90::kLog2e;
using attn_fwd_sm90::kStages;
using attn_fwd_sm90::kThreads;
using attn_fwd_sm90::kTileK;
using attn_fwd_sm90::kTileQ;
using attn_fwd_sm90::ldsm_x4;
using attn_fwd_sm90::load_tile;
using attn_fwd_sm90::mma_bf16;
using attn_fwd_sm90::mma_rows;
using attn_fwd_sm90::operands_ok;
using attn_fwd_sm90::pack_bf16;
using attn_fwd_sm90::Span;
using attn_fwd_sm90::split_a;
using attn_fwd_sm90::swz;
using attn_fwd_sm90::tile_grid;
using attn_fwd_sm90::TileScan;

// Write a warp's 16 x DP fp32 accumulator rows (this thread's rows r_a and
// r_a + 8 of a (rows, D) slice) as bf16 pairs; rows past `rows` and dims
// past D are not written.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (*acc)[4], int r_a,
                                           int rows, int D) {
  const int col_in = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_a + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* orow = out + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + col_in;
      if (d < D)
        *reinterpret_cast<unsigned*>(orow + d) =
            pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------ dQ
// The dQ loop takes of its policy what the forward's loop takes (see
// attn_fwd_sm90.cuh `fwd_tc_kernel`): begin, end, needed, full, stage,
// span and kExtraBytes; dropout is not part of it.
template <int DP, class P>
__global__ void __launch_bounds__(kThreads, 2)
    dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int sq, int sk, int D,
                 float scale, P pol) {
  constexpr int KS = DP / 16;  // k-steps of the score products
  constexpr int NB = DP / 8;   // 8-dim blocks of dQ
  constexpr int kTileElems = kTileQ * DP;
  extern __shared__ __align__(128) unsigned char bwd_tc_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(bwd_tc_smem);
  __nv_bfloat16* dos = qs + kTileElems;
  // stage s: K at kv0 + 2s tiles, V one tile after it
  __nv_bfloat16* kv0 = dos + kTileElems;
  unsigned char* extra0 =
      bwd_tc_smem + static_cast<size_t>(kTileElems) * 2 * (2 + 2 * kStages);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_qt = (sq + kTileQ - 1) / kTileQ;
  const int qt = static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
  if (qt >= n_qt) return;  // the last z slice's tail: the whole block
  const int q0 = (n_qt - 1 - qt) * kTileQ;
  const int bh = blockIdx.x;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * sk * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * sk * D;
  pol.begin(bh, q0, sq, sk);

  // this thread's two rows: fragment rows lane/4 and lane/4 + 8
  const int row_a = q0 + warp * 16 + lane / 4;
  const int row_b = row_a + 8;
  const int col_in = 2 * (lane % 4);
  const float sl2 = scale * kLog2e;
  float lse2[2], dl[2];  // lse in the log2 domain, and delta, per row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    lse2[r] = row < sq ? lse[qoff + row] * kLog2e : 0.f;
    dl[r] = row < sq ? delta[qoff + row] : 0.f;
  }
  float acc[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int kt_end = pol.end();
  TileScan scan;
  auto needed = [&](int t) { return pol.needed(t); };
  auto issue = [&](int kt, int st, bool whole) {
    __nv_bfloat16* ks = kv0 + 2 * st * kTileElems;
    load_tile<DP>(ks, kb, kt * kTileK, sk, D);
    load_tile<DP>(ks + kTileElems, vb, kt * kTileK, sk, D);
    if (!whole) pol.stage(kt, extra0 + st * P::kExtraBytes);
  };

  int kt = scan.next(0, kt_end, needed);
  bool full = kt < kt_end && pol.full(kt);
  if (kt < kt_end) {
    load_tile<DP>(qs, q + qoff * D, q0, sq, D);
    load_tile<DP>(dos, dout + qoff * D, q0, sq, D);
    issue(kt, 0, full);
    cp_async_commit();
  }
  int st = 0;
  while (kt < kt_end) {
    cp_async_wait<0>();
    // tile kt (and, the first time, Q and dO) has landed for every
    // thread, and every warp is done with the previous tile, whose stage
    // the next tile's copies refill while this one computes
    __syncthreads();
    const int nxt = scan.next(kt + 1, kt_end, needed);
    const bool full_nxt = nxt < kt_end && pol.full(nxt);
    if (nxt < kt_end) {
      issue(nxt, st ^ 1, full_nxt);
      cp_async_commit();
    }
    const __nv_bfloat16* ks = kv0 + 2 * st * kTileElems;
    const __nv_bfloat16* vs = ks + kTileElems;
    const unsigned char* extra = extra0 + st * P::kExtraBytes;
    const int k0 = kt * kTileK;

    // S = Q K^T and dP = dO V^T: 8 blocks of 8 keys, C fragments
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int t = 0; t < KS; ++t) {
      unsigned a[4], g[4];
      const int aoff = swz<DP>(warp * 16 + (lane % 16), 2 * t + lane / 16);
      ldsm_x4(a, qs + aoff);
      ldsm_x4(g, dos + aoff);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int boff = swz<DP>(jp * 16 + (lane % 8) + (lane / 16) * 8,
                                 2 * t + (lane / 8) % 2);
        unsigned b[4];
        ldsm_x4(b, ks + boff);
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
        ldsm_x4(b, vs + boff);
        mma_bf16(dp[2 * jp], g, b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], g, b[2], b[3]);
      }
    }

    // dS = P (dP - delta) scale into s, P = exp2(S sl2 - lse2); the pairs
    // a partial tile drops select 0
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[j][e], sl2, -lse2[e / 2]));
        s[j][e] = p * (dp[j][e] - dl[e / 2]) * scale;
      }
    if (!full) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + col_in + e;
          const Span sp = pol.span(k0 + c, c, extra);
          if (!in_span(sp, row_a)) s[j][e] = 0.f;
          if (!in_span(sp, row_b)) s[j][2 + e] = 0.f;
        }
      }
    }

    // dQ += dS K, 16 keys at a time, dS as hi + lo
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      unsigned hi[4], lo[4];
      split_a(s[2 * t], s[2 * t + 1], hi, lo);
      mma_rows<DP>(acc, hi, lo, ks, 16 * t);
    }
    kt = nxt;
    full = full_nxt;
    st ^= 1;
  }
  store_rows<DP>(dq + qoff * D, acc, row_a, sq, D);
}

// --------------------------------------------------------------- dK/dV
// Besides what the dQ loop takes, a policy P provides, all uniform across
// the block except `key_span`:
//   void begin_k(int bh, int k0, int sq, int sk);  this block's k tile
//   int q_begin() const;           q tiles [q_begin(), q_end()) may be
//   int q_end() const;             visited by the k tile
//   bool needed_q(int qt) const;   false: the (qt, k tile) pair is skipped
//                                  unloaded
//   bool full_q(int qt) const;     true: every pair of it is kept
//   Span key_span(int col) const;  the rows key column col keeps; each
//                                  thread asks once for its two keys
constexpr int kSub = 32;  // q rows of one part of a q tile

template <int DP>
constexpr size_t dq_smem_bytes(size_t extra) {
  return static_cast<size_t>(kTileQ) * DP * 2 * (2 + 2 * kStages) +
         static_cast<size_t>(kStages) * extra;
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return static_cast<size_t>(kTileQ) * DP * 2 * (2 + 2 * kStages) +
         static_cast<size_t>(kStages) * 2 * kTileQ * sizeof(float);
}

template <int DP, class P>
__global__ void __launch_bounds__(kThreads, 2)
    dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int sq, int sk, int D,
                  float scale, P pol) {
  constexpr int KS = DP / 16;
  constexpr int NB = DP / 8;
  constexpr int kTileElems = kTileQ * DP;
  extern __shared__ __align__(128) unsigned char bwd_tc_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(bwd_tc_smem);
  __nv_bfloat16* vs = ks + kTileElems;
  // stage s: Q at qd0 + 2s tiles, dO one tile after it; its lse and delta
  // at vec0 + 2s * kTileQ floats, delta kTileQ after lse
  __nv_bfloat16* qd0 = vs + kTileElems;
  float* vec0 = reinterpret_cast<float*>(
      bwd_tc_smem + static_cast<size_t>(kTileElems) * 2 * (2 + 2 * kStages));

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_kt = (sk + kTileK - 1) / kTileK;
  const int kt = static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
  if (kt >= n_kt) return;
  const int k0 = kt * kTileK;
  const int bh = blockIdx.x;
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const size_t koff = static_cast<size_t>(bh) * sk;
  const __nv_bfloat16* qb = q + qoff * D;
  const __nv_bfloat16* ob = dout + qoff * D;
  pol.begin_k(bh, k0, sq, sk);

  // this thread's two keys: fragment rows lane/4 and lane/4 + 8
  const int key_a = k0 + warp * 16 + lane / 4;
  const Span sp[2] = {pol.key_span(key_a), pol.key_span(key_a + 8)};
  const int col_in = 2 * (lane % 4);
  const float sl2 = scale * kLog2e;
  float dka[NB][4], dva[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int qt_end = pol.q_end();
  TileScan scan;
  auto needed = [&](int t) { return pol.needed_q(t); };
  auto issue = [&](int qt, int st) {
    const int q0 = qt * kTileQ;
    __nv_bfloat16* qs = qd0 + 2 * st * kTileElems;
    load_tile<DP>(qs, qb, q0, sq, D);
    load_tile<DP>(qs + kTileElems, ob, q0, sq, D);
    // thread i copies lse (i < 64) or delta (i >= 64) of row q0 + i % 64
    const int r = threadIdx.x % kTileQ;
    const float* src = (threadIdx.x < kTileQ ? lse : delta) + qoff;
    const bool in = q0 + r < sq;
    cp_async4(vec0 + 2 * st * kTileQ + threadIdx.x, in ? src + q0 + r : src,
              in ? 4 : 0);
  };

  int qt = scan.next(pol.q_begin(), qt_end, needed);
  bool full = qt < qt_end && pol.full_q(qt);
  if (qt < qt_end) {
    load_tile<DP>(ks, k + koff * D, k0, sk, D);
    load_tile<DP>(vs, v + koff * D, k0, sk, D);
    issue(qt, 0);
    cp_async_commit();
  }
  int st = 0;
  while (qt < qt_end) {
    cp_async_wait<0>();
    __syncthreads();  // as in the dQ loop
    const int nxt = scan.next(qt + 1, qt_end, needed);
    const bool full_nxt = nxt < qt_end && pol.full_q(nxt);
    if (nxt < qt_end) {
      issue(nxt, st ^ 1);
      cp_async_commit();
    }
    const __nv_bfloat16* qs = qd0 + 2 * st * kTileElems;
    const __nv_bfloat16* dos = qs + kTileElems;
    const float* ls = vec0 + 2 * st * kTileQ;
    const float* dl = ls + kTileQ;
    const int q0 = qt * kTileQ;

#pragma unroll 1
    for (int h = 0; h < kTileQ / kSub; ++h) {
      // S^T = K Q^T and dP^T = V dO^T over the part's kSub q rows: blocks
      // of 8 rows, C fragments with keys as rows
      float s[kSub / 8][4], dpt[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dpt[j][e] = 0.f;
#pragma unroll 1
      for (int t = 0; t < KS; ++t) {
        unsigned a[4], w[4];
        const int aoff = swz<DP>(warp * 16 + (lane % 16), 2 * t + lane / 16);
        ldsm_x4(a, ks + aoff);
        ldsm_x4(w, vs + aoff);
#pragma unroll
        for (int jp = 0; jp < kSub / 16; ++jp) {
          const int boff =
              swz<DP>(kSub * h + jp * 16 + (lane % 8) + (lane / 16) * 8,
                      2 * t + (lane / 8) % 2);
          unsigned b[4];
          ldsm_x4(b, qs + boff);
          mma_bf16(s[2 * jp], a, b[0], b[1]);
          mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
          ldsm_x4(b, dos + boff);
          mma_bf16(dpt[2 * jp], w, b[0], b[1]);
          mma_bf16(dpt[2 * jp + 1], w, b[2], b[3]);
        }
      }

      // P^T into s and dS^T into dpt; column c is q row q0 + c, with its
      // lse and delta from the staged vectors
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = kSub * h + 8 * j + col_in + e;
          const float l2 = ls[c] * kLog2e;
          const float dlt = dl[c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float p = fast_exp2(fmaf(s[j][2 * r + e], sl2, -l2));
            float ds = p * (dpt[j][2 * r + e] - dlt) * scale;
            if (!full && !in_span(sp[r], q0 + c)) p = ds = 0.f;
            s[j][2 * r + e] = p;
            dpt[j][2 * r + e] = ds;
          }
        }
      }

      // dV += P^T dO and dK += dS^T Q, 16 q rows at a time, as hi + lo
#pragma unroll
      for (int t = 0; t < kSub / 16; ++t) {
        unsigned hi[4], lo[4];
        split_a(s[2 * t], s[2 * t + 1], hi, lo);
        mma_rows<DP>(dva, hi, lo, dos, kSub * h + 16 * t);
        split_a(dpt[2 * t], dpt[2 * t + 1], hi, lo);
        mma_rows<DP>(dka, hi, lo, qs, kSub * h + 16 * t);
      }
    }
    qt = nxt;
    full = full_nxt;
    st ^= 1;
  }
  store_rows<DP>(dk + koff * D, dka, key_a, sk, D);
  store_rows<DP>(dv + koff * D, dva, key_a, sk, D);
}

// ---------------------------------------------------------------- launch
template <int DP, class P>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int sq, int sk, int d, float scale,
                      const P& pol, cudaStream_t stream) {
  auto kernel = dq_tc_kernel<DP, P>;
  constexpr size_t smem = dq_smem_bytes<DP>(P::kExtraBytes);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<tile_grid(bh, (sq + kTileQ - 1) / kTileQ), kThreads, smem,
           stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), sq, sk, d, scale, pol);
  return cudaGetLastError();
}

template <int DP, class P>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int sq, int sk, int d,
                       float scale, const P& pol, cudaStream_t stream) {
  auto kernel = dkv_tc_kernel<DP, P>;
  constexpr size_t smem = dkv_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<tile_grid(bh, (sk + kTileK - 1) / kTileK), kThreads, smem,
           stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sq,
      sk, d, scale, pol);
  return cudaGetLastError();
}

// Dispatch on the padded head dim (32, 64 or 128).
template <class P>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int sq, int sk, int d, float scale,
                   const P& pol, cudaStream_t stream) {
  if (!operands_ok(d, {q, k, v, dout, dq})) return cudaErrorInvalidValue;
  if (d <= 32)
    return launch_dq<32>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale,
                         pol, stream);
  if (d <= 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale,
                         pol, stream);
  return launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale,
                        pol, stream);
}

template <class P>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int bh, int sq, int sk, int d,
                    float scale, const P& pol, cudaStream_t stream) {
  if (!operands_ok(d, {q, k, v, dout, dk, dv})) return cudaErrorInvalidValue;
  if (d <= 32)
    return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                          scale, pol, stream);
  if (d <= 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                          scale, pol, stream);
  return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                         scale, pol, stream);
}

}  // namespace attn_bwd_sm90
