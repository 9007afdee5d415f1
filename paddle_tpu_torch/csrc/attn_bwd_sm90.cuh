// The bf16 attention backward tile loops on Hopper's tensor cores: dQ
// (`dq_tc_kernel`) and dK/dV (`dkv_tc_kernel`), used by
// csrc/flash_attention.cu (`fa_bwd_dq`, `fa_bwd_dkv`),
// csrc/flashmask_attention.cu (`fm_bwd_dq`, `fm_bwd_dkv`) and
// csrc/varlen_attention.cu (`va_bwd_dq`, `va_bwd_dkv`). The mask is a
// policy type, as in the forward of attn_fwd_sm90.cuh; see `dkv_tc_kernel`
// for what a policy provides. Where the operands' rows lie is a layout
// type (`BwdLayout`, `ContiguousBwdLayout`), as the forward's `Layout`.
//
// What they compute, per query slice (a batch*head of contiguous (BH, S,
// D) bf16 operands, or a query head of packed (T, H, D) ones), from the
// forward's lse and delta = rowsum(dO * O) (fp32, at slice * sq + row):
// S = Q K^T, P = exp(S * scale - lse) over the pairs the policy keeps (0
// elsewhere), dP = dropped(dO V^T), dS = P (dP - delta) scale; dQ = dS K,
// dK = dS^T Q and dV = dropped(P)^T dO, written in bf16 (dropped: the
// policy's dropout, where it has one), dK and dV summed over the query
// slices of a KV slice (a GQA group) in fp32 registers. This is the TPU
// backward (`_bwd_dq_kernel`, `_bwd_dkv_kernel` of paddle_tpu/ops/
// flash_attention.py and flashmask_attention.py, `_vbwd_dq_kernel`,
// `_vbwd_dkv_kernel` of varlen_attention.py) with the sequential axis of
// each grid turned into a loop inside the block. dQ has its own kernel,
// as there: nothing is reduced across blocks, no atomics, and results
// repeat from run to run.
//
// Design (mma.sync m16n8k16, bf16 in and fp32 accumulators; 4 warps of 16
// rows; tiles of 64 rows of DP bf16 in shared memory, swizzled and copied
// by cp.async as in the forward, whose PTX helpers and tile loader this
// header uses):
//   * dQ: one block per (query slice, 64-row q tile), slices fastest (the
//     query heads of one KV head side by side, sharing its K/V tiles
//     through L2), the longest causal rows first. Q and dO are copied
//     once; K and V go through a ring of two stages, the next kept tile's
//     copies issued right after the one barrier of each tile. S = Q K^T
//     and dP = dO V^T take K and V by ldmatrix; P and dS are made in
//     registers, in the log2 domain (scale * log2(e) folded into S, lse *
//     log2(e) subtracted); dQ += dS K takes dS from the C fragments of S
//     as A fragments (the C layout of m16n8 is the A layout of m16n8k16)
//     and K by ldmatrix.trans. dS never leaves the registers.
//   * dK/dV: one block per (KV slice, 64-key tile), slices fastest, the
//     first k tiles first (under causal they visit the most q tiles);
//     warp w owns keys 16w .. 16w+15. K and V are copied once; Q, dO and
//     the q tile's lse and delta stream through the ring. A block walks
//     the query slices of its GQA group one after another, each over its
//     q tiles, into the same accumulators; the next slice's first q tile
//     enters the ring while the last one of the slice before computes, so
//     the ring does not drain at a slice boundary. Each q tile is
//     taken in two halves of 32 rows: S^T = K Q^T and dP^T = V dO^T come
//     out with keys as rows, so P^T and dS^T are A fragments in registers
//     for dV += P^T dO and dK += dS^T Q, with dO and Q by ldmatrix.trans.
//     lse and delta are per column here, read from the staged vectors.
//     Registers: the two 16 x DP fp32 accumulators take 128 a thread at
//     DP = 128. The halves and the k-steps of S^T and dP^T are loops, not
//     unrolled: unrolled, the kernel spilled 40-56 bytes at DP = 128
//     under the launch bound of two blocks an SM (255 registers; the
//     unrolled loop's lane-dependent ldmatrix offsets are the likely
//     cause); as loops it takes 250 (FlashPolicy) and 255 (FmPolicy) and
//     spills nothing. The rows each of a thread's two keys keeps (a Span)
//     are asked of the policy on each half of a partial tile: held through
//     the loop, FmPolicy's twelve ints spilled it (46 bytes); read back
//     from shared memory instead, FlashPolicy's loop spilled (120 bytes).
//     A policy with a per-row test (kRowTest) is asked for its two keys'
//     test data the same way, and tests them against the q tile's row
//     data staged beside lse and delta.
//   * Wide heads (DP = 192 or 256): a block owns 64 columns of its output
//     (`out_cols`, the chunk a grid axis folded into x beside the slices),
//     as in the forward. It forms S and dP (or S^T and dP^T) over the
//     whole head dim from DP-wide tiles and accumulates only its columns
//     of dQ (from K's) or of dK and dV (from Q's and dO's). The two 16 x
//     DP fp32 accumulators of the dK/dV loop would take 256 registers a
//     thread at DP = 256; a chunk takes 64. Chunk 0 alone counts tiles.
//     Shared memory stays six DP-wide tiles: 192 KB at DP = 256, one block
//     an SM.
//   * Masking selects 0 for every dropped pair after its product, so a
//     row past sq (lse and delta zero-filled) or a row that keeps nothing
//     (lse = -1e30) never brings an inf into a sum.
//   * Dropout is a template flag of each loop (kDrop), set when the
//     policy may drop (P::kMayDrop) and does for this launch: the
//     instantiations without it compile to the loops without a hash, so
//     the dK/dV loop keeps its registers. dQ drops dP before dS; dK/dV
//     drops dP^T before dS^T and P^T before dV, each pair by the policy's
//     hash of its absolute (q row, key) coordinates.
//   * With a tile counter, thread 0 adds one for every tile computed (the
//     counter is a launch argument, so the loop keeps no count).
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

#include <type_traits>

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
using attn_fwd_sm90::out_cols;
using attn_fwd_sm90::pack_bf16;
using attn_fwd_sm90::Span;
using attn_fwd_sm90::split_a;
using attn_fwd_sm90::swz;
using attn_fwd_sm90::tile_grid;
using attn_fwd_sm90::TileScan;

// Where the operands' rows lie, in elements, as the forward's `Layout`:
// query slice bh's q, dO and dQ start at bh * *_hs and their row r at
// + r * *_rs; its K and V are those of slice bh / group, and so are the
// dK and dV its pairs add to. Every stride is a multiple of 8 (16-byte
// copies). `BwdLayout` takes any strides (packed (T, H, D) operands, GQA
// in place); `ContiguousBwdLayout` is (BH, S, D) slices, whose group is 1
// at compile time, so the dK/dV loop's walk over a group's slices
// compiles away, and whose strides are three values under the twelve
// names (every row stride is the head dim): as twelve fields they cost
// FlashPolicy's dK/dV loop at DP = 128 two registers and spilled
// FmPolicy's.
struct BwdLayout {
  long long q_rs, q_hs, k_rs, k_hs, v_rs, v_hs, do_rs, do_hs, dq_rs, dq_hs,
      dkv_rs, dkv_hs;
  int group;
};

struct ContiguousBwdLayout {
  static constexpr int group = 1;
  union {
    int q_rs, k_rs, v_rs, do_rs, dq_rs, dkv_rs;
  };
  union {
    long long q_hs, do_hs, dq_hs;  // sq * D
  };
  union {
    long long k_hs, v_hs, dkv_hs;  // sk * D
  };
};

inline ContiguousBwdLayout contiguous_bwd_layout(int sq, int sk, int d) {
  ContiguousBwdLayout l;
  l.q_rs = d;
  l.q_hs = static_cast<long long>(sq) * d;
  l.k_hs = static_cast<long long>(sk) * d;
  return l;
}

inline bool strides_ok(const BwdLayout& l) {
  for (long long st : {l.q_rs, l.q_hs, l.k_rs, l.k_hs, l.v_rs, l.v_hs,
                       l.do_rs, l.do_hs, l.dq_rs, l.dq_hs, l.dkv_rs,
                       l.dkv_hs})
    if (st % 8 != 0) return false;
  return l.group >= 1;
}
inline bool strides_ok(const ContiguousBwdLayout&) { return true; }

// Write a warp's 16 x DP fp32 accumulator rows (this thread's rows r_a and
// r_a + 8 of a (rows, D) slice whose rows lie rs apart; DP columns from
// `out`) as bf16 pairs; rows past `rows` and dims past D are not written.
template <int DP, class RS>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (*acc)[4], int r_a,
                                           int rows, int D, RS rs) {
  const int col_in = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_a + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* orow = out + static_cast<long long>(row) * rs;
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
// kExtraBytes, kRowTest and by it span, or rows and keep, and, with kDrop,
// drop; and kMayDrop (see run_dq).
template <int DP, class P, class L, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, const L lay, int sq, int sk,
                 int D, float scale, P pol, int* __restrict__ tile_count) {
  constexpr int KS = DP / 16;  // k-steps of the score products
  constexpr int DV = out_cols<DP>();  // dQ columns of this block
  constexpr int NCH = DP / DV;
  constexpr int NB = DV / 8;   // 8-dim blocks of dQ
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
  // x: the slices fastest, then dQ's column chunks
  const int bh = NCH == 1 ? static_cast<int>(blockIdx.x)
                          : static_cast<int>(blockIdx.x % (gridDim.x / NCH));
  const int c0 =
      NCH == 1 ? 0 : static_cast<int>(blockIdx.x / (gridDim.x / NCH)) * DV;
  const int bkv = bh / lay.group;
  const size_t qoff = static_cast<size_t>(bh) * sq;  // lse and delta
  const __nv_bfloat16* kb = k + bkv * lay.k_hs;
  const __nv_bfloat16* vb = v + bkv * lay.v_hs;
  pol.begin(bh, q0, sq, sk);

  // this thread's two rows: fragment rows lane/4 and lane/4 + 8
  const int row_a = q0 + warp * 16 + lane / 4;
  const int row_b = row_a + 8;
  if constexpr (P::kRowTest) pol.rows(row_a, row_b);
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
    load_tile<DP>(ks, kb, kt * kTileK, sk, D, lay.k_rs);
    load_tile<DP>(ks + kTileElems, vb, kt * kTileK, sk, D, lay.v_rs);
    if (!whole) pol.stage(kt, extra0 + st * P::kExtraBytes);
  };

  int kt = scan.next(0, kt_end, needed);
  bool full = kt < kt_end && pol.full(kt);
  if (kt < kt_end) {
    load_tile<DP>(qs, q + bh * lay.q_hs, q0, sq, D, lay.q_rs);
    load_tile<DP>(dos, dout + bh * lay.do_hs, q0, sq, D, lay.do_rs);
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
    if (tile_count != nullptr && threadIdx.x == 0 && c0 == 0)
      atomicAdd(tile_count, 1);
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

    // dS = P (dP - delta) scale into s, P = exp2(S sl2 - lse2), dP
    // dropped first under dropout; the pairs a partial tile drops select 0
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[j][e], sl2, -lse2[e / 2]));
        float g = dp[j][e];
        if constexpr (kDrop)
          g = pol.drop(g, e < 2 ? row_a : row_b, k0 + 8 * j + col_in + e % 2);
        s[j][e] = p * (g - dl[e / 2]) * scale;
      }
    if (!full) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + col_in + e;
          bool keep_a, keep_b;
          if constexpr (P::kRowTest) {
            pol.keep(c, extra, keep_a, keep_b);
          } else {
            const Span sp = pol.span(k0 + c, c, extra);
            keep_a = in_span(sp, row_a);
            keep_b = in_span(sp, row_b);
          }
          if (!keep_a) s[j][e] = 0.f;
          if (!keep_b) s[j][2 + e] = 0.f;
        }
      }
    }

    // dQ += dS K, 16 keys at a time, dS as hi + lo
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      unsigned hi[4], lo[4];
      split_a(s[2 * t], s[2 * t + 1], hi, lo);
      mma_rows<DP, DV>(acc, hi, lo, ks, 16 * t, c0);
    }
    kt = nxt;
    full = full_nxt;
    st ^= 1;
  }
  store_rows<DV>(dq + bh * lay.dq_hs + c0, acc, row_a, sq, min(D - c0, DV),
                 lay.dq_rs);
}

// --------------------------------------------------------------- dK/dV
// Besides what the dQ loop takes, a policy P provides, all uniform across
// the block except `key_span`, `keys` and `keep_q`, and the same for every
// query slice of a KV slice's group:
//   void begin_k(int bkv, int k0, int sq, int sk);  this block's k tile
//                                  of KV slice bkv
//   int q_begin() const;           q tiles [q_begin(), q_end()) may be
//   int q_end() const;             visited by the k tile
//   bool needed_q(int qt) const;   false: the (qt, k tile) pair is skipped
//                                  unloaded
//   bool full_q(int qt) const;     true: every pair of it is kept
//   Span key_span(int col) const;  (kRowTest false) the rows key column
//                                  col keeps; each thread asks for its two
//                                  keys on each part of a partial tile
//   void stage_q(int qt, void* extra) const;  (kRowTest true) copy the q
//                                  tile's row data (kExtraBytes) into
//                                  `extra`, partial tiles only
//   void keys(int key_a, int key_b);  (kRowTest true) this thread's keys,
//                                  asked on each part of a partial tile
//   void keep_q(int c, const void* extra, bool& a, bool& b) const;
//                                  (kRowTest true) whether keys a and b
//                                  keep row c of the staged q tile
// With kDrop, drop(x, q row, key) gives what feeds dS^T (x = dP^T) and dV
// (x = P^T).
constexpr int kSub = 32;  // q rows of one part of a q tile

template <int DP>
constexpr size_t dq_smem_bytes(size_t extra) {
  return static_cast<size_t>(kTileQ) * DP * 2 * (2 + 2 * kStages) +
         static_cast<size_t>(kStages) * extra;
}

// Bytes a stage of the dK/dV ring gives the policy: a kRowTest policy's
// q-tile row data; a span policy reads its keys in place and takes none.
template <class P>
__host__ __device__ constexpr size_t dkv_extra_bytes() {
  return P::kRowTest ? P::kExtraBytes : 0;
}

template <int DP, class P>
constexpr size_t dkv_smem_bytes() {
  return static_cast<size_t>(kTileQ) * DP * 2 * (2 + 2 * kStages) +
         static_cast<size_t>(kStages) *
             (2 * kTileQ * sizeof(float) + dkv_extra_bytes<P>());
}

template <int DP, class P, class L, bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, const L lay, int sq,
                  int sk, int D, float scale, P pol,
                  int* __restrict__ tile_count) {
  constexpr int KS = DP / 16;
  constexpr int DV = out_cols<DP>();  // dK and dV columns of this block
  constexpr int NCH = DP / DV;
  constexpr int NB = DV / 8;
  constexpr int kTileElems = kTileQ * DP;
  constexpr size_t kExtra = dkv_extra_bytes<P>();
  extern __shared__ __align__(128) unsigned char bwd_tc_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(bwd_tc_smem);
  __nv_bfloat16* vs = ks + kTileElems;
  // stage s: Q at qd0 + 2s tiles, dO one tile after it; its lse and delta
  // at vec0 + 2s * kTileQ floats, delta kTileQ after lse; its policy bytes
  // at extra0 + s * kExtra
  __nv_bfloat16* qd0 = vs + kTileElems;
  float* vec0 = reinterpret_cast<float*>(
      bwd_tc_smem + static_cast<size_t>(kTileElems) * 2 * (2 + 2 * kStages));
  unsigned char* extra0 =
      reinterpret_cast<unsigned char*>(vec0 + 2 * kStages * kTileQ);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_kt = (sk + kTileK - 1) / kTileK;
  const int kt = static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
  if (kt >= n_kt) return;
  const int k0 = kt * kTileK;
  // this block's KV slice, and the first query slice of its group: the
  // base pointers of q and dO and the lse/delta offset are computed here
  // once and stepped to the next slice by the walk; dK and dV's offset is
  // computed here too (computed after the loop, it spilled FmPolicy's
  // loop at DP = 128: 24 bytes)
  // x: the KV slices fastest, then dK and dV's column chunks
  const int bkv = NCH == 1 ? static_cast<int>(blockIdx.x)
                           : static_cast<int>(blockIdx.x % (gridDim.x / NCH));
  const int c0 =
      NCH == 1 ? 0 : static_cast<int>(blockIdx.x / (gridDim.x / NCH)) * DV;
  const int bh0 = bkv * lay.group;
  size_t qoff = static_cast<size_t>(bh0) * sq;
  const size_t kvoff = static_cast<size_t>(bkv) * lay.dkv_hs + c0;
  const __nv_bfloat16* qb = q + bh0 * lay.q_hs;
  const __nv_bfloat16* ob = dout + bh0 * lay.do_hs;
  pol.begin_k(bkv, k0, sq, sk);

  // this thread's two keys: fragment rows lane/4 and lane/4 + 8
  const int key_a = k0 + warp * 16 + lane / 4;
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
  auto issue = [&](int qt, int st, bool whole) {
    const int q0 = qt * kTileQ;
    __nv_bfloat16* qs = qd0 + 2 * st * kTileElems;
    load_tile<DP>(qs, qb, q0, sq, D, lay.q_rs);
    load_tile<DP>(qs + kTileElems, ob, q0, sq, D, lay.do_rs);
    // thread i copies lse (i < 64) or delta (i >= 64) of row q0 + i % 64
    const int r = threadIdx.x % kTileQ;
    const float* src = (threadIdx.x < kTileQ ? lse : delta) + qoff;
    const bool in = q0 + r < sq;
    cp_async4(vec0 + 2 * st * kTileQ + threadIdx.x, in ? src + q0 + r : src,
              in ? 4 : 0);
    if constexpr (P::kRowTest) {
      if (!whole) pol.stage_q(qt, extra0 + st * kExtra);
    }
  };

  int qt = scan.next(pol.q_begin(), qt_end, needed);
  bool full = qt < qt_end && pol.full_q(qt);
  if (qt < qt_end) {
    load_tile<DP>(ks, k + bkv * lay.k_hs, k0, sk, D, lay.k_rs);
    load_tile<DP>(vs, v + bkv * lay.v_hs, k0, sk, D, lay.v_rs);
    issue(qt, 0, full);
    cp_async_commit();
  }
  int st = 0;
  int slice = 0;  // the query slice bh0 + slice whose tiles are issued
  while (qt < qt_end) {
    cp_async_wait<0>();
    __syncthreads();  // as in the dQ loop
    int nxt = scan.next(qt + 1, qt_end, needed);
    if (lay.group > 1 && nxt == qt_end && ++slice < lay.group) {
      // the group's next query slice: every slice visits the same q
      // tiles, and its first enters the ring while this one computes
      qb += lay.q_hs;
      ob += lay.do_hs;
      qoff += sq;
      scan = TileScan{};
      nxt = scan.next(pol.q_begin(), qt_end, needed);
    }
    const bool full_nxt = nxt < qt_end && pol.full_q(nxt);
    if (nxt < qt_end) {
      issue(nxt, st ^ 1, full_nxt);
      cp_async_commit();
    }
    if (tile_count != nullptr && threadIdx.x == 0 && c0 == 0)
      atomicAdd(tile_count, 1);
    const __nv_bfloat16* qs = qd0 + 2 * st * kTileElems;
    const __nv_bfloat16* dos = qs + kTileElems;
    const float* ls = vec0 + 2 * st * kTileQ;
    const float* dl = ls + kTileQ;
    const unsigned char* extra = extra0 + st * kExtra;
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

      // P^T into s and dS^T into dpt (under dropout, dP^T dropped before
      // dS^T and P^T after it); column c is q row q0 + c, with its lse and
      // delta from the staged vectors
      // the rows this thread's two keys keep (or their test data), asked
      // of the policy on each part of a partial tile: held in registers
      // through the loop (or read back from shared memory), FmPolicy's
      // spans spilled the loop at DP = 128
      Span sp[2];
      if constexpr (P::kRowTest) {
        if (!full) pol.keys(key_a, key_a + 8);
      } else if (!full) {
        sp[0] = pol.key_span(key_a);
        sp[1] = pol.key_span(key_a + 8);
      }
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = kSub * h + 8 * j + col_in + e;
          const float l2 = ls[c] * kLog2e;
          const float dlt = dl[c];
          bool keep[2] = {true, true};
          if constexpr (P::kRowTest) {
            if (!full) pol.keep_q(c, extra, keep[0], keep[1]);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float p = fast_exp2(fmaf(s[j][2 * r + e], sl2, -l2));
            float g = dpt[j][2 * r + e];
            if constexpr (kDrop) g = pol.drop(g, q0 + c, key_a + 8 * r);
            float ds = p * (g - dlt) * scale;
            if constexpr (kDrop) p = pol.drop(p, q0 + c, key_a + 8 * r);
            if constexpr (P::kRowTest) {
              if (!keep[r]) p = ds = 0.f;
            } else {
              if (!full && !in_span(sp[r], q0 + c)) p = ds = 0.f;
            }
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
        mma_rows<DP, DV>(dva, hi, lo, dos, kSub * h + 16 * t, c0);
        split_a(dpt[2 * t], dpt[2 * t + 1], hi, lo);
        mma_rows<DP, DV>(dka, hi, lo, qs, kSub * h + 16 * t, c0);
      }
    }
    qt = nxt;
    full = full_nxt;
    st ^= 1;
  }
  store_rows<DV>(dk + kvoff, dka, key_a, sk, min(D - c0, DV), lay.dkv_rs);
  store_rows<DV>(dv + kvoff, dva, key_a, sk, min(D - c0, DV), lay.dkv_rs);
}

// ---------------------------------------------------------------- launch
// bh: the query slices (batch*heads, or query heads of packed operands).
template <int DP, class P, class L, bool kDrop>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const L& lay, int bh, int sq, int sk, int d,
                      float scale, const P& pol, int* tile_count,
                      cudaStream_t stream) {
  auto kernel = dq_tc_kernel<DP, P, L, kDrop>;
  constexpr size_t smem = dq_smem_bytes<DP>(P::kExtraBytes);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<tile_grid(bh * (DP / out_cols<DP>()), (sq + kTileQ - 1) / kTileQ),
           kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), lay, sq, sk, d, scale, pol,
      tile_count);
  return cudaGetLastError();
}

// One block per (KV slice, k tile): bh / group KV slices.
template <int DP, class P, class L, bool kDrop>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const L& lay, int bh, int sq,
                       int sk, int d, float scale, const P& pol,
                       int* tile_count, cudaStream_t stream) {
  auto kernel = dkv_tc_kernel<DP, P, L, kDrop>;
  constexpr size_t smem = dkv_smem_bytes<DP, P>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<tile_grid(bh / lay.group * (DP / out_cols<DP>()),
                     (sk + kTileK - 1) / kTileK),
           kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), lay,
      sq, sk, d, scale, pol, tile_count);
  return cudaGetLastError();
}

// f(std::true_type) when the policy drops on this launch, else
// f(std::false_type); a policy that never drops (P::kMayDrop false)
// instantiates only the second.
template <class P, class F>
cudaError_t by_dropout(const P& pol, F f) {
  if constexpr (P::kMayDrop) {
    if (pol.drops()) return f(std::true_type{});
  }
  return f(std::false_type{});
}

// Dispatch on dropout and the padded head dim (32, 64, 128, 192 or 256), for
// operands where `lay` says. tile_count: null, or one int to which the
// number of computed (q tile, k tile, query slice) triples is added.
template <class P, class L>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, const L& lay, int bh, int sq, int sk, int d,
                   float scale, const P& pol, int* tile_count,
                   cudaStream_t stream) {
  if (!operands_ok(d, {q, k, v, dout, dq}) || !strides_ok(lay))
    return cudaErrorInvalidValue;
  return by_dropout(pol, [&](auto drop) {
    constexpr bool kDrop = decltype(drop)::value;
    if (d <= 32)
      return launch_dq<32, P, L, kDrop>(q, k, v, dout, lse, delta, dq, lay,
                                        bh, sq, sk, d, scale, pol,
                                        tile_count, stream);
    if (d <= 64)
      return launch_dq<64, P, L, kDrop>(q, k, v, dout, lse, delta, dq, lay,
                                        bh, sq, sk, d, scale, pol,
                                        tile_count, stream);
    if (d <= 128)
      return launch_dq<128, P, L, kDrop>(q, k, v, dout, lse, delta, dq, lay,
                                         bh, sq, sk, d, scale, pol,
                                         tile_count, stream);
    if (d <= 192)
      return launch_dq<192, P, L, kDrop>(q, k, v, dout, lse, delta, dq, lay,
                                         bh, sq, sk, d, scale, pol,
                                         tile_count, stream);
    return launch_dq<256, P, L, kDrop>(q, k, v, dout, lse, delta, dq, lay,
                                       bh, sq, sk, d, scale, pol, tile_count,
                                       stream);
  });
}

template <class P, class L>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, const L& lay, int bh, int sq, int sk,
                    int d, float scale, const P& pol, int* tile_count,
                    cudaStream_t stream) {
  if (!operands_ok(d, {q, k, v, dout, dk, dv}) || !strides_ok(lay) ||
      bh % lay.group != 0)
    return cudaErrorInvalidValue;
  return by_dropout(pol, [&](auto drop) {
    constexpr bool kDrop = decltype(drop)::value;
    if (d <= 32)
      return launch_dkv<32, P, L, kDrop>(q, k, v, dout, lse, delta, dk, dv,
                                         lay, bh, sq, sk, d, scale, pol,
                                         tile_count, stream);
    if (d <= 64)
      return launch_dkv<64, P, L, kDrop>(q, k, v, dout, lse, delta, dk, dv,
                                         lay, bh, sq, sk, d, scale, pol,
                                         tile_count, stream);
    if (d <= 128)
      return launch_dkv<128, P, L, kDrop>(q, k, v, dout, lse, delta, dk, dv,
                                          lay, bh, sq, sk, d, scale, pol,
                                          tile_count, stream);
    if (d <= 192)
      return launch_dkv<192, P, L, kDrop>(q, k, v, dout, lse, delta, dk, dv,
                                          lay, bh, sq, sk, d, scale, pol,
                                          tile_count, stream);
    return launch_dkv<256, P, L, kDrop>(q, k, v, dout, lse, delta, dk, dv,
                                        lay, bh, sq, sk, d, scale, pol,
                                        tile_count, stream);
  });
}

// The same, on contiguous (bh, sq|sk, d) slices.
template <class P>
cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int sq, int sk, int d, float scale,
                   const P& pol, int* tile_count, cudaStream_t stream) {
  return run_dq(q, k, v, dout, lse, delta, dq,
                contiguous_bwd_layout(sq, sk, d), bh, sq, sk, d, scale, pol,
                tile_count, stream);
}

template <class P>
cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int bh, int sq, int sk, int d,
                    float scale, const P& pol, int* tile_count,
                    cudaStream_t stream) {
  return run_dkv(q, k, v, dout, lse, delta, dk, dv,
                 contiguous_bwd_layout(sq, sk, d), bh, sq, sk, d, scale, pol,
                 tile_count, stream);
}

}  // namespace attn_bwd_sm90
