// The bf16 attention forward tile loop on Hopper's tensor cores, shared by
// csrc/flash_attention.cu (`fa_fwd`), csrc/flashmask_attention.cu
// (`fm_fwd`) and csrc/varlen_attention.cu (`va_fwd`). The mask is a policy
// type; see `fwd_tc_kernel` for what a policy provides. Its PTX helpers,
// tile loader, tile scan and hi + lo product are shared with the backward
// loops of attn_bwd_sm90.cuh.
//
// What it computes, per query slice bh (a batch*head of (BH, S, D)
// operands, or a query head of packed (T, H, D) ones; `Layout` says where
// the rows lie): S = Q K^T * scale over the pairs the policy keeps, O =
// softmax(S) V in bf16 and lse = logsumexp(S) per row in fp32, lse at
// bh * sq + row. A row that keeps no pair gets O = 0 and lse = -1e30; rows
// past sq are not written. This is the TPU forward (`_fwd_kernel` of
// paddle_tpu/ops/flash_attention.py and flashmask_attention.py,
// `_vfwd_kernel` of varlen_attention.py) with the sequential k axis of its
// grid turned into a loop inside the block.
//
// Design (mma.sync, not wgmma: 4 warps of 16 query rows each keep the
// whole softmax in registers, and P never leaves them):
//   * One block of 128 threads per (query slice, 64-row q tile), slices
//     fastest and the longest causal rows first, so every head's longest
//     blocks start in the first wave and the query heads of one KV head
//     (GQA) run side by side, sharing its K/V tiles through L2; warp w owns
//     rows 16w .. 16w+15.
//   * Q, K and V tiles live in shared memory as 64 rows of DP bf16 (DP =
//     32, 64, 128, 192 or 256, the head dim padded), in 16-byte chunks
//     XOR-swizzled by row, so that every ldmatrix phase reads eight
//     distinct bank groups. They arrive by cp.async.cg 16-byte copies; rows past the
//     sequence and chunks past D are zero-filled by the copy's source size.
//     K and V go through a ring of two stages: the copies of the next
//     kept tile are issued before the current one is computed.
//   * S = Q K^T by mma.sync.m16n8k16 (bf16 in, fp32 accumulators), Q held
//     as ldmatrix.x4 A fragments for the whole loop, K by ldmatrix.x4.
//   * Online softmax in registers, in the log2 domain (scale * log2(e)
//     folded into the scores, ex2.approx): a thread holds two rows, the
//     max is reduced over the four lanes of a quad by shuffles, the sum is
//     kept per thread and reduced once at the end. Masked scores are -inf and
//     give exactly 0; a row whose max is still -inf subtracts 0 instead.
//   * P = exp2(S - m) is summed into l in fp32, then split in registers
//     into two bf16 terms, hi = bf16(P) and lo = bf16(P - hi) (the C
//     fragment of m16n8 is the A fragment of m16n8k16), each multiplied
//     by V read with ldmatrix.x4.trans. The TPU kernels cast P to V's
//     dtype, one term; on this card that moved rows that see few keys by
//     up to two bf16 ulps from the fp32 plain version, past the bf16
//     tolerance, so P keeps 16 bits here at the cost of a second PV
//     product.
//   * Skip decisions come from the policy before any copy is issued, so
//     the pipeline never waits on a mask. The copies of the next kept
//     tile are issued right after the one barrier of each tile.
//   * Wide heads (DP = 192 or 256): a block owns DV = 64 of the output's
//     columns (`out_cols`), the column chunk a grid axis folded into x
//     beside the slices. Each block still forms S = Q K^T over the whole
//     head dim (Q in registers, K tiles DP wide), but holds and writes
//     only its 64 columns of O, from V tiles 64 wide. The accumulators of
//     all DP columns (128 registers at DP = 256) beside Q's fragments (64)
//     and the scores (32) would pass the 255 a thread may hold; a chunk
//     keeps the registers of DP = 128. Every chunk recomputes the scores
//     and softmax (the same arithmetic, so the same P); chunk 0 alone
//     writes lse and counts tiles. Shared memory: Q and K at DP, V at
//     64: 112 KB at DP = 256, one block an SM.
//
// What bounds it: 4 flops per kept pair and head dim against each operand
// byte once, hundreds of flops a byte at training shapes, so the bf16
// tensor-core rate (989 TFLOP/s dense). mma.sync reaches a part of it;
// wgmma with TMA and warp specialisation is the step after this one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

namespace attn_fwd_sm90 {

constexpr int kTileQ = 64;   // rows of a q tile (4 warps x 16)
constexpr int kTileK = 64;   // columns of a k tile
constexpr int kThreads = 128;
constexpr int kStages = 2;   // K/V ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMaskedLse = -1e30f;

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 16 copies, 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes global -> shared; `bytes` 4 copies, 0 zero-fills.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile: a 4 and b 2 registers of bf16 pairs.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special function unit (relative error below 2^-22; results
// under 2^-126 flush to 0, and 2^-inf is 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values as one bf16 pair (lo in the low half), rounded to
// nearest.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// ---------------------------------------------------------------- tiles
// The output columns one block owns at padded head dim DP: all of them up
// to 128, a chunk of 64 above (the registers of a wider accumulator would
// spill). The fp32 kernels beside these loops stage their streamed
// operands in chunks of the same width, and size shared memory and the
// grid from it on the host.
__host__ __device__ constexpr int out_cols(int dp) {
  return dp <= 128 ? dp : 64;
}
template <int DP>
__host__ __device__ constexpr int out_cols() {
  return out_cols(DP);
}

// The first dim of the i-th of NCH streamed chunks of DC dims, for a block
// whose own output chunk is oc: that chunk comes last, so it stays staged
// for the output product.
template <int NCH, int DC>
__device__ __forceinline__ int chunk_at(int i, int oc) {
  return NCH == 1 ? 0 : (oc + 1 + i) % NCH * DC;
}

// Element offset of 16-byte chunk c of row r in a [64][DP] bf16 tile. The
// chunk index is XORed with bits of the row so that eight consecutive
// rows at one logical chunk sit in eight distinct bank groups: at DP >=
// 64 a row spans all eight groups (r & 7); at DP = 32 two rows share them
// ((r >> 1) & 3, and r & 1 picks the half).
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kChunks = DP / 8;
  const int x = kChunks >= 8 ? (r & 7) : ((r >> 1) & 3);
  return r * DP + ((c ^ x) << 3);
}

// Issue the copies of rows [row0, row0 + 64) of a (rows, D) slice whose
// rows lie rs elements apart (rs % 8 == 0) into a swizzled tile; rows past
// `rows` and chunks past D (D % 8 == 0) are zero-filled. The source of a
// zero-fill is the slice's base, never read. A thread copies one chunk
// column c of every (kThreads / chunks)-th row. The swizzle repeats every
// 8 rows, so along rows 8 apart c's place stays fixed and each further
// copy is one step of a pointer: where the thread's rows lie closer (DP =
// 256: 4 rows apart) it walks them as 8 / 4 runs of rows 8 apart (one
// computed place each: a place computed for every copy cost the dK/dV
// loop 50-80 registers and spilled FmPolicy's). Where the chunks of a row
// do not divide the threads (DP = 192: 24 chunks), thread t copies chunks
// t, t + 128, ... of the tile in row order, each at its own place.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows, int D, long long rs) {
  constexpr int kChunks = DP / 8;
  if constexpr (kThreads % kChunks != 0) {
    static_assert(kTileQ * kChunks % kThreads == 0, "whole copy rounds");
#pragma unroll
    for (int i = 0; i < kTileQ * kChunks / kThreads; ++i) {
      const int x = threadIdx.x + i * kThreads;
      const int r = x / kChunks;
      const int c = x % kChunks;
      const bool in = c * 8 < D && row0 + r < rows;
      cp_async16(dst + swz<DP>(r, c), in ? src + (row0 + r) * rs + c * 8 : src,
                 in ? 16 : 0);
    }
  } else {
    constexpr int kStep = kThreads / kChunks;  // rows between two copies
    constexpr int kRowStep = kStep >= 8 ? kStep : 8;  // along one run
    static_assert(kRowStep % kStep == 0 && kRowStep % 8 == 0,
                  "runs of rows that keep the swizzle");
    const int r0 = threadIdx.x / kChunks;
    const int c = threadIdx.x % kChunks;
    const bool col_in = c * 8 < D;
#pragma unroll
    for (int run = 0; run < kRowStep / kStep; ++run) {
      const int ra = r0 + run * kStep;
      const __nv_bfloat16* g = src + (row0 + ra) * rs + c * 8;
      __nv_bfloat16* d = dst + swz<DP>(ra, c);
#pragma unroll
      for (int i = 0; i < kTileQ / kRowStep; ++i) {
        const bool in = col_in && row0 + ra + i * kRowStep < rows;
        cp_async16(d + i * kRowStep * DP, in ? g : src, in ? 16 : 0);
        g += kRowStep * rs;
      }
    }
  }
}

// Shared memory of the kernel for head dim DP and policy P: the Q tile,
// kStages K/V pairs (V out_cols wide), and kStages of the policy's
// per-tile extra.
template <int DP, class P>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kTileQ) * 2 *
             (DP + kStages * (DP + out_cols<DP>())) +
         static_cast<size_t>(kStages) * P::kExtraBytes;
}

// The first index in [i, end) that `needed` keeps, or end. The lanes of
// each warp test 32 indices at once and keep the ballot, so a block past
// a long run of skipped tiles does not walk it one load at a time. Calls
// must come with non-decreasing i.
struct TileScan {
  int base = -32;
  unsigned bits = 0;  // kept indices among [base, base + 32)

  template <class F>
  __device__ __forceinline__ int next(int i, int end, F needed) {
    const int lane = threadIdx.x % 32;
    while (i < end) {
      if (i >= base + 32) {
        base = i;
        const int t = i + lane;
        bits = __ballot_sync(0xffffffffu, t < end && needed(t));
      }
      const unsigned rest = bits >> (i - base);
      if (rest != 0u) return i + __ffs(rest) - 1;
      i = base + 32;
    }
    return end;
  }
};

// The A fragment of m16n8k16 over 16 columns, from the C fragments of
// m16n8 of the two 8-column blocks x0 and x1, as two bf16 terms: hi =
// bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_a(const float (&x0)[4],
                                        const float (&x1)[4],
                                        unsigned (&hi)[4], unsigned (&lo)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* x = h == 0 ? x0 : x1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const __nv_bfloat162 xh = __floats2bfloat162_rn(x[2 * r], x[2 * r + 1]);
      const float2 back = __bfloat1622float2(xh);
      hi[2 * h + r] = *reinterpret_cast<const unsigned*>(&xh);
      lo[2 * h + r] = pack_bf16(x[2 * r] - back.x, x[2 * r + 1] - back.y);
    }
  }
}

// acc[2j], acc[2j + 1] += (hi + lo) B over 16 rows of a swizzled [64][DP]
// tile (rows row0 .. row0 + 15 are the k dimension, the DV columns from
// col0 (a multiple of 16) the n dimension), B by ldmatrix.trans, two
// 8-dim blocks a load.
template <int DP, int DV = DP>
__device__ __forceinline__ void mma_rows(float (*acc)[4],
                                         const unsigned (&hi)[4],
                                         const unsigned (&lo)[4],
                                         const __nv_bfloat16* tile, int row0,
                                         int col0 = 0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int dp = 0; dp < DV / 16; ++dp) {
    unsigned b[4];
    ldsm_x4_trans(b, tile + swz<DP>(row0 + (lane % 8) + (lane / 8) % 2 * 8,
                                    col0 / 8 + 2 * dp + lane / 16));
    mma_bf16(acc[2 * dp], hi, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
    mma_bf16(acc[2 * dp], lo, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
  }
}

// Blocks over (bh, n tiles), tiles along y continued along z past y's
// limit of 65535.
inline dim3 tile_grid(int bh, int n) {
  const int ny = n < 65535 ? n : 65535;
  return dim3(bh, ny, (n + ny - 1) / ny);
}

// Where the operands' rows lie, in elements: query slice bh starts at q +
// bh * q_hs and its row r at + r * q_rs; its K and V are slice bh / group
// of k and v (the KV head of a GQA query head), and its output slice is o
// + bh * o_hs. Every stride is a multiple of 8 (16-byte copies). The
// kernel takes one of two layout types: `Layout`, any strides (packed
// (T, H, D) operands), or `ContiguousLayout`, (BH, S, D) slices, whose row
// strides are the head dim and whose group is 1 at compile time.
struct Layout {
  long long q_rs, q_hs, k_rs, k_hs, v_rs, v_hs, o_rs, o_hs;
  int group;
};

struct ContiguousLayout {
  static constexpr int group = 1;
  int q_rs;
  long long q_hs;
  int k_rs;
  long long k_hs;
  int v_rs;
  long long v_hs;
  int o_rs;
  long long o_hs;
};

inline ContiguousLayout contiguous_layout(int sq, int sk, int d) {
  const long long D = d;
  return {d, sq * D, d, sk * D, d, sk * D, d, sq * D};
}

// Whether every stride suits the 16-byte copies (a contiguous layout's
// follow from d, which operands_ok checks).
inline bool strides_ok(const Layout& l) {
  for (long long st : {l.q_rs, l.q_hs, l.k_rs, l.k_hs, l.v_rs, l.v_hs,
                       l.o_rs, l.o_hs})
    if (st % 8 != 0) return false;
  return l.group >= 1;
}
inline bool strides_ok(const ContiguousLayout&) { return true; }

// ---------------------------------------------------------------- kernel
// The rows a key column keeps: [lo, hi) less the holes [a1, b1) and
// [a2, b2) (an empty hole is [INT_MAX, INT_MIN)). A policy computes it
// once per column with selects, and each of a thread's two rows is then
// tested without a branch: a per-pair test with a branch for every mask
// flavor, inlined into the tile loop, slowed the whole kernel on the
// card, partial tiles or not.
struct Span {
  int lo, hi, a1, b1, a2, b2;
};

__device__ __forceinline__ bool in_span(const Span& sp, int row) {
  return (row >= sp.lo) & (row < sp.hi) & !((row >= sp.a1) & (row < sp.b1)) &
         !((row >= sp.a2) & (row < sp.b2));
}

// A policy P provides, all uniform across the block except `span`,
// `rows`, `keep` and `drop`:
//   static constexpr size_t kExtraBytes;  shared bytes per stage for mask
//                                         data of a tile (0 if none)
//   static constexpr bool kRowTest;  how a partial tile is masked, decided
//                                  at compile time: false, by `span`, one
//                                  row range a column; true, by `keep`,
//                                  a test of each of the thread's rows
//   void begin(int bh, int q0, int sq, int sk);  this block's tile
//   int end() const;               k tiles [0, end) may be visited
//   bool needed(int kt) const;     false: the tile is skipped unloaded
//   bool full(int kt) const;       true: every pair of the tile is kept
//   void stage(int kt, void* extra) const;  copy the tile's mask data into
//                                  `extra` (cp.async, or plain stores),
//                                  partial tiles only
//   Span span(int col, int c, const void* extra) const;  (kRowTest false)
//                                  the rows that column col (c: its place
//                                  in the tile) keeps on a partial tile
//   void rows(int row_a, int row_b);  (kRowTest true) this thread's rows
//   void keep(int c, const void* extra, bool& a, bool& b) const;
//                                  (kRowTest true) whether rows a and b
//                                  keep column c of a partial tile
//   bool drops() const;            whether P is dropped before PV
//   float drop(float p, int row, int col) const;  what feeds PV then
template <int DP, class P, class L>
__global__ void __launch_bounds__(kThreads, 2)
    fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  const L lay, int sq, int sk, int D, float scale, P pol,
                  int* __restrict__ tile_count) {
  constexpr int KS = DP / 16;  // k-steps of Q K^T
  constexpr int DV = out_cols<DP>();  // output columns of this block
  constexpr int NCH = DP / DV;        // column chunks of the output
  constexpr int NB = DV / 8;   // 8-dim blocks of the output
  constexpr int kTileElems = kTileQ * DP;
  constexpr int kStageElems = kTileElems + kTileQ * DV;  // K, then V
  extern __shared__ __align__(128) unsigned char fwd_tc_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(fwd_tc_smem);
  // stage s: K at kv0 + s * kStageElems, V one K tile after it
  __nv_bfloat16* kv0 = qs + kTileElems;
  unsigned char* extra0 =
      fwd_tc_smem +
      static_cast<size_t>(kTileElems + kStages * kStageElems) * 2;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_qt = (sq + kTileQ - 1) / kTileQ;
  const int qt = static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
  if (qt >= n_qt) return;  // the last z slice's tail: the whole block
  const int q0 = (n_qt - 1 - qt) * kTileQ;
  // x: the slices fastest, then the output's column chunks
  const int bh = NCH == 1 ? static_cast<int>(blockIdx.x)
                          : static_cast<int>(blockIdx.x % (gridDim.x / NCH));
  const int c0 =
      NCH == 1 ? 0 : static_cast<int>(blockIdx.x / (gridDim.x / NCH)) * DV;
  const int dv = min(D - c0, DV);  // real output columns of the chunk
  const int bkv = bh / lay.group;
  const __nv_bfloat16* qb = q + bh * lay.q_hs;
  const __nv_bfloat16* kb = k + bkv * lay.k_hs;
  const __nv_bfloat16* vb = v + bkv * lay.v_hs + c0;
  pol.begin(bh, q0, sq, sk);

  // this thread's two rows: fragment rows lane/4 and lane/4 + 8
  const int row_a = q0 + warp * 16 + lane / 4;
  const int row_b = row_a + 8;
  if constexpr (P::kRowTest) pol.rows(row_a, row_b);
  const int col_in = 2 * (lane % 4);  // first of its two columns per 8
  const float sl2 = scale * kLog2e;

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int kt_end = pol.end();
  TileScan scan;
  auto needed = [&](int t) { return pol.needed(t); };
  auto issue = [&](int kt, int st, bool whole) {
    __nv_bfloat16* ks = kv0 + st * kStageElems;
    load_tile<DP>(ks, kb, kt * kTileK, sk, D, lay.k_rs);
    load_tile<DV>(ks + kTileElems, vb, kt * kTileK, sk, dv, lay.v_rs);
    if (!whole) pol.stage(kt, extra0 + st * P::kExtraBytes);
  };

  int kt = scan.next(0, kt_end, needed);
  int computed = 0;
  bool full = kt < kt_end && pol.full(kt);
  if (kt < kt_end) {
    load_tile<DP>(qs, qb, q0, sq, D, lay.q_rs);
    issue(kt, 0, full);
    cp_async_commit();
  }
  unsigned qf[KS][4];
  int st = 0;
  while (kt < kt_end) {
    cp_async_wait<0>();
    // tile kt (and, the first time, Q) has landed for every thread, and
    // every warp is done with the previous tile, whose stage the next
    // tile's copies refill while this one computes
    __syncthreads();
    const int nxt = scan.next(kt + 1, kt_end, needed);
    const bool full_nxt = nxt < kt_end && pol.full(nxt);
    if (nxt < kt_end) {
      issue(nxt, st ^ 1, full_nxt);
      cp_async_commit();
    }
    if (computed == 0) {
#pragma unroll
      for (int t = 0; t < KS; ++t)
        ldsm_x4(qf[t],
                qs + swz<DP>(warp * 16 + (lane % 16), 2 * t + lane / 16));
    }
    ++computed;
    const __nv_bfloat16* ks = kv0 + st * kStageElems;
    const __nv_bfloat16* vs = ks + kTileElems;
    const unsigned char* extra = extra0 + st * P::kExtraBytes;
    const int k0 = kt * kTileK;

    // S = Q K^T: 8 blocks of 8 columns, C fragments
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int t = 0; t < KS; ++t) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        unsigned b[4];
        ldsm_x4(b, ks + swz<DP>(jp * 16 + (lane % 8) + (lane / 16) * 8,
                                2 * t + (lane / 8) % 2));
        mma_bf16(s[2 * jp], qf[t], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[t], b[2], b[3]);
      }
    }

    // scale into the log2 domain; mask the pairs a partial tile drops
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
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
          if (!keep_a) s[j][e] = -INFINITY;
          if (!keep_b) s[j][2 + e] = -INFINITY;
        }
      }
    }

    // online softmax: row maxima over the quad, rescale, exponentiate
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row that has kept nothing yet subtracts 0: its -inf scores
      // still give exactly 0, and so does its alpha
      mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      const float alpha = fast_exp2(m[r] - mu[r]);
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }
    // P = exp2(S - m) into s; l takes the fp32 P, before any dropout
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fast_exp2(s[j][e] - mu[e / 2]);
        l[e / 2] += s[j][e];
      }
    }

    if (pol.drops()) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = pol.drop(s[j][e], e < 2 ? row_a : row_b,
                             k0 + 8 * j + col_in + e % 2);
    }

    // O += P V, 16 keys at a time. P enters as two bf16 terms, hi =
    // bf16(P) and lo = bf16(P - hi), so it carries 16 bits: one term
    // alone (the TPU kernel's cast) moves the output of a row that sees
    // few keys by up to two bf16 ulps.
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      unsigned hi[4], lo[4];
      split_a(s[2 * t], s[2 * t + 1], hi, lo);
      mma_rows<DV>(acc, hi, lo, vs, 16 * t);
    }
    kt = nxt;
    full = full_nxt;
    st ^= 1;
  }

  // epilogue: l over the quad, O / l in fp32, written as bf16 pairs
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    if (row >= sq) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
    __nv_bfloat16* orow =
        o + bh * lay.o_hs + static_cast<long long>(row) * lay.o_rs + c0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int d = 8 * j + col_in;
      if (d < dv)
        *reinterpret_cast<unsigned*>(orow + d) =
            pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
    if (lane % 4 == 0 && c0 == 0)
      lse[static_cast<size_t>(bh) * sq + row] =
          l[r] == 0.f ? kMaskedLse : m[r] * kLn2 + logf(l[r]);
  }
  if (tile_count != nullptr && threadIdx.x == 0 && c0 == 0)
    atomicAdd(tile_count, computed);
}

// Launch the kernel on `stream` for bh query slices; returns
// cudaGetLastError().
template <int DP, class P, class L>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const L& lay, int bh, int sq, int sk, int d,
                   float scale, const P& pol, int* tile_count,
                   cudaStream_t stream) {
  auto kernel = fwd_tc_kernel<DP, P, L>;
  constexpr size_t smem = smem_bytes<DP, P>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<tile_grid(bh * (DP / out_cols<DP>()), (sq + kTileQ - 1) / kTileQ),
           kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), lay, sq, sk, d, scale, pol, tile_count);
  return cudaGetLastError();
}

// The widest head dim the kernels take (this forward and the backward of
// attn_bwd_sm90.cuh).
constexpr int kMaxHeadDim = 256;

// What the kernels need of their operands: D a multiple of 8 up to 256
// and every bf16 base 16-byte aligned (the wrappers pad or realign to meet
// it).
inline bool operands_ok(int d, std::initializer_list<const void*> ptrs) {
  if (d % 8 != 0 || d > kMaxHeadDim) return false;
  for (const void* p : ptrs)
    if ((reinterpret_cast<uintptr_t>(p) & 15) != 0) return false;
  return true;
}

// Dispatch on the padded head dim (32, 64, 128, 192 or 256), for operands
// where `lay` says.
template <class P, class L>
cudaError_t run(const void* q, const void* k, const void* v, void* o,
                void* lse, const L& lay, int bh, int sq, int sk, int d,
                float scale, const P& pol, int* tile_count,
                cudaStream_t stream) {
  if (!operands_ok(d, {q, k, v, o}) || !strides_ok(lay))
    return cudaErrorInvalidValue;
  if (d <= 32)
    return launch<32>(q, k, v, o, lse, lay, bh, sq, sk, d, scale, pol,
                      tile_count, stream);
  if (d <= 64)
    return launch<64>(q, k, v, o, lse, lay, bh, sq, sk, d, scale, pol,
                      tile_count, stream);
  if (d <= 128)
    return launch<128>(q, k, v, o, lse, lay, bh, sq, sk, d, scale, pol,
                       tile_count, stream);
  if (d <= 192)
    return launch<192>(q, k, v, o, lse, lay, bh, sq, sk, d, scale, pol,
                       tile_count, stream);
  return launch<256>(q, k, v, o, lse, lay, bh, sq, sk, d, scale, pol,
                     tile_count, stream);
}

// The same, on contiguous (bh, sq|sk, d) slices.
template <class P>
cudaError_t run(const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int sq, int sk, int d, float scale,
                const P& pol, int* tile_count, cudaStream_t stream) {
  return run(q, k, v, o, lse, contiguous_layout(sq, sk, d), bh, sq, sk, d,
             scale, pol, tile_count, stream);
}

}  // namespace attn_fwd_sm90
