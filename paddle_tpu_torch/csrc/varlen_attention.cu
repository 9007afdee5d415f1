// Varlen (packed) attention for Hopper (sm_90a): forward, dQ and dK/dV,
// plain C interface for ctypes.
//
// Replaces the three TPU kernels of paddle_tpu/ops/varlen_attention.py:
//   va_fwd     -> `_vfwd_kernel`     (:92, launched by `_vfwd_pallas`)
//   va_bwd_dq  -> `_vbwd_dq_kernel`  (:213, launched by `_vbwd_pallas`)
//   va_bwd_dkv -> `_vbwd_dkv_kernel` (:259, launched by `_vbwd_pallas`)
// What they compute: sequences packed back to back along one token axis,
// told apart by segment ids. A (query row, key column) pair counts where
// seg_q == seg_k and, under causal masking, where pos_k >= pos_q (pos =
// distance to the segment's end: bottom-right alignment). Padding carries
// -1 on the query side and -2 on the key side, so it never matches. Per
// query head, S = Q K^T * scale over the counted pairs; forward: o =
// softmax(S) V and lse = logsumexp(S), a row with no counted pair getting
// o = 0 and lse = -1e30; backward, from lse and delta = rowsum(dO * O):
// P = exp(S - lse), dS = P (dO V^T - delta) scale, both 0 on pairs that do
// not count, dQ = dS K, dK = dS^T Q, dV = P^T dO.
//
// Two designs, by dtype. bf16 runs the tensor-core tile loops, with
// `VarlenPolicy` below: va_fwd the forward loop of attn_fwd_sm90.cuh
// (mma.sync m16n8k16, a cp.async K/V ring, P as bf16 hi + lo; see that
// header), va_bwd_dq and va_bwd_dkv the dQ and dK/dV loops of
// attn_bwd_sm90.cuh (the same helpers; P and dS as bf16 hi + lo). q and
// dO are read from (T, H, D) and K/V from (T, KVH, D) by row and head
// stride, query head h reading KV head h / group in place; the dK/dV loop
// walks a KV head's query heads in one block and sums their dK/dV in
// fp32 registers. The tile skips are those of the CUDA-core design below
// (tile ranges, the diagonal, the early answer of a tile with no real
// row or key), read by rows (forward, dQ) or by columns (dK/dV); a
// partial tile is masked by a branchless test of each of the thread's
// two rows (or keys), (seg_q == seg_k) & (pos_k >= pos_q), against the
// other tile's 64 ids and distances staged beside it in the ring; a tile
// wholly inside one segment (and, under causal masking, wholly below the
// diagonal with same offsets) is kept without a test. fp32 runs the
// CUDA-core design:
//
// Design. The TPU kernels run a grid whose last axis is sequential and
// carry their sums in VMEM scratch across it; blocks here run in parallel
// and in no order, so that axis is a loop inside a block, with every sum
// in fp32 registers, and nothing is reduced across blocks (no atomics):
//   * va_fwd and va_bwd_dq: one block per (64-row q tile, query head),
//     looping over the k tiles; fwd keeps an online softmax (m, l and the
//     accumulator), dQ its accumulator.
//   * va_bwd_dkv: one block per (64-row k tile, KV head), looping over the
//     query heads of the KV head's group and, for each, over the q tiles;
//     dK and dV of the group are summed in registers, so K/V are never
//     repeated to the query heads and no (H, T, D) scratch exists.
// The tile loops are those of flash_attention.cu: 256 threads as 16 x 16,
// 4 rows and every 16th column a thread, row statistics by warp shuffles;
// tiles staged as fp32, d-major at a stride of 65 floats. Where they differ
// from the TPU kernels:
//   * GQA: query head h reads KV head h / (H / KVH) in place, by stride,
//     from the (T, KVH, D) projections; q and dO are read from (T, H, D) by
//     stride: no repeat of K/V, no (H, T, D) transposed copies.
//   * Skipping. A first small kernel reduces every 64-token tile of seg_q
//     and seg_k to the [min, max] of its non-negative ids. A block whose own
//     tile holds no real row writes its answer (zeros; lse = -1e30) and
//     returns; the others stage every tile range of the other axis in
//     shared memory once and skip, before any load, each tile whose range is
//     empty or disjoint from their own. With non-decreasing ids (packed
//     sequences) the ranges are exact, so a block computes only the tiles
//     its segments touch; for any ids the test is sound, since disjoint
//     ranges hold no equal pair. With `same_offsets` (q and k token i at
//     the same place) tiles above the diagonal are skipped too. The TPU
//     kernels have only the diagonal skip, so a packed row pays for every
//     causal tile of it: of the 8,256 causal tiles of eight documents in
//     8192 tokens (the packed training row) some 1,900 touch a segment.
//   * The ragged edge: rows and columns past Tq and Tk are zero-filled on
//     load and masked, so no padding to a block multiple is needed.
//   * Masking: P itself is set to 0 on the pairs that do not count, not
//     only S, so that a row that sees nothing (lse = -1e30) gives no
//     overflow, and a padding row's dO, whatever the caller passed, reaches
//     neither dK nor dV.
// fp32 operands; the products take P and dS in fp32 (the TPU forward casts
// P to V's dtype for the MXU); dK and dV of a group are summed in fp32.
// Head dims up to 128 through instantiations for 32, 64 and 128, padded
// with zeros.
//
// What bounds them: at the packed training row (8192 tokens, H = 32, D =
// 128, bf16, eight documents, 7.14 M kept pairs a head) dQ needs 6 and
// dK/dV 8 flops per kept pair and head dim, 176 and 234 GFLOP against
// about 0.2 GB of operands: operations, at the bf16 tensor-core rate
// (0.18 and 0.24 ms); mma.sync reaches a part of it (see
// attn_bwd_sm90.cuh). The CUDA-core design runs on fp32 CUDA cores, one
// block per SM (117-169 KB of staged tiles at D = 128), with no tensor
// cores and no cp.async/TMA pipelining. The forward at the serve prefill
// wave (8 prompts in 8192 tokens, 1.14 M kept pairs a head) is bound by
// its bytes: 0.13 GB, 0.04 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

#include "attn_bwd_sm90.cuh"
#include "attn_fwd_sm90.cuh"

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr int kTile = 64;        // rows of a q tile and of a k tile
constexpr int kPad = kTile + 1;  // stride of a d-major staged tile
constexpr int kPS = kTile + 4;   // stride of a row of a score tile
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// [min, max] of the non-negative ids of each 64-token tile, one warp a
// tile: tiles [0, n_qt) of seg_q, then [n_qt, n_qt + n_kt) of seg_k, at
// ranges[2 * tile] and ranges[2 * tile + 1]. A tile with no non-negative
// id gets (INT_MAX, -1), an empty range. Past them, ranges[2 * (n_qt +
// n_kt) + tile] is the tile's one id where all 64 tokens lie inside the
// axis and share one non-negative id, else -1.
__global__ void tile_ranges_kernel(const int* __restrict__ seg_q,
                                   const int* __restrict__ seg_k, int tq,
                                   int tk, int n_qt, int n_kt,
                                   int* __restrict__ ranges) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile = blockIdx.x * (blockDim.x / 32) + warp;
  if (tile >= n_qt + n_kt) return;
  const bool is_q = tile < n_qt;
  const int* seg = is_q ? seg_q : seg_k;
  const int n = is_q ? tq : tk;
  const int t0 = (is_q ? tile : tile - n_qt) * kTile;
  int lo = INT_MAX, hi = -1;
  bool real = true;  // every token of the tile is inside with an id >= 0
  for (int r = lane; r < kTile; r += 32) {
    const int i = t0 + r;
    const int s = i < n ? seg[i] : -1;
    if (s >= 0) {
      lo = min(lo, s);
      hi = max(hi, s);
    } else {
      real = false;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  real = __all_sync(0xffffffffu, real);
  if (lane == 0) {
    ranges[2 * tile] = lo;
    ranges[2 * tile + 1] = hi;
    ranges[2 * (n_qt + n_kt) + tile] = real && lo == hi ? lo : -1;
  }
}

// pos = rev_pos of ops/varlen_attention.py for seg_q and then seg_k, one
// thread a token: the upper bound of token i's key in the keys (key = the
// id, or INT_MAX for a negative one), minus i, by the same binary search
// as torch.searchsorted(right=True). One launch in place of the dozen
// small torch ops of two rev_pos calls.
__global__ void positions_kernel(const int* __restrict__ seg_q,
                                 const int* __restrict__ seg_k, int tq,
                                 int tk, int* __restrict__ pos_q,
                                 int* __restrict__ pos_k) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= tq + tk) return;
  const bool is_q = t < tq;
  const int* seg = is_q ? seg_q : seg_k;
  const int n = is_q ? tq : tk;
  const int i = is_q ? t : t - tq;
  auto key = [seg](int j) {
    const int s = seg[j];
    return s < 0 ? INT_MAX : s;
  };
  const int x = key(i);
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (key(mid) > x)
      hi = mid;
    else
      lo = mid + 1;
  }
  (is_q ? pos_q : pos_k)[i] = lo - i;
}

// Stage rows [row0, row0 + kTile) of one head of a strided (rows, ., D)
// operand into shared memory, d-major: dst[d * kPad + r]. Rows past `rows`
// and dims past D (up to DP) are zero.
template <int DP>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      long long row_stride, int row0,
                                      int rows, int D) {
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP;
    const int d = i % DP;
    float x = 0.f;
    if (row0 + r < rows && d < D)
      x = src[static_cast<long long>(row0 + r) * row_stride + d];
    dst[d * kPad + r] = x;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    va_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ seg_q,
                  const int* __restrict__ seg_k,
                  const int* __restrict__ pos_q,
                  const int* __restrict__ pos_k,
                  const int* __restrict__ ranges, float* __restrict__ o,
                  float* __restrict__ lse, int tq, int tk, int group, int D,
                  long long q_rs, long long q_hs, long long k_rs,
                  long long k_hs, long long v_rs, long long v_hs,
                  float scale, int causal, int same_offsets,
                  int* __restrict__ tile_count) {
  constexpr int NC = DP / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + DP * kPad;
  float* vs = ks + DP * kPad;
  float* ps = vs + DP * kPad;                                // kTile x kPS
  int* sk_s = reinterpret_cast<int*>(ps + kTile * kPS);      // kTile
  int* pk_s = sk_s + kTile;                                  // kTile
  int* kr_s = pk_s + kTile;                                  // 2 x n_kt

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n_qt = (tq + kTile - 1) / kTile;
  const int n_kt = (tk + kTile - 1) / kTile;
  const int qt = n_qt - 1 - blockIdx.x;  // longest causal rows first
  const int q0 = qt * kTile;
  const int h = blockIdx.y;
  const int heads = gridDim.y;
  const long long o_rs = static_cast<long long>(heads) * D;
  const int q_lo = ranges[2 * qt];
  const int q_hi = ranges[2 * qt + 1];

  if (q_hi < 0) {  // no real row: answer without loading anything
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int row = q0 + i / D;
      if (row < tq) o[row * o_rs + h * D + i % D] = 0.f;
    }
    for (int r = threadIdx.x; r < kTile; r += kThreads)
      if (q0 + r < tq) lse[static_cast<long long>(h) * tq + q0 + r] = kNegInf;
    return;
  }

  for (int i = threadIdx.x; i < 2 * n_kt; i += kThreads)
    kr_s[i] = ranges[2 * n_qt + i];
  const float* kb = k + static_cast<long long>(h / group) * k_hs;
  const float* vb = v + static_cast<long long>(h / group) * v_hs;
  stage<DP>(qs, q + static_cast<long long>(h) * q_hs, q_rs, q0, tq, D);

  int sq[4], pq[4];
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    sq[i] = row < tq ? seg_q[row] : -1;
    pq[i] = row < tq ? pos_q[row] : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  int kt_end = n_kt;
  if (causal && same_offsets)  // no column past the tile's last row
    kt_end = min(n_kt, (min(q0 + kTile, tq) - 1) / kTile + 1);
  int computed = 0;
  __syncthreads();  // kr_s is staged

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k_lo = kr_s[2 * kt];
    const int k_hi = kr_s[2 * kt + 1];
    // uniform across the block: every thread skips or none does
    if (k_hi < 0 || k_lo > q_hi || k_hi < q_lo) continue;
    ++computed;
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's reads of ks, vs, ps are done
    stage<DP>(ks, kb, k_rs, k0, tk, D);
    stage<DP>(vs, vb, v_rs, k0, tk, D);
    if (threadIdx.x < kTile) {
      const int c = k0 + threadIdx.x;
      sk_s[threadIdx.x] = c < tk ? seg_k[c] : -2;
      pk_s[threadIdx.x] = c < tk ? pos_k[c] : 0;
    }
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[d * kPad + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[d * kPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        // a pad row (-1) never equals a key id (>= 0 or -2)
        ok[j] = sq[i] == sk_s[c] && (!causal || pk_s[c] >= pq[i]);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // masked columns give exactly 0, even while m_new is kNegInf
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * 4 + i) * kPS + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kPS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float w = vs[(tx + 16 * c) * kPad + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], w, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= tq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + row * o_rs + h * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = acc[i][c] / ls;
    }
    if (tx == 0) lse[static_cast<long long>(h) * tq + row] = m[i] + logf(ls);
  }
  if (tile_count != nullptr && threadIdx.x == 0)
    atomicAdd(tile_count, computed);
}

// The mask and skips of the bf16 tensor-core loops (attn_fwd_sm90.cuh,
// attn_bwd_sm90.cuh): a pair is kept where seg_q == seg_k and, under
// causal masking, pos_k >= pos_q; tiles are skipped by tile_ranges_kernel's
// ranges, read through L1 (the 32 lanes of a warp test 32 tiles at once).
// The dK/dV loop reads the same rule by columns.
struct VarlenPolicy {
  static constexpr bool kRowTest = true;
  static constexpr bool kMayDrop = false;  // no dropout in the kernels
  // per stage: the k tile's 64 seg_k, then its 64 pos_k (q-major loops);
  // the q tile's 64 seg_q, then its 64 pos_q (the dK/dV loop)
  static constexpr size_t kExtraBytes = 2 * kTile * sizeof(int);
  static_assert(attn_fwd_sm90::kThreads == 2 * kTile,
                "stage copies one id or distance a thread");
  const int* seg_q;
  const int* seg_k;
  const int* pos_q;
  const int* pos_k;
  const int* ranges;  // tile_ranges_kernel's output
  int tq, tk, n_qt, n_kt, causal, same_offsets;
  // this block's q tile: its index, id range and one id, the k tiles it
  // may visit
  int qt, q_lo, q_hi, q_one, kt_end;
  // this thread's two rows: ids (-1 past tq) and distances (INT_MIN
  // without causal masking, so every distance passes)
  int sa, sb, pa, pb;
  // the dK/dV loop: this block's k tile, its id range and one id; this
  // thread's two keys (`keys`): ids (-2 past tk) and distances (INT_MAX
  // without causal masking)
  int kt, k_lo, k_hi, k_one;
  int ska, skb, pka, pkb;

  __device__ __forceinline__ void begin(int, int q0, int, int) {
    qt = q0 / kTile;
    q_lo = ranges[2 * qt];
    q_hi = ranges[2 * qt + 1];
    q_one = ranges[2 * (n_qt + n_kt) + qt];
    // a tile with no real row visits nothing: the loop then writes o = 0
    // and lse = -1e30 without a copy; with same offsets no column past
    // the tile's last row
    kt_end = q_hi < 0 ? 0
             : causal && same_offsets
                 ? min(n_kt, (min(q0 + kTile, tq) - 1) / kTile + 1)
                 : n_kt;
  }
  __device__ __forceinline__ void rows(int row_a, int row_b) {
    sa = row_a < tq ? seg_q[row_a] : -1;
    sb = row_b < tq ? seg_q[row_b] : -1;
    pa = !causal ? INT_MIN : row_a < tq ? pos_q[row_a] : 0;
    pb = !causal ? INT_MIN : row_b < tq ? pos_q[row_b] : 0;
  }
  __device__ __forceinline__ int end() const { return kt_end; }
  // the ranges meet: disjoint ranges hold no equal pair, whatever the ids
  __device__ __forceinline__ bool needed(int kt) const {
    const int k_lo = ranges[2 * (n_qt + kt)];
    const int k_hi = ranges[2 * (n_qt + kt) + 1];
    return k_hi >= 0 && k_lo <= q_hi && k_hi >= q_lo;
  }
  // both tiles wholly inside one and the same segment, with no pad and no
  // token past the axes; under causal masking, with same offsets, the k
  // tile wholly before the q tile (every pos_k > every pos_q)
  __device__ __forceinline__ bool full(int kt) const {
    const int k_one = ranges[2 * (n_qt + n_kt) + n_qt + kt];
    return q_one >= 0 && k_one == q_one &&
           (!causal || (same_offsets && kt < qt));
  }
  // thread i copies seg_k (i < 64) or pos_k of column i % 64; a column
  // past tk gets id -2, which no row has
  __device__ __forceinline__ void stage(int kt, void* extra) const {
    int* dst = static_cast<int*>(extra) + threadIdx.x;
    const bool is_seg = threadIdx.x < kTile;
    const int c = kt * kTile + threadIdx.x % kTile;
    if (c < tk)
      attn_fwd_sm90::cp_async4(dst, (is_seg ? seg_k : pos_k) + c, 4);
    else
      *dst = is_seg ? -2 : 0;
  }
  __device__ __forceinline__ void keep(int c, const void* extra, bool& a,
                                       bool& b) const {
    const int* x = static_cast<const int*>(extra);
    const int s = x[c];
    const int p = x[kTile + c];
    a = (s == sa) & (p >= pa);
    b = (s == sb) & (p >= pb);
  }
  __device__ __forceinline__ bool drops() const { return false; }
  __device__ __forceinline__ float drop(float p, int, int) const { return p; }

  // the k-major loop (dK/dV), the q-major rule read by columns
  __device__ __forceinline__ void begin_k(int, int k0, int, int) {
    kt = k0 / kTile;
    k_lo = ranges[2 * (n_qt + kt)];
    k_hi = ranges[2 * (n_qt + kt) + 1];
    k_one = ranges[2 * (n_qt + n_kt) + n_qt + kt];
  }
  // with same offsets under causal masking, no q tile before this k tile
  // holds a row that sees it
  __device__ __forceinline__ int q_begin() const {
    return causal && same_offsets ? kt : 0;
  }
  // a tile with no real key visits nothing: the loop then writes dK = dV
  // = 0 without a copy
  __device__ __forceinline__ int q_end() const { return k_hi < 0 ? 0 : n_qt; }
  __device__ __forceinline__ bool needed_q(int qt_) const {
    const int lo = ranges[2 * qt_];
    const int hi = ranges[2 * qt_ + 1];
    return hi >= 0 && lo <= k_hi && hi >= k_lo;
  }
  __device__ __forceinline__ bool full_q(int qt_) const {
    const int one = ranges[2 * (n_qt + n_kt) + qt_];
    return k_one >= 0 && one == k_one &&
           (!causal || (same_offsets && kt < qt_));
  }
  // thread i copies seg_q (i < 64) or pos_q of row i % 64; a row past tq
  // gets id -1, which no key has
  __device__ __forceinline__ void stage_q(int qt_, void* extra) const {
    int* dst = static_cast<int*>(extra) + threadIdx.x;
    const bool is_seg = threadIdx.x < kTile;
    const int r = qt_ * kTile + threadIdx.x % kTile;
    if (r < tq)
      attn_fwd_sm90::cp_async4(dst, (is_seg ? seg_q : pos_q) + r, 4);
    else
      *dst = is_seg ? -1 : 0;
  }
  __device__ __forceinline__ void keys(int key_a, int key_b) {
    ska = key_a < tk ? seg_k[key_a] : -2;
    skb = key_b < tk ? seg_k[key_b] : -2;
    pka = !causal ? INT_MAX : key_a < tk ? pos_k[key_a] : 0;
    pkb = !causal ? INT_MAX : key_b < tk ? pos_k[key_b] : 0;
  }
  __device__ __forceinline__ void keep_q(int c, const void* extra, bool& a,
                                         bool& b) const {
    const int* x = static_cast<const int*>(extra);
    const int s = x[c];
    const int p = x[kTile + c];
    a = (s == ska) & (pka >= p);
    b = (s == skb) & (pkb >= p);
  }
};

// The policy of one call of the tensor-core loops.
VarlenPolicy varlen_policy(const void* seg_q, const void* seg_k,
                           const void* pos_q, const void* pos_k,
                           const void* ranges, int tq, int tk, int causal,
                           int same_offsets) {
  VarlenPolicy pol{};
  pol.seg_q = static_cast<const int*>(seg_q);
  pol.seg_k = static_cast<const int*>(seg_k);
  pol.pos_q = static_cast<const int*>(pos_q);
  pol.pos_k = static_cast<const int*>(pos_k);
  pol.ranges = static_cast<const int*>(ranges);
  pol.tq = tq;
  pol.tk = tk;
  pol.n_qt = (tq + kTile - 1) / kTile;
  pol.n_kt = (tk + kTile - 1) / kTile;
  pol.causal = causal;
  pol.same_offsets = same_offsets;
  return pol;
}

// The backward kernels' operands: q and dout (tq, heads, D), k and v (tk,
// kv_heads, D), each read by its row and head strides with the head dim
// contiguous; lse and delta (heads, tq) fp32; seg and pos int32; ranges
// from tile_ranges_kernel; dq contiguous (tq, heads, D); dk, dv contiguous
// (tk, kv_heads, D).
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const int* seg_q;
  const int* seg_k;
  const int* pos_q;
  const int* pos_k;
  const int* ranges;
  void* dq;
  void* dk;
  void* dv;
  int tq, tk, heads, kv_heads, D;
  long long q_rs, q_hs, k_rs, k_hs, v_rs, v_hs, do_rs, do_hs;
  float scale;
  int causal, same_offsets;
  int* tile_count;
};

// ------------------------------------------------------------------ dQ
template <int DP>
__global__ void __launch_bounds__(kThreads, 1) va_dq_kernel(const BwdArgs a) {
  constexpr int NC = DP / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + DP * kPad;
  float* ks = dos + DP * kPad;
  float* vs = ks + DP * kPad;
  float* dss = vs + DP * kPad;                               // kTile x kPS
  int* sk_s = reinterpret_cast<int*>(dss + kTile * kPS);     // kTile
  int* pk_s = sk_s + kTile;                                  // kTile
  int* kr_s = pk_s + kTile;                                  // 2 x n_kt

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int tq = a.tq, tk = a.tk, D = a.D;
  const int n_qt = (tq + kTile - 1) / kTile;
  const int n_kt = (tk + kTile - 1) / kTile;
  const int qt = n_qt - 1 - blockIdx.x;  // longest causal rows first
  const int q0 = qt * kTile;
  const int h = blockIdx.y;
  const long long o_rs = static_cast<long long>(a.heads) * D;
  float* dq = static_cast<float*>(a.dq);
  const int q_lo = a.ranges[2 * qt];
  const int q_hi = a.ranges[2 * qt + 1];

  if (q_hi < 0) {  // no real row: dQ = 0 without loading anything
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int row = q0 + i / D;
      if (row < tq) dq[row * o_rs + h * D + i % D] = 0.f;
    }
    return;
  }

  for (int i = threadIdx.x; i < 2 * n_kt; i += kThreads)
    kr_s[i] = a.ranges[2 * n_qt + i];
  const int hk = h / (a.heads / a.kv_heads);
  const float* kb = static_cast<const float*>(a.k) + hk * a.k_hs;
  const float* vb = static_cast<const float*>(a.v) + hk * a.v_hs;
  stage<DP>(qs, static_cast<const float*>(a.q) + h * a.q_hs, a.q_rs, q0, tq, D);
  stage<DP>(dos, static_cast<const float*>(a.dout) + h * a.do_hs, a.do_rs, q0,
            tq, D);

  int sq[4], pq[4];
  float lr[4], dr[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool in = row < tq;
    sq[i] = in ? a.seg_q[row] : -1;
    pq[i] = in ? a.pos_q[row] : 0;
    lr[i] = in ? a.lse[static_cast<long long>(h) * tq + row] : 0.f;
    dr[i] = in ? a.delta[static_cast<long long>(h) * tq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  int kt_end = n_kt;
  if (a.causal && a.same_offsets)  // no column past the tile's last row
    kt_end = min(n_kt, (min(q0 + kTile, tq) - 1) / kTile + 1);
  int computed = 0;
  __syncthreads();  // kr_s is staged

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k_lo = kr_s[2 * kt];
    const int k_hi = kr_s[2 * kt + 1];
    // uniform across the block: every thread skips or none does
    if (k_hi < 0 || k_lo > q_hi || k_hi < q_lo) continue;
    ++computed;
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's reads of ks, vs, dss are done
    stage<DP>(ks, kb, a.k_rs, k0, tk, D);
    stage<DP>(vs, vb, a.v_rs, k0, tk, D);
    if (threadIdx.x < kTile) {
      const int c = k0 + threadIdx.x;
      sk_s[threadIdx.x] = c < tk ? a.seg_k[c] : -2;
      pk_s[threadIdx.x] = c < tk ? a.pos_k[c] : 0;
    }
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float x[4], g[4], b[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = qs[d * kPad + ty * 4 + i];
        g[i] = dos[d * kPad + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = ks[d * kPad + tx + 16 * j];
        w[j] = vs[d * kPad + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(x[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        // a pad row (-1) never equals a key id (>= 0 or -2)
        const bool ok = sq[i] == sk_s[c] && (!a.causal || pk_s[c] >= pq[i]);
        // P is masked itself: lse is -1e30 on a row that sees nothing
        const float p = ok ? expf(s[i][j] * a.scale - lr[i]) : 0.f;
        dss[(ty * 4 + i) * kPS + c] = ok ? p * (dp[i][j] - dr[i]) * a.scale
                                         : 0.f;
      }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty * 4 + i) * kPS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kk = ks[(tx + 16 * c) * kPad + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= tq) continue;
    float* drow = dq + row * o_rs + h * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) drow[d] = acc[i][c];
    }
  }
  if (a.tile_count != nullptr && threadIdx.x == 0)
    atomicAdd(a.tile_count, computed);
}

// --------------------------------------------------------------- dK/dV
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    va_dkv_kernel(const BwdArgs a) {
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + DP * kPad;
  float* qs = vs + DP * kPad;
  float* dos = qs + DP * kPad;
  float* pts = dos + DP * kPad;    // kTile x kPS: P^T of the tile
  float* dst = pts + kTile * kPS;  // kTile x kPS: dS^T of the tile
  float* ls = dst + kTile * kPS;   // lse of the tile's q rows
  float* dl = ls + kTile;          // delta of the tile's q rows
  int* sq_s = reinterpret_cast<int*>(dl + kTile);  // kTile
  int* pq_s = sq_s + kTile;                        // kTile
  int* qr_s = pq_s + kTile;                        // 2 x n_qt

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int tq = a.tq, tk = a.tk, D = a.D;
  const int n_qt = (tq + kTile - 1) / kTile;
  const int kt = blockIdx.x;
  const int k0 = kt * kTile;
  const int hk = blockIdx.y;
  const int group = a.heads / a.kv_heads;
  const long long kv_rs = static_cast<long long>(a.kv_heads) * D;
  float* dk = static_cast<float*>(a.dk);
  float* dv = static_cast<float*>(a.dv);
  const int k_lo = a.ranges[2 * (n_qt + kt)];
  const int k_hi = a.ranges[2 * (n_qt + kt) + 1];

  if (k_hi < 0) {  // no real key: dK = dV = 0 without loading anything
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int row = k0 + i / D;
      if (row < tk) {
        const long long at = row * kv_rs + hk * D + i % D;
        dk[at] = 0.f;
        dv[at] = 0.f;
      }
    }
    return;
  }

  for (int i = threadIdx.x; i < 2 * n_qt; i += kThreads)
    qr_s[i] = a.ranges[i];
  stage<DP>(ks, static_cast<const float*>(a.k) + hk * a.k_hs, a.k_rs, k0, tk, D);
  stage<DP>(vs, static_cast<const float*>(a.v) + hk * a.v_hs, a.v_rs, k0, tk, D);
  int sk[4], pk[4];
  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + ty * 4 + i;
    sk[i] = col < tk ? a.seg_k[col] : -2;
    pk[i] = col < tk ? a.pos_k[col] : 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.f;
  }
  // with same offsets, q tiles before this k tile hold no row >= k0
  const int qt0 = a.causal && a.same_offsets ? kt : 0;
  int computed = 0;
  __syncthreads();  // qr_s is staged

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float* qb = static_cast<const float*>(a.q) + h * a.q_hs;
    const float* ob = static_cast<const float*>(a.dout) + h * a.do_hs;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q_lo = qr_s[2 * qt];
      const int q_hi = qr_s[2 * qt + 1];
      if (q_hi < 0 || q_lo > k_hi || q_hi < k_lo) continue;  // uniform
      ++computed;
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's reads are done
      stage<DP>(qs, qb, a.q_rs, q0, tq, D);
      stage<DP>(dos, ob, a.do_rs, q0, tq, D);
      if (threadIdx.x < kTile) {
        const int r = threadIdx.x;
        const bool in = q0 + r < tq;
        const long long at = static_cast<long long>(h) * tq + q0 + r;
        ls[r] = in ? a.lse[at] : 0.f;
        dl[r] = in ? a.delta[at] : 0.f;
        sq_s[r] = in ? a.seg_q[q0 + r] : -1;
        pq_s[r] = in ? a.pos_q[q0 + r] : 0;
      }
      __syncthreads();

      // thread (ty, tx): key rows ty*4+i, q rows tx+16j
      float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < DP; ++d) {
        float x[4], w[4], b[4], gg[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = ks[d * kPad + ty * 4 + i];
          w[i] = vs[d * kPad + ty * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = qs[d * kPad + tx + 16 * j];
          gg[j] = dos[d * kPad + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(x[i], b[j], s[i][j]);
            dp[i][j] = fmaf(w[i], gg[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          // a pad row (-1) never equals a key id (>= 0 or -2), so a pad
          // row's dO reaches neither dK nor dV
          const bool ok =
              sq_s[r] == sk[i] && (!a.causal || pk[i] >= pq_s[r]);
          const float p = ok ? expf(s[i][j] * a.scale - ls[r]) : 0.f;
          pts[(ty * 4 + i) * kPS + r] = p;
          dst[(ty * 4 + i) * kPS + r] =
              ok ? p * (dp[i][j] - dl[r]) * a.scale : 0.f;
        }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = pts[(ty * 4 + i) * kPS + r];
          ds[i] = dst[(ty * 4 + i) * kPS + r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float go = dos[(tx + 16 * c) * kPad + r];
          const float qq = qs[(tx + 16 * c) * kPad + r];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[i][c] = fmaf(p[i], go, dva[i][c]);
            dka[i][c] = fmaf(ds[i], qq, dka[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= tk) continue;
    float* krow = dk + row * kv_rs + hk * D;
    float* vrow = dv + row * kv_rs + hk * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        krow[d] = dka[i][c];
        vrow[d] = dva[i][c];
      }
    }
  }
  if (a.tile_count != nullptr && threadIdx.x == 0)
    atomicAdd(a.tile_count, computed);
}

// Shared memory of each kernel, in bytes, for padded head dim DP and
// n_other tiles of the other axis (k tiles for fwd and dQ, q tiles for
// dK/dV), whose ranges are staged.
size_t fwd_bytes(int dp, int n_other) {
  return (3 * static_cast<size_t>(dp) * kPad + kTile * kPS) * sizeof(float) +
         (2 * kTile + 2 * static_cast<size_t>(n_other)) * sizeof(int);
}
size_t dq_bytes(int dp, int n_other) {
  return (4 * static_cast<size_t>(dp) * kPad + kTile * kPS) * sizeof(float) +
         (2 * kTile + 2 * static_cast<size_t>(n_other)) * sizeof(int);
}
size_t dkv_bytes(int dp, int n_other) {
  return (4 * static_cast<size_t>(dp) * kPad + 2 * kTile * kPS + 2 * kTile) *
             sizeof(float) +
         (2 * kTile + 2 * static_cast<size_t>(n_other)) * sizeof(int);
}

int padded_dim(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 128; }

// Shared memory of the bf16 tensor-core loops at padded head dim DP: the
// forward, dQ and dK/dV.
template <int DP>
size_t tc_bytes(int kernel) {
  using attn_bwd_sm90::dkv_smem_bytes;
  using attn_bwd_sm90::dq_smem_bytes;
  using attn_fwd_sm90::smem_bytes;
  return kernel == 3   ? smem_bytes<DP, VarlenPolicy>()
         : kernel == 4 ? dq_smem_bytes<DP>(VarlenPolicy::kExtraBytes)
                       : dkv_smem_bytes<DP, VarlenPolicy>();
}

// The backward's operands where the tensor-core loops read them: q, dO and
// dQ (tq, heads, d), K, V, dK and dV (tk, kv_heads, d), query head h
// reading KV head h / group.
attn_bwd_sm90::BwdLayout bwd_layout(int heads, int kv_heads, int d,
                                    long long q_rs, long long q_hs,
                                    long long k_rs, long long k_hs,
                                    long long v_rs, long long v_hs,
                                    long long do_rs, long long do_hs) {
  return {q_rs,  q_hs,  k_rs,  k_hs,
          v_rs,  v_hs,  do_rs, do_hs,
          static_cast<long long>(heads) * d, d,
          static_cast<long long>(kv_heads) * d, d,
          heads / kv_heads};
}

bool args_ok(int tq, int tk, int heads, int kv_heads, int d, int dtype) {
  return tq >= 1 && tk >= 1 && heads >= 1 && heads <= 65535 &&
         kv_heads >= 1 && heads % kv_heads == 0 && d >= 1 && d <= 128 &&
         (dtype == kF32 || dtype == kBF16);
}

// The tile ranges of seg_q and seg_k into `ranges`, on `stream`.
cudaError_t launch_ranges(const void* seg_q, const void* seg_k, int tq,
                          int tk, void* ranges, cudaStream_t stream) {
  const int n_qt = (tq + kTile - 1) / kTile;
  const int n_kt = (tk + kTile - 1) / kTile;
  constexpr int kRangeWarps = 8;
  tile_ranges_kernel<<<(n_qt + n_kt + kRangeWarps - 1) / kRangeWarps,
                       32 * kRangeWarps, 0, stream>>>(
      static_cast<const int*>(seg_q), static_cast<const int*>(seg_k), tq, tk,
      n_qt, n_kt, static_cast<int*>(ranges));
  return cudaGetLastError();
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int DP>
cudaError_t fwd_f32(const void* q, const void* k, const void* v,
                      const void* seg_q, const void* seg_k, const void* pos_q,
                      const void* pos_k, const void* ranges, void* o,
                      void* lse, int tq, int tk, int heads, int group, int d,
                      long long q_rs, long long q_hs, long long k_rs,
                      long long k_hs, long long v_rs, long long v_hs,
                      float scale, int causal, int same_offsets,
                      void* tile_count, cudaStream_t stream) {
  const int n_qt = (tq + kTile - 1) / kTile;
  const int n_kt = (tk + kTile - 1) / kTile;
  auto kernel = va_fwd_kernel<DP>;
  const size_t smem = fwd_bytes(DP, n_kt);
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(n_qt, heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<const int*>(pos_q),
      static_cast<const int*>(pos_k), static_cast<const int*>(ranges),
      static_cast<float*>(o), static_cast<float*>(lse), tq, tk, group, d, q_rs,
      q_hs, k_rs, k_hs, v_rs, v_hs, scale, causal, same_offsets,
      static_cast<int*>(tile_count));
  return cudaGetLastError();
}

template <int DP>
cudaError_t dq_f32(const BwdArgs& a, cudaStream_t stream) {
  const int n_qt = (a.tq + kTile - 1) / kTile;
  const int n_kt = (a.tk + kTile - 1) / kTile;
  auto kernel = va_dq_kernel<DP>;
  const size_t smem = dq_bytes(DP, n_kt);
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n_qt, a.heads), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dkv_f32(const BwdArgs& a, cudaStream_t stream) {
  const int n_qt = (a.tq + kTile - 1) / kTile;
  const int n_kt = (a.tk + kTile - 1) / kTile;
  auto kernel = va_dkv_kernel<DP>;
  const size_t smem = dkv_bytes(DP, n_qt);
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n_kt, a.kv_heads), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The BwdArgs of a backward call, and the tile ranges launched for it.
cudaError_t bwd_prepare(BwdArgs& a, const void* q, const void* k,
                        const void* v, const void* dout, const void* lse,
                        const void* delta, const void* seg_q,
                        const void* seg_k, const void* pos_q,
                        const void* pos_k, void* ranges, int tq, int tk,
                        int heads, int kv_heads, int d, long long q_rs,
                        long long q_hs, long long k_rs, long long k_hs,
                        long long v_rs, long long v_hs, long long do_rs,
                        long long do_hs, float scale, int causal,
                        int same_offsets, void* tile_count,
                        cudaStream_t s) {
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.seg_q = static_cast<const int*>(seg_q);
  a.seg_k = static_cast<const int*>(seg_k);
  a.pos_q = static_cast<const int*>(pos_q);
  a.pos_k = static_cast<const int*>(pos_k);
  a.ranges = static_cast<const int*>(ranges);
  a.dq = a.dk = a.dv = nullptr;
  a.tq = tq;
  a.tk = tk;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.D = d;
  a.q_rs = q_rs;
  a.q_hs = q_hs;
  a.k_rs = k_rs;
  a.k_hs = k_hs;
  a.v_rs = v_rs;
  a.v_hs = v_hs;
  a.do_rs = do_rs;
  a.do_hs = do_hs;
  a.scale = scale;
  a.causal = causal;
  a.same_offsets = same_offsets;
  a.tile_count = static_cast<int*>(tile_count);
  return launch_ranges(seg_q, seg_k, tq, tk, ranges, s);
}

}  // namespace

// The fp32 (CUDA-core) instantiation of F for the padded head dim.
#define VA_F32(F, ...)                    \
  const int dp = padded_dim(d);           \
  if (dp == 32) return F<32>(__VA_ARGS__); \
  if (dp == 64) return F<64>(__VA_ARGS__); \
  return F<128>(__VA_ARGS__)

#define VA_BWD_ARGS                                                         \
  q, k, v, dout, lse, delta, seg_q, seg_k, pos_q, pos_k, ranges, tq, tk,    \
      heads, kv_heads, d, q_rs, q_hs, k_rs, k_hs, v_rs, v_hs, do_rs, do_hs, \
      scale, causal, same_offsets, tile_count, s

extern "C" {

const char* va_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// seg_q (tq,) and seg_k (tk,) int32 -> pos_q (tq,) and pos_k (tk,) int32,
// each token's distance to its segment's end (ids non-decreasing, any
// negative id trailing), as the kernels below take them. Launches one
// kernel on `stream` and returns cudaGetLastError().
int va_positions(const void* seg_q, const void* seg_k, int tq, int tk,
                 void* pos_q, void* pos_k, void* stream) {
  if (tq < 1 || tk < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kPosThreads = 256;
  const long long n = static_cast<long long>(tq) + tk;
  positions_kernel<<<static_cast<unsigned>((n + kPosThreads - 1) /
                                           kPosThreads),
                     kPosThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg_q), static_cast<const int*>(seg_k), tq, tk,
      static_cast<int*>(pos_q), static_cast<int*>(pos_k));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory a kernel needs at head_dim d: kernel 0
// the fp32 forward and 1 dQ, for n_other k tiles; 2 the fp32 dK/dV, for
// n_other q tiles; 3, 4 and 5 the bf16 forward, dQ and dK/dV (tensor
// cores), whatever n_other.
size_t va_smem_bytes(int kernel, int n_other, int d) {
  const int dp = padded_dim(d);
  if (kernel >= 3)
    return dp == 32   ? tc_bytes<32>(kernel)
           : dp == 64 ? tc_bytes<64>(kernel)
                      : tc_bytes<128>(kernel);
  return kernel == 0   ? fwd_bytes(dp, n_other)
         : kernel == 1 ? dq_bytes(dp, n_other)
                       : dkv_bytes(dp, n_other);
}

// q: (tq, heads, d) read at q[t * q_rs + h * q_hs + i]; k, v: (tk, kv_heads,
// d) read likewise with their own strides (head_dim contiguous); seg_q,
// pos_q: (tq,) int32; seg_k, pos_k: (tk,) int32 (pos = distance to the
// segment's end); ranges: scratch of 3 * (ceil(tq/64) + ceil(tk/64)) int32;
// o: contiguous (tq, heads, d) in `dtype` (0 fp32, 1 bf16); lse: (heads, tq)
// fp32; tile_count: null, or one int32 to which the number of computed
// (q tile, k tile, head) triples is added. Launches two kernels on
// `stream`, allocates nothing, and returns cudaGetLastError(). bf16 runs
// the tensor-core kernel, which also needs d % 8 == 0, 16-byte aligned q,
// k, v and o, and every row and head stride a multiple of 8.
int va_fwd(const void* q, const void* k, const void* v, const void* seg_q,
           const void* seg_k, const void* pos_q, const void* pos_k,
           void* ranges, void* o, void* lse, int tq, int tk, int heads,
           int kv_heads, int d, long long q_rs, long long q_hs,
           long long k_rs, long long k_hs, long long v_rs, long long v_hs,
           float scale, int causal, int same_offsets, int dtype,
           void* tile_count, void* stream) {
  if (!args_ok(tq, tk, heads, kv_heads, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_ranges(seg_q, seg_k, tq, tk, ranges, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dtype == kBF16) {
    const attn_fwd_sm90::Layout lay{
        q_rs, q_hs, k_rs, k_hs, v_rs, v_hs,
        static_cast<long long>(heads) * d, d, heads / kv_heads};
    return static_cast<int>(attn_fwd_sm90::run(
        q, k, v, o, lse, lay, heads, tq, tk, d, scale,
        varlen_policy(seg_q, seg_k, pos_q, pos_k, ranges, tq, tk, causal,
                      same_offsets),
        static_cast<int*>(tile_count), s));
  }
  const int dp = padded_dim(d);
  const auto fwd = dp == 32   ? fwd_f32<32>
                   : dp == 64 ? fwd_f32<64>
                              : fwd_f32<128>;
  return static_cast<int>(fwd(q, k, v, seg_q, seg_k, pos_q, pos_k, ranges, o,
                              lse, tq, tk, heads, heads / kv_heads, d, q_rs,
                              q_hs, k_rs, k_hs, v_rs, v_hs, scale, causal,
                              same_offsets, tile_count, s));
}

// The backward: q, k, v, seg and pos as for va_fwd; dout (tq, heads, d) in
// `dtype`, read at dout[t * do_rs + h * do_hs + i]; lse and delta (heads,
// tq) fp32 contiguous; va_bwd_dq writes dq, contiguous (tq, heads, d), and
// va_bwd_dkv dk and dv, contiguous (tk, kv_heads, d), all in `dtype`;
// tile_count: null, or one int32 to which the number of computed (q tile,
// k tile, query head) triples is added. Each launches two kernels on
// `stream`, allocates nothing, and returns cudaGetLastError(). bf16 runs
// the tensor-core loops of attn_bwd_sm90.cuh, which also need d % 8 == 0,
// 16-byte aligned bf16 operands and outputs, and every row and head
// stride a multiple of 8.
int va_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* seg_q,
              const void* seg_k, const void* pos_q, const void* pos_k,
              void* ranges, void* dq, int tq, int tk, int heads,
              int kv_heads, int d, long long q_rs, long long q_hs,
              long long k_rs, long long k_hs, long long v_rs,
              long long v_hs, long long do_rs, long long do_hs, float scale,
              int causal, int same_offsets, int dtype, void* tile_count,
              void* stream) {
  if (!args_ok(tq, tk, heads, kv_heads, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    const cudaError_t e = launch_ranges(seg_q, seg_k, tq, tk, ranges, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(attn_bwd_sm90::run_dq(
        q, k, v, dout, lse, delta, dq,
        bwd_layout(heads, kv_heads, d, q_rs, q_hs, k_rs, k_hs, v_rs, v_hs,
                   do_rs, do_hs),
        heads, tq, tk, d, scale,
        varlen_policy(seg_q, seg_k, pos_q, pos_k, ranges, tq, tk, causal,
                      same_offsets),
        static_cast<int*>(tile_count), s));
  }
  BwdArgs a;
  const cudaError_t e = bwd_prepare(a, VA_BWD_ARGS);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.dq = dq;
  VA_F32(dq_f32, a, s);
}

int va_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* seg_q,
               const void* seg_k, const void* pos_q, const void* pos_k,
               void* ranges, void* dk, void* dv, int tq, int tk, int heads,
               int kv_heads, int d, long long q_rs, long long q_hs,
               long long k_rs, long long k_hs, long long v_rs,
               long long v_hs, long long do_rs, long long do_hs, float scale,
               int causal, int same_offsets, int dtype, void* tile_count,
               void* stream) {
  if (!args_ok(tq, tk, heads, kv_heads, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    const cudaError_t e = launch_ranges(seg_q, seg_k, tq, tk, ranges, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(attn_bwd_sm90::run_dkv(
        q, k, v, dout, lse, delta, dk, dv,
        bwd_layout(heads, kv_heads, d, q_rs, q_hs, k_rs, k_hs, v_rs, v_hs,
                   do_rs, do_hs),
        heads, tq, tk, d, scale,
        varlen_policy(seg_q, seg_k, pos_q, pos_k, ranges, tq, tk, causal,
                      same_offsets),
        static_cast<int*>(tile_count), s));
  }
  BwdArgs a;
  const cudaError_t e = bwd_prepare(a, VA_BWD_ARGS);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.dk = dk;
  a.dv = dv;
  VA_F32(dkv_f32, a, s);
}

}  // extern "C"
