// FlashMask attention for Hopper (sm_90a): forward, dQ and dK/dV, plain
// C interface for ctypes.
//
// Replaces the three TPU kernels of paddle_tpu/ops/flashmask_attention.py:
//   fm_fwd     -> `_fwd_kernel`     (:248, launched by `_fwd_pallas`)
//   fm_bwd_dq  -> `_bwd_dq_kernel`  (:305, launched by `_bwd_pallas`)
//   fm_bwd_dkv -> `_bwd_dkv_kernel` (:353, launched by `_bwd_pallas`)
// What they compute, per (batch*head) slice of (BH, S, D) operands: the
// flash attention of csrc/flash_attention.cu (S = Q K^T * scale; forward
// O = softmax(S) V and lse; backward from lse and delta = rowsum(dO * O):
// P = exp(S - lse), dP = dO V^T, dS = P (dP - delta) scale, dQ = dS K,
// dK = dS^T Q, dV = P^T dO) under a sparse mask given per key column j
// by start/end row indices sri (B, Hs, S_k, n) int32, Hs = 1 or H:
//   causal,  n=1: masked <=> r >= start_j
//   causal,  n=2: masked <=> start_j <= r < end_j
//   ~causal, n=2: masked <=> r >= start_j or r < end_j
//   ~causal, n=4: masked <=> s0_j <= r < e0_j or s1_j <= r < e1_j
// plus the causal triangle (top-left, rows >= cols), an optional window
// (left, right) and the ragged bounds; and, optionally, dropout of the
// normalized probabilities by a murmur hash of (row, col, b*H + h, seed)
// in uint32, the hash of `dropout_keep_mask` (:65), so all three kernels
// regenerate one mask: lse takes the undropped P, O and dV the dropped
// P, and dP is dropped before dS.
//
// Two designs, picked by dtype:
//   * bf16: the tensor-core tile loops of attn_fwd_sm90.cuh (forward:
//     mma.sync, cp.async K/V ring, softmax and P in registers, P entering
//     PV as two bf16 terms) and attn_bwd_sm90.cuh (dQ and dK/dV: the same
//     ring over K/V or over Q, dO, lse and delta; P and dS in registers,
//     entering their products as two bf16 terms), with `FmPolicy` below
//     as their mask. Every skip decision is known before a tile's copies
//     are issued: a first small kernel (`tile_agg_kernel`, launched by
//     fm_fwd and, once per backward, by fm_tile_agg) reduces each sri
//     index over each 64-column k tile (columns < S_k only) to its max and
//     its min. The max of the starts and the min of the ends give the
//     all-masked skip (`_sri_all_masked`, :109); the min of the starts and
//     the max of the ends show a tile that no interval touches. A tile
//     that is also wholly under the diagonal, inside the window and inside
//     the ragged bounds is wholly kept and skips the per-pair mask. The
//     q-major loops (forward, dQ) read a q tile's row of these decisions,
//     the k-major one (dK/dV) a k tile's column, by one rule
//     (`pair_needed`, `pair_full`; `tile_plan` of the Python module is its
//     plain twin). A partial tile of the q-major loops copies its sri
//     columns beside K and V; the dK/dV loop reads each thread's two key
//     columns once, from device memory (`key_span`). Dropout applies to
//     the fp32 P before its split into bf16 terms, never to l, and to dP
//     before dS.
//   * fp32: the CUDA-core design below. Its results hold the plain
//     versions to 1e-5, which TF32 tensor cores would not.
//
// The CUDA-core design: the structure of csrc/flash_attention.cu (64-row
// tiles, 256 threads as 16 x 16, fp32 tiles d-major at a stride of 65
// floats, row statistics by xor butterflies, dK/dV as its own kernel with
// one block per k tile and no atomics), plus what FlashMask adds:
//   * sri is read in place, indexed by head stride: the (B, 1, S, n)
//     mask of packed documents serves all H heads without a copy.
//   * Block skip. For each (q tile, k tile) the causal and window tile
//     tests come first (no loads), then the tile's sri columns are
//     staged in shared memory (one int per thread) and reduced by warp
//     shuffles to the max of every start and the min of every end, over
//     the columns < S_k only (the TPU kernel lets padding lanes weaken
//     the test; here they would be out-of-bounds reads). A tile whose
//     every pair is masked (`_sri_all_masked`, :109) costs no load of Q,
//     K or V: the block's own Q (or K and V) tile is staged at its
//     first kept tile. dK/dV stages its k tile's columns once.
//   * The per-pair mask compares row ids with the staged columns; after
//     exp every masked entry is zeroed (a row with every pair masked
//     has m = lse = -1e30, where exp(s - lse) would be 1).
// Every kernel counts the (q tile, k tile) pairs it computes into an
// optional counter.
//
// What bounds it: on packed documents the work is the kept pairs, not
// S^2: at B=1, H=32, S=8192, D=128 with eight documents of 192-3000
// tokens, 7.14 M of the 33.6 M causal pairs per head, so 117 / 176 /
// 234 GFLOP for fwd / dQ / dK-dV, 0.118 / 0.177 / 0.237 ms at the bf16
// tensor-core rate of 989 TFLOP/s, against 0.01-0.02 ms for the bytes:
// bound by operations. The fp32 kernels compute on the CUDA cores (67
// TFLOP/s) and load tiles synchronously. Tiles that straddle a document
// edge are computed whole.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

#include "attn_bwd_sm90.cuh"
#include "attn_fwd_sm90.cuh"

namespace {

using attn_fwd_sm90::chunk_at;
using attn_fwd_sm90::out_cols;

constexpr int kThreads = 256;    // 16 x 16
constexpr int kTile = 64;        // rows of a q tile and of a k tile
constexpr int kPad = kTile + 1;  // stride of a d-major staged tile
constexpr int kPS = kTile + 4;   // stride of a row of a score tile
constexpr int kMaxN = 4;         // widest sri
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

// Sum / max over the 16 lanes that share a row (tx = lane % 16).
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

// Stage rows [row0, row0 + kTile) of one (rows, D) slice into shared
// memory, d-major: dst[d * kPad + r]; rows past `rows` and dims past D
// (up to DP) are zero. Rows lie ld elements apart (D, or the head dim of
// a column chunk).
template <int DP>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src, int row0,
                                      int rows, int D, int ld) {
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP;
    const int d = i % DP;
    float x = 0.f;
    if (row0 + r < rows && d < D)
      x = src[static_cast<size_t>(row0 + r) * ld + d];
    dst[d * kPad + r] = x;
  }
}
template <int DP>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src, int row0,
                                      int rows, int D) {
  stage<DP>(dst, src, row0, rows, D, D);
}

// Wide heads (DP = 192 or 256), as in csrc/flash_attention.cu: dQ and
// dK/dV keep their block's own operands whole and stream the other two in
// chunks of 64 dims for the score products; a block owns one chunk of its
// output's columns (grid z), streamed last: `attn_fwd_sm90::out_cols`
// dims at once, in the order `attn_fwd_sm90::chunk_at` gives.

// What masks a pair besides the ragged bounds.
struct Mask {
  const int* sri;  // (B, Hs, sk, n) int32; null when n == 0
  int heads;       // H: bh = b * H + h
  int sri_heads;   // Hs: 1 or H
  int n;           // 0 (no sri), 1, 2 or 4
  int causal;
  int has_window;
  int wl, wr;      // window (left, right)
  int dropout;
  unsigned seed, thresh;  // keep <=> hash >= thresh
  float inv;              // fp32(1 / (1 - rate))
};

__device__ __forceinline__ const int* sri_of(const Mask& m, int bh, int sk) {
  const int b = bh / m.heads;
  const int h = m.sri_heads == 1 ? 0 : bh % m.heads;
  return m.sri + (static_cast<size_t>(b) * m.sri_heads + h) * sk * m.n;
}

// Stage the indices of key columns [k0, k0 + kTile) as cols[i * kTile +
// c] (thread t < n * kTile loads index i = t / kTile of column c = t %
// kTile) and reduce each index over its columns: half[2 * i + c / 32]
// holds the max (starts, even i) or the min (ends, odd i) over one warp's
// 32 columns. Columns past sk take the reduction's identity, so they
// neither load nor weaken the skip test. Call between two
// __syncthreads().
__device__ __forceinline__ void stage_sri(int* cols, int* half,
                                          const int* __restrict__ sri,
                                          int k0, int sk, int n) {
  const int t = threadIdx.x;
  if (t >= n * kTile) return;  // whole warps: n * kTile is a multiple of 32
  const int i = t / kTile;
  const int c = t % kTile;
  const bool start = (i % 2) == 0;
  int x = start ? INT_MIN : INT_MAX;
  if (k0 + c < sk) x = sri[static_cast<size_t>(k0 + c) * n + i];
  cols[t] = x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int y = __shfl_xor_sync(0xffffffffu, x, o);
    x = start ? max(x, y) : min(x, y);
  }
  if ((t & 31) == 0) half[t / 32] = x;
}

// Index i of the staged tile, reduced over all its columns.
__device__ __forceinline__ int agg(const int* half, int i) {
  return (i % 2) == 0 ? max(half[2 * i], half[2 * i + 1])
                      : min(half[2 * i], half[2 * i + 1]);
}

// True when the indices mask every pair of rows [r0, r1] and a tile's
// columns (`_sri_all_masked`); at(i) is index i reduced over those
// columns: the max of a start (i even), the min of an end (i odd).
template <class At>
__device__ __forceinline__ bool all_masked(int r0, int r1, At at,
                                           const Mask& m) {
  if (m.n == 1) return r0 >= at(0);
  if (m.n == 2) {
    const bool below = r0 >= at(0);
    const bool above = r1 < at(1);
    return m.causal ? (below && above) : (below || above);
  }
  return (r0 >= at(0) && r1 < at(1)) || (r0 >= at(2) && r1 < at(3));
}

// all_masked over the columns staged by stage_sri.
__device__ __forceinline__ bool sri_all_masked(int r0, int r1,
                                               const int* half,
                                               const Mask& m) {
  return all_masked(r0, r1, [half](int i) { return agg(half, i); }, m);
}

// The tile tests of `_block_keep` (:129) that need no load: false when
// the causal triangle or the window hides rows [r0, r1] x cols [c0, c1].
__device__ __forceinline__ bool tile_may_keep(int r0, int r1, int c0, int c1,
                                              const Mask& m) {
  if (m.causal && r1 < c0) return false;
  if (m.has_window) {
    if (static_cast<long long>(c1) < static_cast<long long>(r0) - m.wl)
      return false;
    if (!m.causal && static_cast<long long>(c0) >
                         static_cast<long long>(r1) + m.wr)
      return false;
  }
  return true;
}

// Whether pair (row, col) is visible; c is col's place in the staged
// tile `cols`.
__device__ __forceinline__ bool keep_pair(int row, int col, int c,
                                          const int* cols, int sq, int sk,
                                          const Mask& m) {
  if (row >= sq || col >= sk) return false;
  if (m.causal && row < col) return false;
  if (m.has_window) {
    const long long r = row;
    if (col < r - m.wl) return false;
    if (!m.causal && col > r + m.wr) return false;
  }
  if (m.n == 0) return true;
  const int s0 = cols[c];
  if (m.n == 1) return row < s0;
  const int e0 = cols[kTile + c];
  if (m.n == 2)
    return m.causal ? !(row >= s0 && row < e0) : !(row >= s0 || row < e0);
  const int s1 = cols[2 * kTile + c];
  const int e1 = cols[3 * kTile + c];
  return !((row >= s0 && row < e0) || (row >= s1 && row < e1));
}

// The dropout keep test of `dropout_keep_mask`, on absolute coordinates.
__device__ __forceinline__ bool drop_keep(unsigned row, unsigned col,
                                          unsigned bh, const Mask& m) {
  unsigned x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u) ^
               (bh * 0xC2B2AE3Du) ^ m.seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= m.thresh;
}

// ------------------------------------------------------------- forward
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    fm_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int sq, int sk, int D,
                  float scale, Mask m, int* __restrict__ tile_count) {
  constexpr int NC = DP / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + DP * kPad;
  float* vs = ks + DP * kPad;
  float* ps = vs + DP * kPad;  // kTile x kPS: the dropped P of the tile
  int* cols = reinterpret_cast<int*>(ps + kTile * kPS);  // kMaxN x kTile
  int* half = cols + kMaxN * kTile;                      // 2 * kMaxN

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n_qt = (sq + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - blockIdx.x) * kTile;  // longest causal rows first
  const int r1 = min(q0 + kTile, sq) - 1;
  const int bh = blockIdx.y;
  const float* kb = k + static_cast<size_t>(bh) * sk * D;
  const float* vb = v + static_cast<size_t>(bh) * sk * D;
  const int* sri = m.n ? sri_of(m, bh, sk) : nullptr;

  float mr[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mr[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  bool q_staged = false;
  int computed = 0;
  int n_kt = (sk + kTile - 1) / kTile;
  if (m.causal) n_kt = min(n_kt, r1 / kTile + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_may_keep(q0, r1, k0, min(k0 + kTile, sk) - 1, m)) continue;
    __syncthreads();  // the previous tile's reads of shared memory are done
    if (m.n) {
      stage_sri(cols, half, sri, k0, sk, m.n);
      __syncthreads();
      if (sri_all_masked(q0, r1, half, m)) continue;
    }
    ++computed;
    if (!q_staged) {
      stage<DP>(qs, q + static_cast<size_t>(bh) * sq * D, q0, sq, D);
      q_staged = true;
    }
    stage<DP>(ks, kb, k0, sk, D);
    stage<DP>(vs, vb, k0, sk, D);
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
      const int row = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        ok[j] = keep_pair(row, k0 + c, c, cols, sq, sk, m);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(mr[i], row_max(mx));
      const float alpha = expf(mr[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        // masked columns give exactly 0, even while m_new is kNegInf
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;  // l takes the undropped P
        float pd = p;
        if (m.dropout) pd = drop_keep(row, k0 + c, bh, m) ? p * m.inv : 0.f;
        ps[(ty * 4 + i) * kPS + c] = pd;
      }
      l[i] = alpha * l[i] + row_sum(sum);
      mr[i] = m_new;
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

  // rows that kept nothing: o = 0, lse = -1e30 (m stays kNegInf, l 0)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = acc[i][c] / ls;
    }
    if (tx == 0) lse[static_cast<size_t>(bh) * sq + row] = mr[i] + logf(ls);
  }
  if (tile_count != nullptr && threadIdx.x == 0)
    atomicAdd(tile_count, computed);
}

// ------------------------------------------------------------------ dQ
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    fm_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int sq, int sk, int D, float scale, Mask m,
                 int* __restrict__ tile_count) {
  constexpr int DC = out_cols<DP>();  // K and V dims staged at once
  constexpr int NCH = DP / DC;
  constexpr int NC = DC / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + DP * kPad;
  float* ks = dos + DP * kPad;  // DC dims of K
  float* vs = ks + DC * kPad;   // DC dims of V
  float* dss = vs + DC * kPad;  // kTile x kPS
  int* cols = reinterpret_cast<int*>(dss + kTile * kPS);
  int* half = cols + kMaxN * kTile;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n_qt = (sq + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - blockIdx.x) * kTile;
  const int r1 = min(q0 + kTile, sq) - 1;
  const int bh = blockIdx.y;
  const int oc = blockIdx.z;  // this block's chunk of dQ's columns
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const float* kb = k + static_cast<size_t>(bh) * sk * D;
  const float* vb = v + static_cast<size_t>(bh) * sk * D;
  const int* sri = m.n ? sri_of(m, bh, sk) : nullptr;

  float lr[4], dr[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lr[i] = row < sq ? lse[qoff + row] : 0.f;
    dr[i] = row < sq ? delta[qoff + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  bool q_staged = false;
  int computed = 0;
  int n_kt = (sk + kTile - 1) / kTile;
  if (m.causal) n_kt = min(n_kt, r1 / kTile + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_may_keep(q0, r1, k0, min(k0 + kTile, sk) - 1, m)) continue;
    __syncthreads();
    if (m.n) {
      stage_sri(cols, half, sri, k0, sk, m.n);
      __syncthreads();
      if (sri_all_masked(q0, r1, half, m)) continue;
    }
    ++computed;
    if (!q_staged) {
      stage<DP>(qs, q + qoff * D, q0, sq, D);
      stage<DP>(dos, dout + qoff * D, q0, sq, D);
      q_staged = true;
    }
    float s[4][4] = {}, dp[4][4] = {};
    for (int ci = 0; ci < NCH; ++ci) {
      const int c0 = chunk_at<NCH, DC>(ci, oc);
      if (ci > 0) __syncthreads();  // the previous chunk's reads are done
      stage<DC>(ks, kb + c0, k0, sk, D - c0, D);
      stage<DC>(vs, vb + c0, k0, sk, D - c0, D);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < DC; ++d) {
        float a[4], g[4], b[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = qs[(c0 + d) * kPad + ty * 4 + i];
          g[i] = dos[(c0 + d) * kPad + ty * 4 + i];
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
            s[i][j] = fmaf(a[i], b[j], s[i][j]);
            dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty * 4 + i;
        const int c = tx + 16 * j;
        const bool ok = keep_pair(row, k0 + c, c, cols, sq, sk, m);
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        float g = dp[i][j];
        if (m.dropout) g = drop_keep(row, k0 + c, bh, m) ? g * m.inv : 0.f;
        dss[(ty * 4 + i) * kPS + c] = ok ? p * (g - dr[i]) * scale : 0.f;
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
    if (row >= sq) continue;
    float* drow = dq + (qoff + row) * D + oc * DC;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D - oc * DC) drow[d] = acc[i][c];
    }
  }
  if (tile_count != nullptr && threadIdx.x == 0 && oc == 0)
    atomicAdd(tile_count, computed);
}

// --------------------------------------------------------------- dK/dV
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    fm_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int sq, int sk, int D, float scale,
                  Mask m, int* __restrict__ tile_count) {
  constexpr int DC = out_cols<DP>();  // Q and dO dims staged at once
  constexpr int NCH = DP / DC;
  constexpr int NC = DC / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + DP * kPad;
  float* qs = vs + DP * kPad;      // DC dims of Q
  float* dos = qs + DC * kPad;     // DC dims of dO
  float* pts = dos + DC * kPad;    // kTile x kPS: dropped P^T of the tile
  float* dst = pts + kTile * kPS;  // kTile x kPS: dS^T of the tile
  float* ls = dst + kTile * kPS;   // lse of the tile's q rows
  float* dl = ls + kTile;          // delta of the tile's q rows
  int* cols = reinterpret_cast<int*>(dl + kTile);
  int* half = cols + kMaxN * kTile;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kTile;
  const int c1 = min(k0 + kTile, sk) - 1;
  const int bh = blockIdx.y;
  const int oc = blockIdx.z;  // this block's chunk of dK's and dV's columns
  const size_t qoff = static_cast<size_t>(bh) * sq;
  const size_t koff = static_cast<size_t>(bh) * sk;

  // this block's columns are fixed: stage their indices once
  if (m.n) {
    stage_sri(cols, half, sri_of(m, bh, sk), k0, sk, m.n);
    __syncthreads();
  }
  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.f;
  bool kv_staged = false;
  int computed = 0;

  const int n_qt = (sq + kTile - 1) / kTile;
  // the first q tile holding a row >= k0 (rows below see none of k0..)
  const int qt0 = m.causal ? k0 / kTile : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    const int r1 = min(q0 + kTile, sq) - 1;
    if (!tile_may_keep(q0, r1, k0, c1, m)) continue;
    if (m.n && sri_all_masked(q0, r1, half, m)) continue;
    ++computed;
    // thread (ty, tx): key rows ty*4+i, q rows tx+16j
    float s[4][4] = {}, dp[4][4] = {};
    for (int ci = 0; ci < NCH; ++ci) {
      const int c0 = chunk_at<NCH, DC>(ci, oc);
      __syncthreads();
      if (!kv_staged) {
        stage<DP>(ks, k + koff * D, k0, sk, D);
        stage<DP>(vs, v + koff * D, k0, sk, D);
        kv_staged = true;
      }
      stage<DC>(qs, q + qoff * D + c0, q0, sq, D - c0, D);
      stage<DC>(dos, dout + qoff * D + c0, q0, sq, D - c0, D);
      if (ci == 0) {
        for (int r = threadIdx.x; r < kTile; r += kThreads) {
          const bool in = q0 + r < sq;
          ls[r] = in ? lse[qoff + q0 + r] : 0.f;
          dl[r] = in ? delta[qoff + q0 + r] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < DC; ++d) {
        float a[4], w[4], b[4], g[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = ks[(c0 + d) * kPad + ty * 4 + i];
          w[i] = vs[(c0 + d) * kPad + ty * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = qs[d * kPad + tx + 16 * j];
          g[j] = dos[d * kPad + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i], b[j], s[i][j]);
            dp[i][j] = fmaf(w[i], g[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const int c = ty * 4 + i;
        const bool ok = keep_pair(q0 + r, k0 + c, c, cols, sq, sk, m);
        const float p = ok ? expf(s[i][j] * scale - ls[r]) : 0.f;
        float pd = p, g = dp[i][j];
        if (m.dropout) {
          const bool kd = drop_keep(q0 + r, k0 + c, bh, m);
          pd = kd ? p * m.inv : 0.f;
          g = kd ? g * m.inv : 0.f;
        }
        pts[c * kPS + r] = pd;
        dst[c * kPS + r] = ok ? p * (g - dl[r]) * scale : 0.f;
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
        const float g = dos[(tx + 16 * c) * kPad + r];
        const float a = qs[(tx + 16 * c) * kPad + r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dva[i][c] = fmaf(p[i], g, dva[i][c]);
          dka[i][c] = fmaf(ds[i], a, dka[i][c]);
        }
      }
    }
  }

  // key rows that no kept pair reaches get zero gradients
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= sk) continue;
    float* krow = dk + (koff + row) * D + oc * DC;
    float* vrow = dv + (koff + row) * D + oc * DC;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D - oc * DC) {
        krow[d] = dka[i][c];
        vrow[d] = dva[i][c];
      }
    }
  }
  if (tile_count != nullptr && threadIdx.x == 0 && oc == 0)
    atomicAdd(tile_count, computed);
}

// Shared memory of each kernel, in 4-byte words, for padded head dim DP
// (dQ and dK/dV: two whole tiles and two streamed chunks).
constexpr size_t kSriWords = kMaxN * kTile + 2 * kMaxN;
size_t fwd_words(int dp) { return 3 * dp * kPad + kTile * kPS + kSriWords; }
size_t dq_words(int dp) {
  return 2 * (dp + out_cols(dp)) * kPad + kTile * kPS + kSriWords;
}
size_t dkv_words(int dp) {
  return 2 * (dp + out_cols(dp)) * kPad + 2 * kTile * kPS + 2 * kTile +
         kSriWords;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int padded_dim(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : d <= 192 ? 192 : 256;
}

template <int DP>
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* o,
                    void* lse, int bh, int sq, int sk, int d, float scale,
                    Mask m, int* tile_count, cudaStream_t stream) {
  auto kernel = fm_fwd_kernel<DP>;
  const size_t smem = fwd_words(DP) * 4;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sq + kTile - 1) / kTile, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), sq, sk, d, scale, m, tile_count);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dq_f32(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int sq, int sk, int d, float scale,
                   Mask m, int* tile_count, cudaStream_t stream) {
  auto kernel = fm_dq_kernel<DP>;
  const size_t smem = dq_words(DP) * 4;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sq + kTile - 1) / kTile, bh, DP / out_cols<DP>());
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), sq, sk, d, scale, m, tile_count);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dkv_f32(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int bh, int sq, int sk, int d,
                    float scale, Mask m, int* tile_count,
                    cudaStream_t stream) {
  auto kernel = fm_dkv_kernel<DP>;
  const size_t smem = dkv_words(DP) * 4;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sk + kTile - 1) / kTile, bh, DP / out_cols<DP>());
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, d, scale, m,
      tile_count);
  return cudaGetLastError();
}

bool args_ok(const void* sri, int b, int h, int sq, int sk, int d,
             int sri_heads, int n, int causal, int dtype) {
  const bool n_ok = causal ? (n == 0 || n == 1 || n == 2)
                           : (n == 0 || n == 2 || n == 4);
  return b >= 1 && h >= 1 && b * h <= 65535 && sq >= 1 && sk >= 1 &&
         d >= 1 && d <= attn_fwd_sm90::kMaxHeadDim &&
         (dtype == kF32 || dtype == kBF16) && n_ok &&
         (n == 0 || (sri != nullptr && (sri_heads == 1 || sri_heads == h)));
}

// ------------------------------------------------- tensor-core loops
// Tile aggregates for FmPolicy: for every (b, sri head) slice, 64-column
// k tile and sri index i, the max (agg[2 i]) and the min (agg[2 i + 1])
// of the index over the tile's columns < sk, at agg[((slice * n_kt) + kt)
// * 2 n + ...]. One warp a tile.
constexpr int kAggWarps = 8;

__global__ void tile_agg_kernel(const int* __restrict__ sri, int slices,
                                int sk, int n, int* __restrict__ agg) {
  const int n_kt = (sk + kTile - 1) / kTile;
  const int w = blockIdx.x * kAggWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= slices * n_kt) return;  // whole warps
  const int kt = w % n_kt;
  const int* base = sri + static_cast<size_t>(w / n_kt) * sk * n;
  for (int i = 0; i < n; ++i) {
    int mx = INT_MIN, mn = INT_MAX;
    for (int c = kt * kTile + lane; c < min(kt * kTile + kTile, sk); c += 32) {
      const int x = base[static_cast<size_t>(c) * n + i];
      mx = max(mx, x);
      mn = min(mn, x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    if (lane == 0) {
      agg[static_cast<size_t>(w) * 2 * n + 2 * i] = mx;
      agg[static_cast<size_t>(w) * 2 * n + 2 * i + 1] = mn;
    }
  }
}

cudaError_t launch_tile_agg(const void* sri, void* agg, int slices, int sk,
                            int n, cudaStream_t stream) {
  const int tiles = slices * ((sk + kTile - 1) / kTile);
  tile_agg_kernel<<<(tiles + kAggWarps - 1) / kAggWarps, 32 * kAggWarps, 0,
                    stream>>>(static_cast<const int*>(sri), slices, sk, n,
                              static_cast<int*>(agg));
  return cudaGetLastError();
}

// The mask of the tensor-core loops (attn_fwd_sm90.cuh, attn_bwd_sm90.cuh):
// keep_pair's test and drop_keep's dropout, with the skip and wholly-kept
// tests read from the tile aggregates. A partial tile of a q-major loop
// copies its sri columns as cols[c * n + i], the layout of sri itself;
// `kMaxN` ints a column leave room for span's reads of four.
struct FmPolicy {
  static constexpr size_t kExtraBytes = kMaxN * kTile * sizeof(int);
  static constexpr bool kRowTest = false;  // partial tiles by span
  static constexpr bool kMayDrop = true;   // dropout when m.dropout
  Mask m;
  const int* agg;  // tile_agg_kernel's output
  // span's flags, from m (`set_span`): a lower bound from the causal
  // triangle (lo_sub 0) or the right window (lo_sub wr), an upper one from
  // the left window; sri start 0 as an upper bound (n=1, ~causal n=2),
  // end 0 as a lower bound (~causal n=2), holes [s0, e0) (causal n=2,
  // n=4) and [s1, e1) (n=4)
  bool lo_on, hi_on, hi_x0, lo_x1, hole1, hole2;
  int lo_sub;
  const int* sri;  // this block's head
  const int* ta;   // this block's head's aggregates
  int bh, q0, r1, kt, sq, sk;

  void set_span() {
    lo_on = m.causal || m.has_window;
    lo_sub = m.causal ? 0 : m.wr;
    hi_on = m.has_window;
    hi_x0 = m.n == 1 || (m.n == 2 && !m.causal);
    lo_x1 = m.n == 2 && !m.causal;
    hole1 = (m.n == 2 && m.causal) || m.n == 4;
    hole2 = m.n == 4;
  }

  // this block's (batch*head) slice: its sri and aggregates
  __device__ __forceinline__ void slice(int bh_, int sq_, int sk_) {
    bh = bh_;
    sq = sq_;
    sk = sk_;
    if (m.n) {
      const int b = bh / m.heads;
      const int h = m.sri_heads == 1 ? 0 : bh % m.heads;
      const size_t sl = static_cast<size_t>(b) * m.sri_heads + h;
      sri = m.sri + sl * sk * m.n;
      ta = agg + sl * ((sk + kTile - 1) / kTile) * 2 * m.n;
    }
  }

  // the q-major loops (forward, dQ): this block's q tile
  __device__ __forceinline__ void begin(int bh_, int q0_, int sq_, int sk_) {
    slice(bh_, sq_, sk_);
    q0 = q0_;
    r1 = min(q0 + kTile, sq) - 1;
  }
  __device__ __forceinline__ int end() const {
    const int n_kt = (sk + kTile - 1) / kTile;
    return m.causal ? min(n_kt, r1 / kTile + 1) : n_kt;
  }
  __device__ __forceinline__ bool needed(int kt_) const {
    return pair_needed(q0, kt_);
  }
  __device__ __forceinline__ bool full(int kt_) const {
    return pair_full(q0, kt_);
  }
  __device__ __forceinline__ void stage(int kt_, void* extra) const {
    if (m.n == 0) return;
    int* cols = static_cast<int*>(extra);
    const int k0 = kt_ * kTile;
    for (int i = threadIdx.x; i < kTile * m.n; i += attn_fwd_sm90::kThreads) {
      const bool in = k0 + i / m.n < sk;
      attn_fwd_sm90::cp_async4(
          cols + i, in ? sri + static_cast<size_t>(k0) * m.n + i : sri,
          in ? 4 : 0);
    }
  }
  // n <= 4 ints a column; with fewer, the reads past them stay inside the
  // staged tile and are not used
  __device__ __forceinline__ attn_fwd_sm90::Span span(int col, int c,
                                                      const void* extra) const {
    const int* x = static_cast<const int*>(extra) + c * m.n;
    return span_of(col, x[0], x[1], x[2], x[3]);
  }
  __host__ __device__ __forceinline__ bool drops() const {
    return m.dropout != 0;
  }
  __device__ __forceinline__ float drop(float p, int row, int col) const {
    return drop_keep(row, col, bh, m) ? p * m.inv : 0.f;
  }

  // the k-major loop (dK/dV): this block's k tile, read as a column of the
  // same decisions; under causal masking no q tile before the one holding
  // row k0 sees it, and with n=1 none at or past the largest start of its
  // columns (`_sri_all_masked` for every later q tile)
  __device__ __forceinline__ void begin_k(int bh_, int k0_, int sq_,
                                          int sk_) {
    slice(bh_, sq_, sk_);
    kt = k0_ / kTile;
  }
  __device__ __forceinline__ int q_begin() const { return m.causal ? kt : 0; }
  __device__ __forceinline__ int q_end() const {
    const int n_qt = (sq + kTile - 1) / kTile;
    if (m.n != 1) return n_qt;
    const int start = max(min(ta[2 * kt], sq), 0);
    return min(n_qt, (start + kTile - 1) / kTile);
  }
  __device__ __forceinline__ bool needed_q(int qt) const {
    return pair_needed(qt * kTile, kt);
  }
  __device__ __forceinline__ bool full_q(int qt) const {
    return pair_full(qt * kTile, kt);
  }
  // the rows key column col keeps, from its n ints read in place; a
  // column past sk keeps none and reads nothing
  __device__ __forceinline__ attn_fwd_sm90::Span key_span(int col) const {
    int x0 = 0, x1 = 0, x2 = 0, x3 = 0;
    if (m.n && col < sk) {
      const int* x = sri + static_cast<size_t>(col) * m.n;
      x0 = x[0];
      if (m.n > 1) x1 = x[1];
      if (m.n > 2) {
        x2 = x[2];
        x3 = x[3];
      }
    }
    return span_of(col, x0, x1, x2, x3);
  }

  // `_block_keep` for the tiles at rows q0_ and k tile kt_: the causal
  // and window tests, then all_masked on the max of each start (a[2 i],
  // i even) and the min of each end (a[2 i + 1], i odd)
  __device__ __forceinline__ bool pair_needed(int q0_, int kt_) const {
    const int k0 = kt_ * kTile;
    const int r1_ = min(q0_ + kTile, sq) - 1;
    if (!tile_may_keep(q0_, r1_, k0, min(k0 + kTile, sk) - 1, m))
      return false;
    if (m.n == 0) return true;
    const int* a = ta + kt_ * 2 * m.n;
    return !all_masked(q0_, r1_, [a](int i) { return a[2 * i + i % 2]; }, m);
  }
  // every pair kept: inside the ragged bounds, under the diagonal, inside
  // the window, and no interval reaching a row of the tile, by the min of
  // each start (a[2 i + 1], i even) and the max of each end (a[2 i], i
  // odd)
  __device__ __forceinline__ bool pair_full(int q0_, int kt_) const {
    const int k0 = kt_ * kTile;
    const int rl = q0_ + kTile - 1;
    const int cl = k0 + kTile - 1;
    if (rl >= sq || cl >= sk) return false;
    if (m.causal && q0_ < cl) return false;
    if (m.has_window) {
      if (static_cast<long long>(k0) < static_cast<long long>(rl) - m.wl)
        return false;
      if (!m.causal &&
          static_cast<long long>(cl) > static_cast<long long>(q0_) + m.wr)
        return false;
    }
    if (m.n == 0) return true;
    const int* a = ta + kt_ * 2 * m.n;
    if (m.n == 1) return rl < a[1];
    if (m.n == 2)
      return m.causal ? (rl < a[1] || q0_ >= a[2]) : (rl < a[1] && q0_ >= a[2]);
    return (rl < a[1] || q0_ >= a[2]) && (rl < a[5] || q0_ >= a[6]);
  }
  // keep_pair as the rows column col keeps, given its sri ints x0..x3:
  // the causal triangle and the window bound the span, sri cuts it (n=1,
  // ~causal n=2) or holes it (causal n=2, n=4); every choice is a select
  // on flags set per call
  __device__ __forceinline__ attn_fwd_sm90::Span span_of(int col, int x0,
                                                         int x1, int x2,
                                                         int x3) const {
    attn_fwd_sm90::Span sp;
    sp.lo = lo_on ? col - lo_sub : INT_MIN;
    sp.hi = col < sk ? min(sq, hi_on ? col + m.wl + 1 : INT_MAX) : INT_MIN;
    sp.hi = min(sp.hi, hi_x0 ? x0 : INT_MAX);
    sp.lo = max(sp.lo, lo_x1 ? x1 : INT_MIN);
    sp.a1 = hole1 ? x0 : INT_MAX;
    sp.b1 = hole1 ? x1 : INT_MIN;
    sp.a2 = hole2 ? x2 : INT_MAX;
    sp.b2 = hole2 ? x3 : INT_MIN;
    return sp;
  }
};

FmPolicy fm_policy(const Mask& m, const void* agg) {
  FmPolicy pol{};
  pol.m = m;
  pol.agg = static_cast<const int*>(agg);
  pol.set_span();
  return pol;
}

}  // namespace

// Check the arguments and build the Mask and stream every entry point
// uses.
#define FM_PROLOGUE                                                        \
  if (!args_ok(sri, b, h, sq, sk, d, sri_heads, n, causal, dtype))         \
    return static_cast<int>(cudaErrorInvalidValue);                        \
  const Mask m{static_cast<const int*>(sri), h, sri_heads, n, causal,      \
               has_window, wl, wr, dropout, seed, thresh, inv};            \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                      \
  int* count = static_cast<int*>(tile_count)

// The fp32 (CUDA-core) instantiation of F for the padded head dim.
#define FM_F32(F, ...)                                                     \
  const int dp = padded_dim(d);                                            \
  if (dp == 32) return F<32>(__VA_ARGS__, m, count, s);                    \
  if (dp == 64) return F<64>(__VA_ARGS__, m, count, s);                    \
  if (dp == 128) return F<128>(__VA_ARGS__, m, count, s);                  \
  if (dp == 192) return F<192>(__VA_ARGS__, m, count, s);                  \
  return F<256>(__VA_ARGS__, m, count, s)

// The arguments every entry point shares after its pointers.
#define FM_ARGS                                                            \
  int b, int h, int sq, int sk, int d, float scale, int sri_heads, int n,  \
      int causal, int has_window, int wl, int wr, int dropout,             \
      unsigned seed, unsigned thresh, float inv, int dtype, void *stream

extern "C" {

const char* fm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of dynamic shared memory each CUDA-core kernel needs at head_dim
// d: 0 the fp32 forward, 1 dQ, 2 dK/dV.
size_t fm_smem_bytes(int kernel, int d) {
  const int dp = padded_dim(d);
  const size_t w = kernel == 0 ? fwd_words(dp)
                   : kernel == 1 ? dq_words(dp)
                                 : dkv_words(dp);
  return w * 4;
}

// The tile aggregates of a (b, sri_heads, sk, n) int32 sri (n > 0) into
// tile_agg, b * sri_heads * ceil(sk / 64) * 2n int32: what the bf16
// backward kernels read, computed once for both.
int fm_tile_agg(const void* sri, void* tile_agg, int b, int sri_heads,
                int sk, int n, void* stream) {
  if (sri == nullptr || tile_agg == nullptr || b < 1 || sri_heads < 1 ||
      sk < 1 || !(n == 1 || n == 2 || n == 4))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_tile_agg(sri, tile_agg, b * sri_heads, sk,
                                          n,
                                          static_cast<cudaStream_t>(stream)));
}

// Operands are contiguous (b*h, sq|sk, d) slices in `dtype` (0 fp32, 1
// bf16); lse and delta are (b*h, sq) fp32; sri is (b, sri_heads, sk, n)
// int32 (null when n == 0). A window applies when has_window; dropout
// keeps a pair when its hash under `seed` is >= thresh and scales it by
// inv. tile_agg is the bf16 kernels' tile aggregates (fm_tile_agg's
// layout; null for fp32 or n == 0), and tile_count null or one int32 to
// which the number of computed (q tile, k tile, batch*head) triples is
// added. bf16 needs d % 8 == 0 and 16-byte aligned bf16 operands and
// outputs. Each call launches one kernel on `stream` (fm_fwd with n > 0
// and bf16 two: it computes tile_agg first; the backward entries read
// it), allocates nothing, and returns cudaGetLastError().
int fm_fwd(const void* q, const void* k, const void* v, const void* sri,
           void* tile_agg, void* tile_count, void* o, void* lse, FM_ARGS) {
  FM_PROLOGUE;
  if (dtype == kF32) {
    FM_F32(fwd_f32, q, k, v, o, lse, b * h, sq, sk, d, scale);
  }
  if (n) {
    if (tile_agg == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = launch_tile_agg(sri, tile_agg, b * sri_heads, sk,
                                          n, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(attn_fwd_sm90::run(q, k, v, o, lse, b * h, sq, sk,
                                             d, scale, fm_policy(m, tile_agg),
                                             count, s));
}

int fm_bwd_dq(const void* q, const void* k, const void* v, const void* sri,
              const void* tile_agg, void* tile_count, const void* dout,
              const void* lse, const void* delta, void* dq, FM_ARGS) {
  FM_PROLOGUE;
  if (dtype == kF32) {
    FM_F32(dq_f32, q, k, v, dout, lse, delta, dq, b * h, sq, sk, d, scale);
  }
  if (n && tile_agg == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(attn_bwd_sm90::run_dq(
      q, k, v, dout, lse, delta, dq, b * h, sq, sk, d, scale,
      fm_policy(m, tile_agg), count, s));
}

int fm_bwd_dkv(const void* q, const void* k, const void* v, const void* sri,
               const void* tile_agg, void* tile_count, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               FM_ARGS) {
  FM_PROLOGUE;
  if (dtype == kF32) {
    FM_F32(dkv_f32, q, k, v, dout, lse, delta, dk, dv, b * h, sq, sk, d,
           scale);
  }
  if (n && tile_agg == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(attn_bwd_sm90::run_dkv(
      q, k, v, dout, lse, delta, dk, dv, b * h, sq, sk, d, scale,
      fm_policy(m, tile_agg), count, s));
}

}  // extern "C"
