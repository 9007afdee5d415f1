// Paged attention for Hopper (sm_90a), plain C interface for ctypes: decode
// (`pa_decode`) and verify chunks (`pa_verify`).
//
// pa_decode replaces the TPU kernels `_decode_kernel`
// (paddle_tpu/ops/paged_attention.py:109) and `_quant_kernel` (:159), both
// launched by `_decode_pallas`. What they compute: one query token per
// sequence b, GQA attention of its query heads over the first lengths[b]
// columns of its paged KV cache, reached page by page through
// page_table[b]. int8 pages carry one fp32 scale per (head, token) and are
// dequantized here, so int8 is what crosses device memory. A length-0
// sequence (a free slot) reads no page and gets zeros.
//
// pa_verify replaces the TPU kernels `_verify_kernel` (:284) and
// `_verify_quant_kernel` (:339), launched by `paged_verify_attention`
// (:346): a chunk of G query tokens per sequence (speculative-decoding
// verify, chunked prefill), token g at position base_lengths[b] + g,
// attending the columns < base_lengths[b] + g + 1. q is (B, QH, G, D).
//
// Two designs, chosen by the wrapper before launch (no fallback).
//
// Tensor cores (`paged_tc_kernel`, then `paged_merge_kernel`): bf16 q over
// bf16 or int8 pages, head dim a multiple of 8 up to 128, GQA group up to
// 64. The TPU kernels' grid (B, KVH, pages) with its sequential page axis
// does not carry over; one rule serves both entry points, a decode row
// being a verify token (G = 1) at base = length - 1:
//   * M row m of a row tile is token g0 + m / group and query head
//     h * group + m % group, a tile up to 64 / group tokens (16 at group
//     4), each row masked to its own min(base + g + 1, cap); q and the
//     output are read and written in their (B, QH, G, D) layout in place.
//   * A sequence's columns split over blocks: a block owns (sequence b, KV
//     head h, row tile, split s) and walks the k tiles of 64 columns
//     [s * S / 64, min((s + 1) * S / 64, kt_end)), kt_end = ceil(lim / 64)
//     for the tile's largest limit lim. The split width S is the
//     wrapper's, from shapes alone: no split (one S over the whole cache)
//     when B x KVH x row tiles fill twice the SMs or two splits' fp32
//     partials would pass 16 MiB, else 384 columns (on an H100 it beat
//     128, 256 and 512-1024 at the 8B batches below), widened where the
//     partials of every split would pass 16 MiB.
//     The grid is fixed by shapes, splits slowest; a block whose split
//     starts at or past lim exits at once, so lengths stay on the device:
//     no host sync. At the 8B decode or verify batch (8 slots of 100-2000
//     tokens, KVH 8) that is 216 working blocks of at most 6 k tiles,
//     one wave at 2 blocks an SM, where one block per (sequence, KV head)
//     walked up to 32.
//   * Each block runs the tile loop of csrc/paged_tc_sm90.cuh (the ragged
//     kernel's: page-table row in shared memory, K/V gathered by cp.async
//     into a ring of three stages, mma.sync.m16n8k16 with the softmax in
//     registers and P as bf16 hi + lo, int8 widened in shared memory with
//     its scales folded in fp32, a narrow tile split over the 4 warps by
//     columns). A tile whose lim fits in one split writes its normalised
//     output; otherwise each block writes its unnormalised fp32 O, m and
//     l to a workspace (B, KVH, G x group, splits, D), and
//     `paged_merge_kernel` (a warp a row) combines the row's splits in
//     ascending order, O = sum 2^(m_s - M) O_s / sum 2^(m_s - M) l_s, so
//     bf16 repeats bit for bit. Partials stay fp32: a bf16 workspace
//     would add a rounding per split. A length-0 decode row's split-0
//     block writes its zeros.
// What bounds it: the KV bytes (about 2 flops a byte at group 4). What it
// leaves: the warps issue the gathered copies (and widen int8) between
// products, in turn (TMA or producer warps would overlap them); mma.sync,
// not wgmma; the split width is one constant for every length mix, and
// the grid follows the cache's length, not the live lengths (blocks past
// them exit at once, but a long cache's grid costs time of its own);
// verify_step's (B, G, QH, D) q is copied to (B, QH, G, D) by its
// caller rather than read through its strides.
//
// CUDA cores (`decode_kernel`, `verify_kernel`): fp32 q (over fp32 or int8
// pages) and any other shape, such as head dim 256.
//
// decode_kernel. The TPU kernel runs grid (batch, KV head, page) with the
// page axis sequential, carrying the online-softmax state in VMEM scratch.
// Blocks here run in parallel and in no order, so one block owns a
// (sequence, KV head) and walks its columns in order inside the block: it
// stages the group's query rows once, then streams the KV in chunks of 64
// columns (several pages at page size 16, each column's page looked up in
// the table), so every KV byte is read once for all `group` query heads.
// Loads are 16-byte vectors (4 fp32, 8 bf16 or 16 int8 values),
// dequantized and widened to fp32 into shared memory. Scores, the online
// softmax (one warp per query head, warp shuffles) and the accumulator are
// fp32. Pages at or past the length are never touched; the ragged last
// chunk is cut to the length, so no column is masked. One block per
// (sequence, KV head) is 64 blocks for 8 sequences at 8 KV heads, half
// the SMs; loads are not pipelined behind compute, and the products run
// on CUDA cores.
//
// verify_kernel. A KV head's group x G query rows are contiguous in q and
// are read in place; row r is token r % G. The TPU kernel pads those rows
// to a sublane multiple; nothing here needs that. One block owns a
// (sequence, KV head, tile of 16, 32 or 64 rows) and streams 64-column KV
// chunks as decode_kernel does, up to the tile's largest limit base +
// g_max + 1 (past it every row is masked, as the TPU kernel skips a page
// at or past base + G); inside a chunk each row masks its own columns.
// Every KV byte is read once for all of a head's group x G rows (one tile
// at G <= 16 and group 4), which is the point of the TPU kernel. The tile
// size is a template argument, so each thread's row loops unroll to the
// rows it owns: scores take one column and TILE / 4 rows a thread, each
// row's q read as a broadcast 16-byte vector; the accumulator lives in
// registers, 4 head dims and up to 8 rows a thread. (A first version with
// one 64-row tile for every shape spent most of its time on the unrolled
// iterations of rows a 16-row tile does not have.) Every row sees column
// 0, so each row's running max is finite after the first chunk and `l` is
// never 0 (the final divide still maps l == 0 to 1, as `_fin` does).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <limits.h>
#include <stdint.h>

#include "attn_fwd_sm90.cuh"
#include "paged_tc_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 64;  // KV columns staged per pass

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Values of one 16-byte vector, as floats.
template <typename KT>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* out) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* out) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of the fp32 with the same bits
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void unpack(const uint4& r, float* out) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[4 * i + b] =
            static_cast<float>(static_cast<int8_t>((w[i] >> (8 * b)) & 0xff));
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Shared memory, in floats: q group (group x Dp), K and V chunks
// (kCols x Dp each), scores (group x kCols), accumulator (group x D), and
// m, l, alpha (group each). Dp = D + 1 pads rows so that threads reading
// one column of different rows hit different banks.
size_t smem_floats(int group, int head_dim) {
  const size_t dp = static_cast<size_t>(head_dim) + 1;
  const size_t g = static_cast<size_t>(group);
  return g * dp + 2 * kCols * dp + g * kCols + g * head_dim + 3 * g;
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pages,
                  const KT* __restrict__ v_pages,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ page_table,
                  const int* __restrict__ lengths, QT* __restrict__ out,
                  int group, int D, int num_pages, int page_size,
                  int pages_per_seq, float sm_scale) {
  constexpr int VN = Vec<KT>::N;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int qh = gridDim.y * group;
  const int Dp = D + 1;
  const int tid = threadIdx.x;
  const size_t q_off =
      (static_cast<size_t>(b) * qh + static_cast<size_t>(h) * group) * D;
  const int len = min(lengths[b], pages_per_seq * page_size);
  if (len <= 0) {  // a free slot: no page is read
    for (int i = tid; i < group * D; i += kThreads)
      out[q_off + i] = from_float<QT>(0.f);
    return;
  }

  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + group * Dp;
  float* sv = sk + kCols * Dp;
  float* ss = sv + kCols * Dp;
  float* acc = ss + group * kCols;
  float* sm = acc + group * D;
  float* sl = sm + group;
  float* sa = sl + group;

  for (int i = tid; i < group * D; i += kThreads) {
    sq[(i / D) * Dp + i % D] = to_float(q[q_off + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    sm[g] = -INFINITY;
    sl[g] = 0.f;
  }
  const int* ptab = page_table + static_cast<size_t>(b) * pages_per_seq;
  const int vecs = D / VN;  // 16-byte vectors per KV row
  const int warp = tid / 32;
  const int lane = tid % 32;
  __syncthreads();

  for (int c0 = 0; c0 < len; c0 += kCols) {
    const int n = min(kCols, len - c0);
    for (int i = tid; i < n * vecs; i += kThreads) {
      const int j = i / vecs;
      const int dv = i % vecs;
      const int col = c0 + j;
      // row of the column's token in the (KVH, P, page) layout
      const size_t row =
          (static_cast<size_t>(h) * num_pages + ptab[col / page_size]) *
              page_size +
          col % page_size;
      const uint4 kr =
          *reinterpret_cast<const uint4*>(k_pages + row * D + dv * VN);
      const uint4 vr =
          *reinterpret_cast<const uint4*>(v_pages + row * D + dv * VN);
      float kf[VN], vf[VN];
      Vec<KT>::unpack(kr, kf);
      Vec<KT>::unpack(vr, vf);
      if (k_scale != nullptr) {
        const float ks = k_scale[row];
        const float vs = v_scale[row];
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          kf[e] *= ks;
          vf[e] *= vs;
        }
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        sk[j * Dp + dv * VN + e] = kf[e];
        sv[j * Dp + dv * VN + e] = vf[e];
      }
    }
    __syncthreads();

    for (int i = tid; i < group * kCols; i += kThreads) {
      const int g = i / kCols;
      const int j = i % kCols;
      float s = -INFINITY;
      if (j < n) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += sq[g * Dp + d] * sk[j * Dp + d];
        s = dot * sm_scale;
      }
      ss[i] = s;
    }
    __syncthreads();

    // one warp per query head; column c0 < len is present, so mx is finite
    for (int g = warp; g < group; g += kWarps) {
      const float m_old = sm[g];
      float mx = m_old;
      for (int j = lane; j < kCols; j += 32) mx = fmaxf(mx, ss[g * kCols + j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < kCols; j += 32) {
        const float p = expf(ss[g * kCols + j] - mx);
        ss[g * kCols + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - mx);
        sl[g] = sl[g] * alpha + sum;
        sm[g] = mx;
        sa[g] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < group * D; i += kThreads) {
      const int g = i / D;
      const int d = i % D;
      float a = acc[i] * sa[g];
      for (int j = 0; j < n; ++j) a += ss[g * kCols + j] * sv[j * Dp + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < group * D; i += kThreads) {
    const float l = sl[i / D];
    out[q_off + i] = from_float<QT>(acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* k_pages,
                         const void* v_pages, const void* k_scale,
                         const void* v_scale, const void* page_table,
                         const void* lengths, void* out, int B, int qh,
                         int kvh, int head_dim, int num_pages, int page_size,
                         float sm_scale, int pages_per_seq,
                         cudaStream_t stream) {
  const int group = qh / kvh;
  const size_t smem = smem_floats(group, head_dim) * sizeof(float);
  auto kernel = decode_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, kvh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<QT*>(out), group,
      head_dim, num_pages, page_size, pages_per_seq, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- verify
// A verify block's query-row tile is a compile-time TILE (16, 32 or 64),
// so every per-thread row loop below unrolls to the rows a thread really
// owns: scores take TILE / 4 rows a thread (one column each), the
// accumulator PVR rows of 4 head dims a thread. A tile is 16 rows when
// the head's group x G rows fit in 16 (G = 4 at group 4: the spec
// decode case), else 64, or 32 above head_dim 128 (shared memory).
int verify_tile_rows(int group, int n_tok, int head_dim) {
  if (group * n_tok <= 16) return 16;
  return head_dim <= 128 ? 64 : 32;
}

// Shared memory of a verify block, in floats: q tile (rows x Dq), K and V
// chunks (kCols x Dq each), scores (rows x kCols), m, l, alpha (rows
// each). Dq = D + 4 keeps rows 16-byte aligned for vector reads and puts
// the 8 lanes of one 128-byte wavefront on different banks.
size_t verify_smem_floats(int rows, int head_dim) {
  const size_t dq = static_cast<size_t>(head_dim) + 4;
  const size_t r = static_cast<size_t>(rows);
  return r * dq + 2 * kCols * dq + r * kCols + 3 * r;
}

__device__ __forceinline__ void fma4(float4& a, float p, const float4& v) {
  a.x += p * v.x;
  a.y += p * v.y;
  a.z += p * v.z;
  a.w += p * v.w;
}

// PVR bounds the accumulator rows a thread owns: its head-dim lane (4
// dims) is one of D / 4, so the rows split over 1024 / D groups of
// threads: at most TILE / 8 rows for D <= 128, TILE / 4 above.
template <typename QT, typename KT, int TILE, int PVR>
__global__ void __launch_bounds__(kThreads)
    verify_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pages,
                  const KT* __restrict__ v_pages,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ page_table,
                  const int* __restrict__ base_lengths, QT* __restrict__ out,
                  int group, int n_tok, int D, int num_pages, int page_size,
                  int pages_per_seq, float sm_scale) {
  constexpr int VN = Vec<KT>::N;
  constexpr int QKR = TILE / 4;  // score rows a thread
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int qh = gridDim.y * group;
  const int r0 = blockIdx.z * TILE;
  const int nrows = min(TILE, group * n_tok - r0);
  const int Dq = D + 4;
  const int tid = threadIdx.x;
  // (B, QH, G, D): the head's group x G rows are contiguous
  const size_t q_off =
      ((static_cast<size_t>(b) * qh + static_cast<size_t>(h) * group) *
           n_tok +
       r0) *
      D;
  const int base = base_lengths[b];
  const int cap = pages_per_seq * page_size;
  // the tile's largest token index: rows r0 .. r0 + nrows - 1 are tokens
  // (r0 + i) % n_tok
  const int g_first = r0 % n_tok;
  const int g_max =
      (nrows >= n_tok || g_first + nrows > n_tok) ? n_tok - 1
                                                  : g_first + nrows - 1;
  const int tile_lim = min(base + g_max + 1, cap);

  extern __shared__ __align__(16) float vsmem[];
  float* sq = vsmem;
  float* sk = sq + TILE * Dq;
  float* sv = sk + kCols * Dq;
  float* ss = sv + kCols * Dq;
  float* sm = ss + TILE * kCols;
  float* sl = sm + TILE;
  float* sa = sl + TILE;

  for (int i = tid; i < nrows * D; i += kThreads)
    sq[(i / D) * Dq + i % D] = to_float(q[q_off + i]);
  for (int g = tid; g < nrows; g += kThreads) {
    sm[g] = -INFINITY;
    sl[g] = 0.f;
  }
  const int* ptab = page_table + static_cast<size_t>(b) * pages_per_seq;
  const int vecs = D / VN;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // scores: column qj, rows qrg + 4 i
  const int qj = tid % kCols;
  const int qrg = tid / kCols;
  // accumulator: head dims 4 pd .. 4 pd + 3, rows prg + pv_groups i
  const int d4n = D / 4;
  const int pv_groups = kThreads / d4n;
  const int pd = tid % d4n;
  const int prg = tid / d4n;
  const bool pv_on = prg < pv_groups;
  float4 acc[PVR];
#pragma unroll
  for (int i = 0; i < PVR; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  for (int c0 = 0; c0 < tile_lim; c0 += kCols) {
    const int n = min(kCols, tile_lim - c0);
    for (int i = tid; i < n * vecs; i += kThreads) {
      const int j = i / vecs;
      const int dv = i % vecs;
      const int col = c0 + j;
      const size_t row =
          (static_cast<size_t>(h) * num_pages + ptab[col / page_size]) *
              page_size +
          col % page_size;
      const uint4 kr =
          *reinterpret_cast<const uint4*>(k_pages + row * D + dv * VN);
      const uint4 vr =
          *reinterpret_cast<const uint4*>(v_pages + row * D + dv * VN);
      float kf[VN], vf[VN];
      Vec<KT>::unpack(kr, kf);
      Vec<KT>::unpack(vr, vf);
      if (k_scale != nullptr) {
        const float ks = k_scale[row];
        const float vs = v_scale[row];
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          kf[e] *= ks;
          vf[e] *= vs;
        }
      }
#pragma unroll
      for (int e = 0; e < VN; e += 4) {
        *reinterpret_cast<float4*>(sk + j * Dq + dv * VN + e) =
            make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
        *reinterpret_cast<float4*>(sv + j * Dq + dv * VN + e) =
            make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      }
    }
    // the ragged last chunk: zero V's unused rows, which the 4-column
    // steps of the accumulator read with p = 0
    for (int i = tid; i < (kCols - n) * D; i += kThreads)
      sv[(n + i / D) * Dq + i % D] = 0.f;
    __syncthreads();

    {
      float s[QKR];
#pragma unroll
      for (int i = 0; i < QKR; ++i) s[i] = 0.f;
      if (qj < n) {
        for (int d = 0; d < D; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(sk + qj * Dq + d);
#pragma unroll
          for (int i = 0; i < QKR; ++i) {
            const float4 qv =
                *reinterpret_cast<const float4*>(sq + (qrg + 4 * i) * Dq + d);
            s[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < QKR; ++i) {
        const int g = qrg + 4 * i;
        if (g < nrows) {
          const int lim = min(base + (r0 + g) % n_tok + 1, cap);
          ss[g * kCols + qj] =
              (qj < n && c0 + qj < lim) ? s[i] * sm_scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // one warp per row; column 0 is in every row's range, so after the
    // first chunk every running max is finite
    for (int g = warp; g < nrows; g += kWarps) {
      const float m_old = sm[g];
      float mx = m_old;
      for (int j = lane; j < kCols; j += 32) mx = fmaxf(mx, ss[g * kCols + j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < kCols; j += 32) {
        const float p = expf(ss[g * kCols + j] - mx);
        ss[g * kCols + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - mx);
        sl[g] = sl[g] * alpha + sum;
        sm[g] = mx;
        sa[g] = alpha;
      }
    }
    __syncthreads();

    if (pv_on) {
#pragma unroll
      for (int i = 0; i < PVR; ++i) {
        const int g = prg + pv_groups * i;
        if (g < nrows) {
          const float a = sa[g];
          acc[i].x *= a;
          acc[i].y *= a;
          acc[i].z *= a;
          acc[i].w *= a;
        }
      }
      for (int j = 0; j < n; j += 4) {
        const float* vj = sv + j * Dq + 4 * pd;
        const float4 v0 = *reinterpret_cast<const float4*>(vj);
        const float4 v1 = *reinterpret_cast<const float4*>(vj + Dq);
        const float4 v2 = *reinterpret_cast<const float4*>(vj + 2 * Dq);
        const float4 v3 = *reinterpret_cast<const float4*>(vj + 3 * Dq);
#pragma unroll
        for (int i = 0; i < PVR; ++i) {
          const int g = prg + pv_groups * i;
          if (g < nrows) {
            const float4 p =
                *reinterpret_cast<const float4*>(ss + g * kCols + j);
            fma4(acc[i], p.x, v0);
            fma4(acc[i], p.y, v1);
            fma4(acc[i], p.z, v2);
            fma4(acc[i], p.w, v3);
          }
        }
      }
    }
    __syncthreads();
  }

  if (pv_on) {
#pragma unroll
    for (int i = 0; i < PVR; ++i) {
      const int g = prg + pv_groups * i;
      if (g < nrows) {
        const float l = sl[g];
        const float inv = 1.f / (l == 0.f ? 1.f : l);
        QT* o = out + q_off + static_cast<size_t>(g) * D + 4 * pd;
        o[0] = from_float<QT>(acc[i].x * inv);
        o[1] = from_float<QT>(acc[i].y * inv);
        o[2] = from_float<QT>(acc[i].z * inv);
        o[3] = from_float<QT>(acc[i].w * inv);
      }
    }
  }
}

template <typename QT, typename KT, int TILE, int PVR>
cudaError_t launch_verify_tile(const void* q, const void* k_pages,
                               const void* v_pages, const void* k_scale,
                               const void* v_scale, const void* page_table,
                               const void* base_lengths, void* out, int B,
                               int qh, int kvh, int n_tok, int head_dim,
                               int num_pages, int page_size, float sm_scale,
                               int pages_per_seq, cudaStream_t stream) {
  const int group = qh / kvh;
  const int rows = group * n_tok;
  const size_t smem = verify_smem_floats(TILE, head_dim) * sizeof(float);
  auto kernel = verify_kernel<QT, KT, TILE, PVR>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, kvh, (rows + TILE - 1) / TILE);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(page_table),
      static_cast<const int*>(base_lengths), static_cast<QT*>(out), group,
      n_tok, head_dim, num_pages, page_size, pages_per_seq, sm_scale);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_verify_typed(const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scale,
                                const void* v_scale, const void* page_table,
                                const void* base_lengths, void* out, int B,
                                int qh, int kvh, int n_tok, int head_dim,
                                int num_pages, int page_size, float sm_scale,
                                int pages_per_seq, cudaStream_t stream) {
#define PV_TILE_ARGS                                                         \
  q, k_pages, v_pages, k_scale, v_scale, page_table, base_lengths, out, B,   \
      qh, kvh, n_tok, head_dim, num_pages, page_size, sm_scale,              \
      pages_per_seq, stream
  switch (verify_tile_rows(qh / kvh, n_tok, head_dim)) {
    case 16:
      return launch_verify_tile<QT, KT, 16, 4>(PV_TILE_ARGS);
    case 32:
      return launch_verify_tile<QT, KT, 32, 8>(PV_TILE_ARGS);
    default:
      return launch_verify_tile<QT, KT, 64, 8>(PV_TILE_ARGS);
  }
#undef PV_TILE_ARGS
}


// ------------------------------------------------- the tensor-core design
namespace tc = attn_fwd_sm90;
namespace ptc = paged_tc_sm90;
using tc::kTileK;
using tc::kTileQ;

struct PagedArgs {
  const __nv_bfloat16* q;  // (B, qh, G, D)
  const void* k;           // (kvh, num_pages, page, D), bf16 or int8
  const void* v;
  const float* k_scale;    // (kvh, num_pages, page, 1), int8 only
  const float* v_scale;
  const int* page_table;   // (B, pps)
  const int* lengths;      // (B,): base lengths (verify) or lengths (decode)
  __nv_bfloat16* out;      // (B, qh, G, D)
  float* ws_o;             // (B, kvh, G * group, n_splits, D), or null
  float2* ws_ml;           // (B, kvh, G * group, n_splits): (m, l), or null
  int* count;              // [k tiles, working blocks] summed, or null
  int B, qh, kvh, G, D, num_pages, page, pps;
  int base_off;   // 0 (verify), -1 (decode: token 0 sits at length - 1)
  int split_kt;   // k tiles of one split
  int n_splits;   // splits of a (sequence, KV head, row tile) in the grid
  int row_tiles;  // ceil(G / (64 / group))
  float scale;
};

// A row tile's largest column limit: its last token g0 + n - 1 sees the
// columns < base + g0 + n, at most the sequence's pages.
__device__ __forceinline__ int tile_lim(const PagedArgs& a, int b, int g0,
                                        int n) {
  return min(a.lengths[b] + a.base_off + g0 + n, a.pps * a.page);
}

// The work of one block of paged_tc_kernel for paged_tc_sm90::tile_loop:
// KV head h of sequence b, tokens g0 .. g0 + m_rows / group - 1, the k
// tiles [kt0, kt1) of split `split` (-1: the tile's only split). M row m
// is token g0 + m / group, query head h * group + m % group, its limit
// min(base + g0 + m / group + 1, cap).
struct PagedWork {
  const PagedArgs& a;
  int h, group, m_rows, lim, kt0, kt1, b, g0, base, split;
  const int* prow;

  __device__ __forceinline__ long long row_off(int m) const {
    return (static_cast<long long>(b * a.qh + h * group + m % group) * a.G +
            g0 + m / group) * a.D;
  }
  __device__ __forceinline__ const __nv_bfloat16* q_row(int m) const {
    return a.q + row_off(m);
  }
  __device__ __forceinline__ int row_lim(int m) const {
    return min(base + g0 + m / group + 1, a.pps * a.page);
  }
  // The tile's only split writes O / l as bf16 pairs in q's layout; a
  // split of several writes O (fp32 pairs), m and l to the workspace for
  // paged_merge_kernel.
  template <int NB>
  __device__ __forceinline__ void finish(float (&acc)[NB][4],
                                         const float (&m)[2],
                                         const float (&l)[2], int row_a,
                                         int col_in) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int mrow = row_a + 8 * r;
      if (mrow >= m_rows) continue;
      if (split < 0) {
        const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
        __nv_bfloat16* orow = a.out + row_off(mrow);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int d = 8 * j + col_in;
          if (d < a.D)
            *reinterpret_cast<unsigned*>(orow + d) =
                tc::pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
        }
      } else {
        // row (token g0 + mrow / group) * group + mrow % group of the
        // KV head's G x group rows
        const long long row =
            (static_cast<long long>(b) * a.kvh + h) * a.G * group +
            (g0 + mrow / group) * group + mrow % group;
        const long long at = row * a.n_splits + split;
        float* orow = a.ws_o + at * a.D;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int d = 8 * j + col_in;
          if (d < a.D)
            *reinterpret_cast<float2*>(orow + d) =
                make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
        }
        if (col_in == 0) a.ws_ml[at] = make_float2(m[r], l[r]);
      }
    }
    if (a.count != nullptr && threadIdx.x == 0) {
      atomicAdd(a.count, kt1 - kt0);
      atomicAdd(a.count + 1, 1);
    }
  }
};

// One block of 4 warps per (split s, sequence b, KV head h, row tile),
// splits slowest and row tiles fastest (a sequence's row tiles share its
// pages through L2). A block whose split starts at or past its tile's lim
// exits; a length-0 decode row's split-0 block writes its zeros.
template <int DP, class KV>
__global__ void __launch_bounds__(tc::kThreads, 2)
    paged_tc_kernel(const PagedArgs a) {
  extern __shared__ __align__(128) unsigned char ptc_smem[];
  const int group = a.qh / a.kvh;
  const int per_tile = kTileQ / group;  // tokens of a row tile
  const int per_split = a.B * a.kvh * a.row_tiles;
  const int s = blockIdx.x / per_split;
  const int i = blockIdx.x % per_split;
  const int rt = i % a.row_tiles;
  const int h = i / a.row_tiles % a.kvh;
  const int b = i / (a.row_tiles * a.kvh);
  const int g0 = rt * per_tile;
  const int n_tok = min(per_tile, a.G - g0);
  const int lim = tile_lim(a, b, g0, n_tok);
  if (lim <= 0) {  // a length-0 decode row: no page is read
    if (s == 0) {
      const int chunks = a.D / 8;
      for (int x = threadIdx.x; x < n_tok * group * chunks;
           x += tc::kThreads) {
        const int m = x / chunks;
        uint4* o = reinterpret_cast<uint4*>(
            a.out +
            (static_cast<long long>(b * a.qh + h * group + m % group) * a.G +
             g0 + m / group) * a.D);
        o[x % chunks] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }
  const int kt_end = (lim + kTileK - 1) / kTileK;
  const int kt0 = s * a.split_kt;
  if (kt0 >= kt_end) return;
  const PagedWork w{a,
                    h,
                    group,
                    n_tok * group,
                    lim,
                    kt0,
                    min(kt0 + a.split_kt, kt_end),
                    b,
                    g0,
                    a.lengths[b] + a.base_off,
                    kt_end > a.split_kt ? s : -1,
                    a.page_table + static_cast<long long>(b) * a.pps};
  ptc::tile_loop<DP, KV>(w, ptc_smem);
}

// The merge of split partials: one warp per output row (b, query head,
// token g), 4 head dims a lane. A row whose tile took one split (its
// block wrote the output) is skipped; the others combine splits 0 .. n - 1
// in order, O = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s with M the
// largest m_s (a split that kept none of the row's columns has m_s = -inf
// and weighs 0), and write q's dtype.
constexpr int kMergeThreads = 128;

__global__ void __launch_bounds__(kMergeThreads)
    paged_merge_kernel(const PagedArgs a) {
  const int group = a.qh / a.kvh;
  const int per_tile = kTileQ / group;
  const long long row = (static_cast<long long>(blockIdx.x) * kMergeThreads +
                         threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(a.B) * a.qh * a.G) return;
  const int g = static_cast<int>(row % a.G);
  const int qhead = static_cast<int>(row / a.G % a.qh);
  const int b = static_cast<int>(row / (static_cast<long long>(a.G) * a.qh));
  const int g0 = g / per_tile * per_tile;
  const int lim = tile_lim(a, b, g0, min(per_tile, a.G - g0));
  const int kt_end = (lim + kTileK - 1) / kTileK;
  const int n = (kt_end + a.split_kt - 1) / a.split_kt;
  if (n <= 1) return;
  const int h = qhead / group;
  const long long at =
      ((static_cast<long long>(b) * a.kvh + h) * a.G * group + g * group +
       qhead % group) * a.n_splits;
  float mmax = -INFINITY;
  for (int s = 0; s < n; ++s) mmax = fmaxf(mmax, a.ws_ml[at + s].x);
  const int d = 4 * lane;
  if (d >= a.D) return;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  for (int s = 0; s < n; ++s) {
    const float2 ml = a.ws_ml[at + s];
    const float f = exp2f(ml.x - mmax);
    const float4 os =
        *reinterpret_cast<const float4*>(a.ws_o + (at + s) * a.D + d);
    o.x += f * os.x;
    o.y += f * os.y;
    o.z += f * os.z;
    o.w += f * os.w;
    den += f * ml.y;
  }
  const float inv = den == 0.f ? 0.f : 1.f / den;
  *reinterpret_cast<uint2*>(a.out + row * a.D + d) =
      make_uint2(tc::pack_bf16(o.x * inv, o.y * inv),
                 tc::pack_bf16(o.z * inv, o.w * inv));
}

template <int DP, class KV>
cudaError_t tc_launch_typed(const PagedArgs& a, cudaStream_t stream) {
  auto kernel = paged_tc_kernel<DP, KV>;
  const size_t smem = ptc::smem_bytes(DP, sizeof(KV) == 1, a.pps);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<a.B * a.kvh * a.row_tiles * a.n_splits, tc::kThreads, smem,
           stream>>>(a);
  return cudaGetLastError();
}

// The arguments of the tensor-core kernels, or false for what they do not
// take.
bool tc_args(PagedArgs& a, const void* q, const void* k_pages,
             const void* v_pages, const void* k_scale, const void* v_scale,
             const void* page_table, const void* lengths, void* out,
             void* ws_o, void* ws_ml, void* count, int B, int qh, int kvh,
             int n_tok, int head_dim, int num_pages, int page_size,
             int pages_per_seq, int base_off, int split_cols, int n_splits,
             float sm_scale, int kv_dtype) {
  const bool quant = kv_dtype == kI8;
  const uintptr_t kv_align = quant ? 7 : 15;
  if (B < 1 || n_tok < 1 || head_dim % 8 != 0 || head_dim < 8 ||
      head_dim > 128 || kvh < 1 || qh % kvh != 0 || qh / kvh > kTileQ ||
      page_size < 1 || pages_per_seq < 1 ||
      static_cast<long long>(pages_per_seq) * page_size >= (1 << 26) ||
      (base_off != 0 && base_off != -1) || split_cols < kTileK ||
      split_cols % kTileK != 0 || n_splits < 1 ||
      static_cast<long long>(n_splits) * split_cols <
          static_cast<long long>(pages_per_seq) * page_size ||
      (n_splits > 1 && (ws_o == nullptr || ws_ml == nullptr)) ||
      (!quant && kv_dtype != kBF16) ||
      (reinterpret_cast<uintptr_t>(q) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15) ||
      (reinterpret_cast<uintptr_t>(ws_o) & 15) ||
      (reinterpret_cast<uintptr_t>(k_pages) & kv_align) ||
      (reinterpret_cast<uintptr_t>(v_pages) & kv_align) ||
      (quant && (k_scale == nullptr || v_scale == nullptr)))
    return false;
  const int per_tile = kTileQ / (qh / kvh);
  const int row_tiles = (n_tok + per_tile - 1) / per_tile;
  if (static_cast<long long>(B) * kvh * row_tiles * n_splits > INT_MAX ||
      static_cast<long long>(B) * qh * n_tok * 32 > INT_MAX)
    return false;
  a = PagedArgs{static_cast<const __nv_bfloat16*>(q),
                k_pages,
                v_pages,
                static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale),
                static_cast<const int*>(page_table),
                static_cast<const int*>(lengths),
                static_cast<__nv_bfloat16*>(out),
                static_cast<float*>(ws_o),
                static_cast<float2*>(ws_ml),
                static_cast<int*>(count),
                B,
                qh,
                kvh,
                n_tok,
                head_dim,
                num_pages,
                page_size,
                pages_per_seq,
                base_off,
                split_cols / kTileK,
                n_splits,
                row_tiles,
                sm_scale};
  return true;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t pa_smem_bytes(int group, int head_dim) {
  return smem_floats(group, head_dim) * sizeof(float);
}

const char* pa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (B, qh, D) in q_dtype; k_pages/v_pages: (kvh, num_pages, page_size, D)
// in kv_dtype, 16-byte aligned; k_scale/v_scale: (kvh, num_pages, page_size,
// 1) fp32 for int8 pages, else null; page_table: (B, pages_per_seq) int32;
// lengths: (B,) int32; out: (B, qh, D) in q_dtype. All contiguous; D a
// multiple of 16. Launches on `stream`, allocates nothing, and returns
// cudaGetLastError().
int pa_decode(const void* q, const void* k_pages, const void* v_pages,
              const void* k_scale, const void* v_scale,
              const void* page_table, const void* lengths, void* out, int B,
              int qh, int kvh, int head_dim, int num_pages, int page_size,
              float sm_scale, int pages_per_seq, int q_dtype, int kv_dtype,
              void* stream) {
  if (B < 1 || kvh < 1 || kvh > 65535 || qh % kvh != 0 || head_dim < 16 ||
      head_dim > 256 || head_dim % 16 != 0 || page_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_ARGS                                                             \
  q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, out, B, qh,   \
      kvh, head_dim, num_pages, page_size, sm_scale, pages_per_seq, s
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_typed<float, float>(PA_ARGS);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(PA_ARGS);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return launch_typed<float, int8_t>(PA_ARGS);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch_typed<__nv_bfloat16, int8_t>(PA_ARGS);
#undef PA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory one verify block needs.
size_t pa_verify_smem_bytes(int group, int n_tok, int head_dim) {
  return verify_smem_floats(verify_tile_rows(group, n_tok, head_dim),
                            head_dim) *
         sizeof(float);
}

// q: (B, qh, n_tok, D) in q_dtype; pages, scales and page_table as in
// pa_decode; base_lengths: (B,) int32 >= 0, the cache length before the
// chunk; out: (B, qh, n_tok, D) in q_dtype. Row (head x, token g) attends
// the columns < min(base_lengths[b] + g + 1, pages_per_seq * page_size).
// All contiguous; D a multiple of 16 up to 256. Launches on `stream`,
// allocates nothing, and returns cudaGetLastError().
int pa_verify(const void* q, const void* k_pages, const void* v_pages,
              const void* k_scale, const void* v_scale,
              const void* page_table, const void* base_lengths, void* out,
              int B, int qh, int kvh, int n_tok, int head_dim, int num_pages,
              int page_size, float sm_scale, int pages_per_seq, int q_dtype,
              int kv_dtype, void* stream) {
  if (B < 1 || kvh < 1 || kvh > 65535 || qh % kvh != 0 || n_tok < 1 ||
      head_dim < 16 || head_dim > 256 || head_dim % 16 != 0 ||
      page_size < 1 || pages_per_seq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (qh / kvh) * n_tok;
  const int tile_rows = verify_tile_rows(qh / kvh, n_tok, head_dim);
  if ((rows + tile_rows - 1) / tile_rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PV_ARGS                                                              \
  q, k_pages, v_pages, k_scale, v_scale, page_table, base_lengths, out, B,   \
      qh, kvh, n_tok, head_dim, num_pages, page_size, sm_scale,              \
      pages_per_seq, s
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_verify_typed<float, float>(PV_ARGS);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_verify_typed<__nv_bfloat16, __nv_bfloat16>(PV_ARGS);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return launch_verify_typed<float, int8_t>(PV_ARGS);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch_verify_typed<__nv_bfloat16, int8_t>(PV_ARGS);
#undef PV_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}


// Bytes of dynamic shared memory one block of the tensor-core kernel
// needs.
size_t pa_tc_smem_bytes(int head_dim, int kv_dtype, int pages_per_seq) {
  return ptc::smem_bytes(ptc::padded_dim(head_dim), kv_dtype == kI8,
                         pages_per_seq);
}

// The tensor-core kernel, for decode (n_tok 1, base_off -1: `lengths` are
// lengths) and verify (base_off 0: base lengths). q and out (B, qh, n_tok,
// D) bf16, 16-byte aligned; pages, scales and page_table as in pa_decode,
// pages in kv_dtype bf16 (16-byte aligned) or int8 (8-byte aligned, with
// scales). Splits of split_cols columns (a multiple of 64), n_splits of
// them covering pages_per_seq x page_size; with n_splits > 1, ws_o (B,
// kvh, n_tok x qh / kvh, n_splits, D) and ws_ml (the same, 2 floats) fp32
// for pa_merge, which must follow on the same stream. count null or two
// ints the blocks add their k tiles and their number to. D % 8 == 0, D <=
// 128, qh / kvh <= 64. Allocates nothing; returns cudaGetLastError().
int pa_tc_launch(const void* q, const void* k_pages, const void* v_pages,
                 const void* k_scale, const void* v_scale,
                 const void* page_table, const void* lengths, void* out,
                 void* ws_o, void* ws_ml, void* count, int B, int qh, int kvh,
                 int n_tok, int head_dim, int num_pages, int page_size,
                 int pages_per_seq, int base_off, int split_cols,
                 int n_splits, float sm_scale, int kv_dtype, void* stream) {
  PagedArgs a;
  if (!tc_args(a, q, k_pages, v_pages, k_scale, v_scale, page_table, lengths,
               out, ws_o, ws_ml, count, B, qh, kvh, n_tok, head_dim,
               num_pages, page_size, pages_per_seq, base_off, split_cols,
               n_splits, sm_scale, kv_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = ptc::padded_dim(head_dim);
  if (kv_dtype == kI8)
    return dp == 32   ? tc_launch_typed<32, int8_t>(a, s)
           : dp == 64 ? tc_launch_typed<64, int8_t>(a, s)
                      : tc_launch_typed<128, int8_t>(a, s);
  return dp == 32   ? tc_launch_typed<32, __nv_bfloat16>(a, s)
         : dp == 64 ? tc_launch_typed<64, __nv_bfloat16>(a, s)
                    : tc_launch_typed<128, __nv_bfloat16>(a, s);
}

// The merge of pa_tc_launch's split partials into out, with the same
// arguments (n_splits > 1). Returns cudaGetLastError().
int pa_merge(const void* lengths, const void* ws_o, const void* ws_ml,
             void* out, int B, int qh, int kvh, int n_tok, int head_dim,
             int page_size, int pages_per_seq, int base_off, int split_cols,
             int n_splits, void* stream) {
  PagedArgs a;
  // the pool is not read: any aligned non-null pointer stands for it
  if (n_splits < 2 ||
      !tc_args(a, out, out, out, nullptr, nullptr, nullptr, lengths, out,
               const_cast<void*>(ws_o), const_cast<void*>(ws_ml), nullptr,
               B, qh, kvh, n_tok, head_dim, 1, page_size, pages_per_seq,
               base_off, split_cols, n_splits, 1.f, kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(B) * qh * n_tok * 32;
  paged_merge_kernel<<<static_cast<int>((threads + kMergeThreads - 1) /
                                        kMergeThreads),
                       kMergeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
