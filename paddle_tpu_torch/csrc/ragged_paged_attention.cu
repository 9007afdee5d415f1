// Ragged paged attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_ragged_kernel` of
// paddle_tpu/kernels/ragged_paged_attention.py (launched by
// `_ragged_pallas`), in its plain and its int8 variant. What it computes:
// T flat token rows; row i is GQA attention of q[i] over the KV of slot
// tok_slot[i], reached page by page through page_table, causal to cache
// columns < tok_pos[i] + 1. A row with tok_pos = -1 is an inactive slack
// row and gets zeros. int8 pages carry one fp32 scale per (head, token)
// and are dequantized here, so int8 is what crosses device memory.
//
// Two designs, chosen by the wrapper before launch (no fallback).
//
// Tensor cores (`ragged_tc_kernel`): bf16 q over bf16 or int8 pages, head
// dim a multiple of 8 up to 128, GQA group up to 64. The TPU kernel's grid
// (T, KVH, pages) with its sequential page axis does not carry over:
//   * A work plan, built on the card by `ragged_plan_kernel` (one block,
//     three prefix scans over T) from tok_slot and tok_pos alone, so a
//     serving step builds it once for all its layers: a run is a maximal
//     stretch of adjacent active rows of one slot (the engine lays out
//     decode rows, then each prefill or verify chunk), a tile up to 64 /
//     group tokens of one run, with its kt_end = ceil((max pos + 1) / 64);
//     the plan also lists the inactive rows. No host sync.
//   * One block of 4 warps per (tile, KV head), a tile's tokens x the
//     group's query heads as the 64 rows of one M tile (row m: token
//     row0 + m / group, head h * group + m % group, so `group` rows are
//     contiguous in q), tiles of one KV head side by side so that a run's
//     tiles share its pages through L2. The grid is T x KVH blocks; those
//     past the plan's tiles zero one inactive row each or exit. Q is read
//     once, straight into m16n8k16 A fragments.
//   * The tile loop of csrc/paged_tc_sm90.cuh, shared with the paged
//     decode and verify kernels (csrc/paged_attention.cu): K/V tiles of
//     64 columns gathered through the slot's page-table row by cp.async
//     into a ring of three stages, S = Q K^T and O += P V by
//     mma.sync.m16n8k16 with the online softmax in registers and P as
//     bf16 hi + lo, a narrow tile split over the warps by columns, int8
//     pages widened in shared memory with their scales folded in fp32
//     (the header says how and why). Each row masks by its own tok_pos
//     on a tile that reaches it; the work type `RaggedWork` says where a
//     block's rows live.
// What bounds it: the KV bytes (a decode row does about 2 flops a byte at
// group 4); the wave fits the card at once, so its longest block, the
// longest decode row's, sets the time. What it leaves: that row's columns
// are walked by one block (the paged kernels' split over blocks with a
// merge pass, csrc/paged_attention.cu, would shorten it); per k tile its
// warps spend as long issuing copies (and, for int8, widening them
// through shared memory) as multiplying, in turn (TMA, or producer
// warps, would overlap them); tiles are not ordered longest first (the
// engine's layout puts decode rows first); mma.sync, not wgmma.
//
// CUDA cores (`ragged_kernel`): fp32 q (over fp32 or int8 pages) and any
// other shape, such as head dim 256. One thread block per (token row, KV
// head) stages its GQA group's q rows in shared memory, then walks
// ceil((tok_pos+1)/page) pages in order (none for an inactive row). Each
// page is consumed in chunks of kChunk columns: the chunk's K and V are
// staged (dequantized) in shared memory, scores are formed in fp32, and
// the online-softmax statistics (m, l) and the accumulator stay in fp32
// shared memory. Rows of the same slot each re-read the same pages, the
// products run on CUDA cores, and loads are plain.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "attn_fwd_sm90.cuh"
#include "paged_tc_sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;  // KV columns staged per pass

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
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

// Shared memory, in floats: q group (group x Dp), K and V chunks
// (kChunk x Dp each), scores (group x kChunk), accumulator (group x D),
// and m, l, alpha (group each). Dp = D + 1 pads rows so that threads
// reading one column of different rows hit different banks.
size_t smem_floats(int group, int head_dim) {
  const size_t dp = static_cast<size_t>(head_dim) + 1;
  return group * dp + 2 * kChunk * dp + static_cast<size_t>(group) * kChunk +
         static_cast<size_t>(group) * head_dim + 3 * static_cast<size_t>(group);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
    ragged_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pages,
                  const KT* __restrict__ v_pages,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ page_table,
                  const int* __restrict__ tok_slot,
                  const int* __restrict__ tok_pos, QT* __restrict__ out,
                  int group, int head_dim, int num_pages, int page_size,
                  int pages_per_seq, float sm_scale) {
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int qh = gridDim.y * group;
  const int D = head_dim;
  const int Dp = head_dim + 1;
  const int tid = threadIdx.x;
  const size_t q_off =
      (static_cast<size_t>(t) * qh + static_cast<size_t>(h) * group) * D;
  const int pos = tok_pos[t];
  if (pos < 0) {  // inactive slack row: no page is read
    for (int i = tid; i < group * D; i += blockDim.x)
      out[q_off + i] = from_float<QT>(0.f);
    return;
  }

  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + group * Dp;
  float* sv = sk + kChunk * Dp;
  float* ss = sv + kChunk * Dp;
  float* acc = ss + group * kChunk;
  float* sm = acc + group * D;
  float* sl = sm + group;
  float* sa = sl + group;

  for (int i = tid; i < group * D; i += blockDim.x) {
    sq[(i / D) * Dp + i % D] = to_float(q[q_off + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += blockDim.x) {
    sm[g] = -INFINITY;
    sl[g] = 0.f;
  }

  const int limit = pos + 1;
  int n_pages = (limit + page_size - 1) / page_size;
  if (n_pages > pages_per_seq) n_pages = pages_per_seq;
  const int* ptab = page_table + static_cast<size_t>(tok_slot[t]) * pages_per_seq;
  __syncthreads();

  for (int pi = 0; pi < n_pages; ++pi) {
    // row index of the page's first token in the (KVH, P, page) layout
    const size_t page_base =
        (static_cast<size_t>(h) * num_pages + ptab[pi]) * page_size;
    for (int c0 = 0; c0 < page_size; c0 += kChunk) {
      const int col0 = pi * page_size + c0;
      if (col0 >= limit) break;  // uniform across the block
      const int n = min(kChunk, page_size - c0);

      for (int i = tid; i < n * D; i += blockDim.x) {
        const int j = i / D;
        const int d = i % D;
        const size_t row = page_base + c0 + j;
        float kx = to_float(k_pages[row * D + d]);
        float vx = to_float(v_pages[row * D + d]);
        if (k_scale != nullptr) {
          kx *= k_scale[row];
          vx *= v_scale[row];
        }
        sk[j * Dp + d] = kx;
        sv[j * Dp + d] = vx;
      }
      __syncthreads();

      for (int i = tid; i < group * kChunk; i += blockDim.x) {
        const int g = i / kChunk;
        const int j = i % kChunk;
        float s = -INFINITY;
        if (j < n && col0 + j < limit) {
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot += sq[g * Dp + d] * sk[j * Dp + d];
          s = dot * sm_scale;
        }
        ss[i] = s;
      }
      __syncthreads();

      // column col0 < limit is always present, so mx is finite here
      for (int g = tid; g < group; g += blockDim.x) {
        float mx = sm[g];
        for (int j = 0; j < kChunk; ++j) mx = fmaxf(mx, ss[g * kChunk + j]);
        const float alpha = expf(sm[g] - mx);
        float sum = 0.f;
        for (int j = 0; j < kChunk; ++j) {
          const float p = expf(ss[g * kChunk + j] - mx);
          ss[g * kChunk + j] = p;
          sum += p;
        }
        sl[g] = sl[g] * alpha + sum;
        sm[g] = mx;
        sa[g] = alpha;
      }
      __syncthreads();

      for (int i = tid; i < group * D; i += blockDim.x) {
        const int g = i / D;
        const int d = i % D;
        float a = acc[i] * sa[g];
        for (int j = 0; j < n; ++j) a += ss[g * kChunk + j] * sv[j * Dp + d];
        acc[i] = a;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < group * D; i += blockDim.x) {
    const float l = sl[i / D];
    out[q_off + i] = from_float<QT>(acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* k_pages,
                         const void* v_pages, const void* k_scale,
                         const void* v_scale, const void* page_table,
                         const void* tok_slot, const void* tok_pos, void* out,
                         int T, int qh, int kvh, int head_dim, int num_pages,
                         int page_size, int pages_per_seq, float sm_scale,
                         cudaStream_t stream) {
  const int group = qh / kvh;
  const size_t smem = smem_floats(group, head_dim) * sizeof(float);
  auto kernel = ragged_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(T, kvh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(page_table),
      static_cast<const int*>(tok_slot), static_cast<const int*>(tok_pos),
      static_cast<QT*>(out), group, head_dim, num_pages, page_size,
      pages_per_seq, sm_scale);
  return cudaGetLastError();
}

// ------------------------------------------------- the tensor-core design
namespace tc = attn_fwd_sm90;
namespace ptc = paged_tc_sm90;
using tc::kTileK;
using tc::kTileQ;

// The work plan, int32: [n_tiles, n_inactive], then T tiles of kTileInts
// (row0, n_rows, kt_end, lim), then T inactive row indices. Tiles and
// inactive rows lie in row order; only the first n_tiles / n_inactive of
// each are written.
constexpr int kPlanHeader = 2;
constexpr int kTileInts = 4;
constexpr int kPlanThreads = 1024;

struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Inclusive scan of x over the block's threads in order; `total` is the
// last thread's result. `buf` holds 32 ints of shared memory.
template <class Op>
__device__ __forceinline__ int block_scan(int x, int* buf, Op op, int& total) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = op(x, y);
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = buf[lane < n_warps ? lane : n_warps - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = op(w, y);
    }
    if (lane < n_warps) buf[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x = op(buf[warp - 1], x);
  total = buf[n_warps - 1];
  __syncthreads();  // buf is reused by the next scan
  return x;
}

// The plan of one flat buffer, one block. A run is a maximal stretch of
// adjacent active rows of one slot (tok_pos >= 0, tok_slot equal to the
// row before); a tile is up to R = 64 / group consecutive rows of one run,
// counted from the run's first row, so that its R x group query rows fill
// one 64-row M tile. Three block scans a pass of blockDim rows: the last
// run start at or before each row (max), the tile starts and the inactive
// rows (sums), each carried into the next pass. A tile's lim is the
// largest min(pos + 1, cap) of its rows, kt_end = ceil(lim / 64).
__global__ void __launch_bounds__(kPlanThreads)
    ragged_plan_kernel(const int* __restrict__ slot,
                       const int* __restrict__ pos, int T, int group,
                       int cap, int* __restrict__ plan) {
  __shared__ int buf[32];
  const int R = kTileQ / group;
  int* tiles = plan + kPlanHeader;
  int* inactive = tiles + kTileInts * T;
  int run_carry = -1, tile_carry = 0, idle_carry = 0;
  for (int base = 0; base < T; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool in = i < T;
    const bool on = in && pos[i] >= 0;
    const bool starts =
        on && (i == 0 || pos[i - 1] < 0 || slot[i - 1] != slot[i]);
    int total;
    const int run0 = max(block_scan(starts ? i : -1, buf, Max(), total),
                         run_carry);
    run_carry = max(run_carry, total);
    const bool first = on && (i - run0) % R == 0;
    const int t = tile_carry + block_scan(first ? 1 : 0, buf, Sum(), total) -
                  1;
    tile_carry += total;
    const int z =
        idle_carry + block_scan(in && !on ? 1 : 0, buf, Sum(), total) - 1;
    idle_carry += total;
    if (in && !on) inactive[z] = i;
    if (first) {
      int n = 1;
      int lim = min(pos[i] + 1, cap);
      while (n < R && i + n < T && pos[i + n] >= 0 && slot[i + n] == slot[i]) {
        lim = max(lim, min(pos[i + n] + 1, cap));
        ++n;
      }
      int* tl = tiles + kTileInts * t;
      tl[0] = i;
      tl[1] = n;
      tl[2] = (lim + kTileK - 1) / kTileK;
      tl[3] = lim;
    }
  }
  if (threadIdx.x == 0) {
    plan[0] = tile_carry;
    plan[1] = idle_carry;
  }
}

struct TcArgs {
  const __nv_bfloat16* q;      // (T, qh, D)
  const void* k;               // (kvh, num_pages, page, D), bf16 or int8
  const void* v;
  const float* k_scale;        // (kvh, num_pages, page, 1), int8 only
  const float* v_scale;
  const int* page_table;       // (S, pps)
  const int* tok_slot;         // (T,)
  const int* tok_pos;          // (T,)
  const int* plan;             // ragged_plan_kernel's
  __nv_bfloat16* out;          // (T, qh, D)
  int* tile_count;             // k tiles computed, summed; or null
  int T, qh, kvh, D, num_pages, page, pps;
  float scale;
};

// The work of one block of ragged_tc_kernel for paged_tc_sm90::tile_loop:
// tile (row0, n_rows, kt_end, lim) of the plan for KV head h; M row m is
// token row0 + m / group, its limit min(tok_pos + 1, cap); the k tiles
// [0, kt_end) of the tile's slot. The epilogue writes O / l as bf16.
struct RaggedWork {
  const TcArgs& a;
  int h, group, m_rows, lim, kt1, row0;
  const int* prow;
  static constexpr int kt0 = 0;

  __device__ __forceinline__ const __nv_bfloat16* q_row(int m) const {
    return a.q + (static_cast<long long>(row0 + m / group) * a.qh +
                  h * group + m % group) * a.D;
  }
  __device__ __forceinline__ int row_lim(int m) const {
    return min(a.tok_pos[row0 + m / group] + 1, a.pps * a.page);
  }
  // O / l in fp32, written as bf16 pairs to
  // out[row0 + m / group, h * group + m % group]
  template <int NB>
  __device__ __forceinline__ void finish(float (&acc)[NB][4],
                                         const float (&)[2],
                                         const float (&l)[2], int row_a,
                                         int col_in) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int mrow = row_a + 8 * r;
      if (mrow >= m_rows) continue;
      const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
      __nv_bfloat16* orow =
          a.out + (static_cast<long long>(row0 + mrow / group) * a.qh +
                   h * group + mrow % group) * a.D;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int d = 8 * j + col_in;
        if (d < a.D)
          *reinterpret_cast<unsigned*>(orow + d) =
              tc::pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
      }
    }
    if (a.tile_count != nullptr && threadIdx.x == 0)
      atomicAdd(a.tile_count, kt1);
  }
};

// One block of 4 warps per (tile of the plan, KV head h), the loop of
// paged_tc_sm90.cuh over the tile's k tiles. Blocks past the plan's
// n_tiles x kvh zero one inactive row each, and the rest exit. KV is
// int8_t or __nv_bfloat16.
template <int DP, class KV>
__global__ void __launch_bounds__(tc::kThreads, 2)
    ragged_tc_kernel(const TcArgs a) {
  extern __shared__ __align__(128) unsigned char rtc_smem[];
  const int n_tiles = a.plan[0];
  const int b = blockIdx.x;
  if (b >= n_tiles * a.kvh) {
    const int z = b - n_tiles * a.kvh;
    if (z < a.plan[1]) {
      const int row = a.plan[kPlanHeader + kTileInts * a.T + z];
      uint4* o = reinterpret_cast<uint4*>(
          a.out + static_cast<long long>(row) * a.qh * a.D);
      for (int i = threadIdx.x; i < a.qh * a.D / 8; i += tc::kThreads)
        o[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  // tiles of one KV head side by side: a run's tiles share its pages in L2
  const int tile = b % n_tiles;
  const int h = b / n_tiles;
  const int* tl = a.plan + kPlanHeader + kTileInts * tile;
  const int row0 = tl[0];
  const int group = a.qh / a.kvh;
  const RaggedWork w{a,      h,      group, tl[1] * group, tl[3], tl[2],
                     row0,
                     a.page_table +
                         static_cast<long long>(a.tok_slot[row0]) * a.pps};
  ptc::tile_loop<DP, KV>(w, rtc_smem);
}

template <int DP, class KV>
cudaError_t tc_launch_typed(const TcArgs& a, cudaStream_t stream) {
  auto kernel = ragged_tc_kernel<DP, KV>;
  const size_t smem = ptc::smem_bytes(DP, sizeof(KV) == 1, a.pps);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  // every tile and inactive row has a block: n_tiles <= active rows
  kernel<<<a.T * a.kvh, tc::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the CUDA-core kernel
// needs.
size_t rpa_smem_bytes(int group, int head_dim) {
  return smem_floats(group, head_dim) * sizeof(float);
}

const char* rpa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The CUDA-core kernel. q: (T, qh, D) in q_dtype; k_pages/v_pages: (kvh,
// num_pages, page_size, D) in kv_dtype; k_scale/v_scale: (kvh, num_pages,
// page_size, 1) fp32 for int8 pages, else null; page_table: (S,
// pages_per_seq) int32; tok_slot, tok_pos: (T,) int32; out: (T, qh, D) in
// q_dtype. All contiguous. Launches on `stream`, allocates nothing, and
// returns cudaGetLastError().
int rpa_launch(const void* q, const void* k_pages, const void* v_pages,
               const void* k_scale, const void* v_scale,
               const void* page_table, const void* tok_slot,
               const void* tok_pos, void* out, int T, int qh, int kvh,
               int head_dim, int num_pages, int page_size, int pages_per_seq,
               float sm_scale, int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RPA_ARGS                                                            \
  q, k_pages, v_pages, k_scale, v_scale, page_table, tok_slot, tok_pos, out, \
      T, qh, kvh, head_dim, num_pages, page_size, pages_per_seq, sm_scale, s
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_typed<float, float>(RPA_ARGS);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(RPA_ARGS);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return launch_typed<float, int8_t>(RPA_ARGS);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch_typed<__nv_bfloat16, int8_t>(RPA_ARGS);
#undef RPA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory one block of the tensor-core kernel
// needs.
size_t rpa_tc_smem_bytes(int head_dim, int kv_dtype, int pages_per_seq) {
  return ptc::smem_bytes(ptc::padded_dim(head_dim), kv_dtype == kI8,
                          pages_per_seq);
}

// The tensor-core kernel's work plan of a flat buffer (see
// ragged_plan_kernel): tok_slot, tok_pos (T,) int32; plan 2 + 5 T int32;
// rows of a tile x group <= 64; cap = pages_per_seq x page_size. One block
// on `stream`.
int rpa_plan(const void* tok_slot, const void* tok_pos, int T, int group,
             int cap, void* plan, void* stream) {
  if (T < 1 || group < 1 || group > kTileQ || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ragged_plan_kernel<<<1, kPlanThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tok_slot), static_cast<const int*>(tok_pos), T,
      group, cap, static_cast<int*>(plan));
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel: q and out (T, qh, D) bf16; pages as rpa_launch's
// in kv_dtype bf16 or int8 (with scales); `plan` from rpa_plan for these
// tok_slot, tok_pos, qh / kvh and cap; tile_count null or one int the
// blocks add their k tiles to. D % 8 == 0, D <= 128, qh / kvh <= 64, bf16
// bases 16-byte and int8 bases 8-byte aligned. Returns
// cudaGetLastError().
int rpa_tc_launch(const void* q, const void* k_pages, const void* v_pages,
                  const void* k_scale, const void* v_scale,
                  const void* page_table, const void* tok_slot,
                  const void* tok_pos, const void* plan, void* out,
                  void* tile_count, int T, int qh, int kvh, int head_dim,
                  int num_pages, int page_size, int pages_per_seq,
                  float sm_scale, int kv_dtype, void* stream) {
  const bool quant = kv_dtype == kI8;
  const uintptr_t kv_align = quant ? 7 : 15;
  if (head_dim % 8 != 0 || head_dim > 128 || kvh < 1 || qh % kvh != 0 ||
      static_cast<long long>(pages_per_seq) * page_size >= (1 << 26) ||
      qh / kvh > kTileQ || (!quant && kv_dtype != kBF16) ||
      (reinterpret_cast<uintptr_t>(q) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15) ||
      (reinterpret_cast<uintptr_t>(k_pages) & kv_align) ||
      (reinterpret_cast<uintptr_t>(v_pages) & kv_align) ||
      (quant && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const TcArgs a{static_cast<const __nv_bfloat16*>(q),
                 k_pages,
                 v_pages,
                 static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale),
                 static_cast<const int*>(page_table),
                 static_cast<const int*>(tok_slot),
                 static_cast<const int*>(tok_pos),
                 static_cast<const int*>(plan),
                 static_cast<__nv_bfloat16*>(out),
                 static_cast<int*>(tile_count),
                 T,
                 qh,
                 kvh,
                 head_dim,
                 num_pages,
                 page_size,
                 pages_per_seq,
                 sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = ptc::padded_dim(head_dim);
  if (quant)
    return dp == 32   ? tc_launch_typed<32, int8_t>(a, s)
           : dp == 64 ? tc_launch_typed<64, int8_t>(a, s)
                      : tc_launch_typed<128, int8_t>(a, s);
  return dp == 32   ? tc_launch_typed<32, __nv_bfloat16>(a, s)
         : dp == 64 ? tc_launch_typed<64, __nv_bfloat16>(a, s)
                    : tc_launch_typed<128, __nv_bfloat16>(a, s);
}

}  // extern "C"
