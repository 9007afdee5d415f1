// Varlen (packed) attention forward for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the TPU kernel `_vfwd_kernel` of paddle_tpu/ops/varlen_attention.py
// (:92, launched by `_vfwd_pallas`). What it computes: sequences packed back
// to back along one token axis, told apart by segment ids. A (query row,
// key column) pair counts where seg_q == seg_k and, under causal masking,
// where pos_k >= pos_q (pos = distance to the segment's end: bottom-right
// alignment). Padding carries -1 on the query side and -2 on the key side,
// so it never matches. Per query head: o = softmax(S) V and lse =
// logsumexp(S) over the counted pairs, S = Q K^T * scale; a row with no
// counted pair gets o = 0 and lse = -1e30.
//
// Design. The TPU kernel runs grid (head, q block, k block) with the k
// block sequential, carrying m, l and the accumulator in VMEM scratch;
// blocks here run in parallel and in no order, so the k axis is a loop
// inside a block that owns one (64-row q tile, query head), with m, l and
// the accumulator in fp32 registers (the tile loop of flash_attention.cu:
// 256 threads as 16 x 16, 4 rows and every 16th column a thread, row
// statistics by warp shuffles; tiles staged as fp32, d-major at a stride
// of 65 floats). Three points differ from the TPU kernel:
//   * GQA: query head h reads KV head h / (H / KVH) in place, by stride,
//     from the (T, KVH, D) projections, and q is read from (T, H, D) by
//     stride: no repeat of K/V, no (H, T, D) transposed copies.
//   * Skipping. A first small kernel reduces every 64-token tile of seg_q
//     and seg_k to the [min, max] of its non-negative ids. A block whose
//     q tile holds no real row writes o = 0, lse = -1e30 and returns; the
//     others stage every k tile's range in shared memory once and skip,
//     before any Q/K/V load, each k tile whose range is empty or disjoint
//     from the q tile's. With non-decreasing ids (packed prompts) the
//     ranges are exact, so a block computes only the k tiles its
//     segments touch; for any ids the test is sound, since disjoint
//     ranges hold no equal pair. With `same_offsets` (q and k token i at
//     the same place) tiles above the diagonal are skipped too. The TPU
//     kernel has only the diagonal skip, so a packed bucket pays for
//     every causal tile of it: at the serving prefill shape (five
//     thousand tokens of eight prompts in an 8192 bucket) 666 of the
//     8,256 causal tiles touch a segment.
//   * The ragged edge: rows and columns past Tq and Tk are zero-filled on
//     load and masked, so no padding to a block multiple is needed.
// fp32 and bf16 operands, widened to fp32 on load; the PV product takes P
// in fp32 (the TPU kernel casts P to V's dtype for the MXU). Head dims up
// to 128 through instantiations for 32, 64 and 128, padded with zeros.
//
// What bounds it: at the serving prefill shape (H = 32, D = 128, bf16)
// the kept pairs need some 0.4 GFLOP per layer against 4 MB of operands:
// operations, at the bf16 tensor-core rate. This simple design runs on
// fp32 CUDA cores, one block per SM (117 KB of staged tiles at D = 128),
// with no tensor cores and no cp.async/TMA pipelining; those belong to the
// PR that redesigns it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr int kTile = 64;        // rows of a q tile and of a k tile
constexpr int kPad = kTile + 1;  // stride of a d-major staged tile
constexpr int kPS = kTile + 4;   // stride of a row of a score tile
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

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
// tile: tiles [0, n_qt) of seg_q, then [n_qt, n_qt + n_kt) of seg_k. A
// tile with no non-negative id gets (INT_MAX, -1), an empty range.
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
  for (int r = lane; r < kTile; r += 32) {
    const int i = t0 + r;
    if (i < n) {
      const int s = seg[i];
      if (s >= 0) {
        lo = min(lo, s);
        hi = max(hi, s);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    ranges[2 * tile] = lo;
    ranges[2 * tile + 1] = hi;
  }
}

// Stage rows [row0, row0 + kTile) of one head of a strided (rows, ., D)
// operand into shared memory, d-major: dst[d * kPad + r]. Rows past `rows`
// and dims past D (up to DP) are zero.
template <int DP, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long long row_stride, int row0,
                                      int rows, int D) {
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP;
    const int d = i % DP;
    float x = 0.f;
    if (row0 + r < rows && d < D)
      x = to_float(src[static_cast<long long>(row0 + r) * row_stride + d]);
    dst[d * kPad + r] = x;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    va_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ seg_q,
                  const int* __restrict__ seg_k,
                  const int* __restrict__ pos_q,
                  const int* __restrict__ pos_k,
                  const int* __restrict__ ranges, T* __restrict__ o,
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
      if (row < tq) o[row * o_rs + h * D + i % D] = from_float<T>(0.f);
    }
    for (int r = threadIdx.x; r < kTile; r += kThreads)
      if (q0 + r < tq) lse[static_cast<long long>(h) * tq + q0 + r] = kNegInf;
    return;
  }

  for (int i = threadIdx.x; i < 2 * n_kt; i += kThreads)
    kr_s[i] = ranges[2 * n_qt + i];
  const T* kb = k + static_cast<long long>(h / group) * k_hs;
  const T* vb = v + static_cast<long long>(h / group) * v_hs;
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
    T* orow = o + row * o_rs + h * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = from_float<T>(acc[i][c] / ls);
    }
    if (tx == 0) lse[static_cast<long long>(h) * tq + row] = m[i] + logf(ls);
  }
  if (tile_count != nullptr && threadIdx.x == 0)
    atomicAdd(tile_count, computed);
}

// Shared memory of the forward kernel, in bytes, for padded head dim DP
// and n_kt key tiles.
size_t fwd_bytes(int dp, int n_kt) {
  return (3 * static_cast<size_t>(dp) * kPad + kTile * kPS) * sizeof(float) +
         (2 * kTile + 2 * static_cast<size_t>(n_kt)) * sizeof(int);
}

int padded_dim(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 128; }

template <typename T, int DP>
cudaError_t fwd_typed(const void* q, const void* k, const void* v,
                      const void* seg_q, const void* seg_k, const void* pos_q,
                      const void* pos_k, const void* ranges, void* o,
                      void* lse, int tq, int tk, int heads, int group, int d,
                      long long q_rs, long long q_hs, long long k_rs,
                      long long k_hs, long long v_rs, long long v_hs,
                      float scale, int causal, int same_offsets,
                      void* tile_count, cudaStream_t stream) {
  const int n_qt = (tq + kTile - 1) / kTile;
  const int n_kt = (tk + kTile - 1) / kTile;
  auto kernel = va_fwd_kernel<T, DP>;
  const size_t smem = fwd_bytes(DP, n_kt);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(n_qt, heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<const int*>(pos_q),
      static_cast<const int*>(pos_k), static_cast<const int*>(ranges),
      static_cast<T*>(o), static_cast<float*>(lse), tq, tk, group, d, q_rs,
      q_hs, k_rs, k_hs, v_rs, v_hs, scale, causal, same_offsets,
      static_cast<int*>(tile_count));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* va_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of dynamic shared memory the forward kernel needs for n_kt key
// tiles at head_dim d.
size_t va_smem_bytes(int n_kt, int d) { return fwd_bytes(padded_dim(d), n_kt); }

// q: (tq, heads, d) read at q[t * q_rs + h * q_hs + i]; k, v: (tk, kv_heads,
// d) read likewise with their own strides (head_dim contiguous); seg_q,
// pos_q: (tq,) int32; seg_k, pos_k: (tk,) int32 (pos = distance to the
// segment's end); ranges: scratch of 2 * (ceil(tq/64) + ceil(tk/64)) int32;
// o: contiguous (tq, heads, d) in `dtype` (0 fp32, 1 bf16); lse: (heads, tq)
// fp32; tile_count: null, or one int32 to which the number of computed
// (q tile, k tile, head) triples is added. Launches two kernels on
// `stream`, allocates nothing, and returns cudaGetLastError().
int va_fwd(const void* q, const void* k, const void* v, const void* seg_q,
           const void* seg_k, const void* pos_q, const void* pos_k,
           void* ranges, void* o, void* lse, int tq, int tk, int heads,
           int kv_heads, int d, long long q_rs, long long q_hs,
           long long k_rs, long long k_hs, long long v_rs, long long v_hs,
           float scale, int causal, int same_offsets, int dtype,
           void* tile_count, void* stream) {
  if (tq < 1 || tk < 1 || heads < 1 || heads > 65535 || kv_heads < 1 ||
      heads % kv_heads != 0 || d < 1 || d > 128 ||
      (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_qt = (tq + kTile - 1) / kTile;
  const int n_kt = (tk + kTile - 1) / kTile;
  constexpr int kRangeWarps = 8;
  tile_ranges_kernel<<<(n_qt + n_kt + kRangeWarps - 1) / kRangeWarps,
                       32 * kRangeWarps, 0, s>>>(
      static_cast<const int*>(seg_q), static_cast<const int*>(seg_k), tq, tk,
      n_qt, n_kt, static_cast<int*>(ranges));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int group = heads / kv_heads;
  const int dp = padded_dim(d);
#define VA_ARGS                                                              \
  q, k, v, seg_q, seg_k, pos_q, pos_k, ranges, o, lse, tq, tk, heads, group, \
      d, q_rs, q_hs, k_rs, k_hs, v_rs, v_hs, scale, causal, same_offsets,    \
      tile_count, s
  if (dtype == kF32) {
    if (dp == 32) return fwd_typed<float, 32>(VA_ARGS);
    if (dp == 64) return fwd_typed<float, 64>(VA_ARGS);
    return fwd_typed<float, 128>(VA_ARGS);
  }
  if (dp == 32) return fwd_typed<__nv_bfloat16, 32>(VA_ARGS);
  if (dp == 64) return fwd_typed<__nv_bfloat16, 64>(VA_ARGS);
  return fwd_typed<__nv_bfloat16, 128>(VA_ARGS);
#undef VA_ARGS
}

}  // extern "C"
