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
// Design. The TPU kernel runs grid (batch, KV head, page) with the page axis
// sequential, carrying the online-softmax state in VMEM scratch. Blocks
// here run in parallel and in no order, so one block owns a (sequence, KV
// head) and walks its columns in order inside the block: it stages the
// group's query rows once, then streams the KV in chunks of 64 columns
// (several pages at page size 16, each column's page looked up in the
// table), so every KV byte is read once for all `group` query heads. Loads
// are 16-byte vectors (4 fp32, 8 bf16 or 16 int8 values), dequantized and
// widened to fp32 into shared memory. Scores, the online softmax (one warp
// per query head, warp shuffles) and the accumulator are fp32. Pages at or
// past the length are never touched; the ragged last chunk is cut to the
// length, so no column is masked.
//
// What bounds it: the bytes of KV read (about 2 flops per byte of bf16 KV
// at group 4, far below the card's ridge point). What this simple design
// leaves on the table: one block per (sequence, KV head) is 64 blocks for
// 8 sequences at 8 KV heads, half the SMs; splitting a long sequence's
// columns over several blocks (a second pass to merge their softmax
// states) would fill the card. Loads are not pipelined behind compute
// (cp.async/TMA), and the products run on CUDA cores. Those belong to a
// later redesign.
//
// pa_verify replaces the TPU kernels `_verify_kernel` (:284) and
// `_verify_quant_kernel` (:339), launched by `paged_verify_attention`
// (:346): a chunk of G query tokens per sequence (speculative-decoding
// verify, chunked prefill), token g at position base_lengths[b] + g,
// attending the columns < base_lengths[b] + g + 1. q is (B, QH, G, D), so
// a KV head's group x G query rows are contiguous and are read in place;
// row r is token r % G. The TPU kernel pads those rows to a sublane
// multiple; nothing here needs that. One block owns a (sequence, KV head,
// tile of 16, 32 or 64 rows) and streams 64-column KV chunks as pa_decode
// does, up to the tile's largest limit base + g_max + 1 (past it every row is
// masked, as the TPU kernel skips a page at or past base + G); inside a
// chunk each row masks its own columns. Bounded, like decode, by the KV
// bytes: every KV byte is read once for all of a head's group x G rows
// (one tile at G <= 16 and group 4), which is the point of the TPU kernel.
// The tile size is a template argument, so each thread's row loops unroll
// to the rows it owns: scores take one column and TILE / 4 rows a thread,
// each row's q read as a broadcast 16-byte vector; the accumulator lives in
// registers, 4 head dims and up to 8 rows a thread. (A first version with
// one 64-row tile for every shape spent most of its time on the unrolled
// iterations of rows a 16-row tile does not have.) Every row sees
// column 0, so each row's running max is finite after the first chunk and
// `l` is never 0 (the final divide still maps l == 0 to 1, as `_fin`
// does). The same under-fill as pa_decode (64 blocks at 8 sequences x 8 KV
// heads, G = 4) and the same unpipelined loads remain.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

}  // extern "C"
