// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels `_decode_kernel` (paddle_tpu/ops/paged_attention.py
// :109) and `_quant_kernel` (:159), both launched by `_decode_pallas`. What
// they compute: one query token per sequence b, GQA attention of its query
// heads over the first lengths[b] columns of its paged KV cache, reached
// page by page through page_table[b]. int8 pages carry one fp32 scale per
// (head, token) and are dequantized here, so int8 is what crosses device
// memory. A length-0 sequence (a free slot) reads no page and gets zeros.
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

}  // extern "C"
