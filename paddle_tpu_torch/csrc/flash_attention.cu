// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV, plain C
// interface for ctypes.
//
// Replaces the three TPU kernels of paddle_tpu/ops/flash_attention.py:
//   fa_fwd     -> `_fwd_kernel`     (:107, launched by `_fwd_pallas`)
//   fa_bwd_dq  -> `_bwd_dq_kernel`  (:220, launched by `_bwd_pallas`)
//   fa_bwd_dkv -> `_bwd_dkv_kernel` (:277, launched by `_bwd_pallas`)
// What they compute, per (batch*head) slice of (BH, S, D) operands:
//   S = Q K^T * scale, masked to cols < sk and, if causal, rows >= cols
//   (top-left alignment, as the TPU kernel masks); forward: O = softmax(S)
//   V and lse = logsumexp(S) per row; backward, from lse and delta =
//   rowsum(dO * O): P = exp(S - lse), dP = dO V^T, dS = P (dP - delta)
//   scale, dQ = dS K, dK = dS^T Q, dV = P^T dO.
//
// Two designs, picked by dtype:
//   * bf16: the tensor-core tile loops of attn_fwd_sm90.cuh (forward:
//     mma.sync, cp.async K/V ring, softmax and P in registers, P entering
//     PV as two bf16 terms) and attn_bwd_sm90.cuh (dQ and dK/dV: the same
//     ring over K/V or over Q, dO, lse and delta; P and dS made in
//     registers and entering their products as two bf16 terms), with
//     `FlashPolicy` below as their mask policy. They need D % 8 == 0 and
//     16-byte aligned operands; the wrappers pad or realign to meet that.
//   * fp32: the CUDA-core design below. Its results hold the plain
//     versions to 1e-5, which TF32 tensor cores would not.
//
// The CUDA-core design. The TPU kernels carry fp32 accumulators in VMEM
// scratch across a sequential grid axis. Blocks here run in parallel and
// in no order, so that axis becomes a loop inside the block, and nothing
// is reduced across blocks: no atomics, results repeat from run to run.
//   * fwd and dQ: one block per (q tile of 64 rows, batch*head), looping
//     over k tiles; fwd keeps an online softmax (m, l, acc in fp32
//     registers), dQ accumulates dQ in fp32 registers.
//   * dK/dV: one block per (k tile of 64 rows, batch*head), looping over
//     q tiles, with dK and dV accumulated in fp32 registers.
// Under causal masking, tiles wholly above the diagonal are skipped.
// Tiles are staged in shared memory as fp32, d-major with a stride of 65
// floats, so that both the score product (rows of Q against rows of K)
// and the output product (columns of K, V, Q or dO) read without bank
// conflicts. 256 threads as a 16 x 16 grid: thread (ty, tx) owns 4 rows
// (ty*4 .. ty*4+3) and every 16th column starting at tx, so row
// statistics reduce over 16 lanes of one warp with shuffles. Head dims
// up to 128 run through instantiations for 32, 64 and 128, padded with
// zeros; ragged final tiles are zero-filled on load and masked. P stays
// fp32 in the products (the plain PyTorch version does the same).
//
// What bounds it: at the training shapes (S = 2048, D = 128, causal) each
// kernel does 4-8 flops per S-pair per head dim, hundreds of flops per
// byte of its operands, so it is bound by operations: the bf16 tensor
// core rate. At B = 2, H = 32 (Llama-3-8B training), bf16, counting the
// causal half (the tensor cores execute 103, 137 and 206 GFLOP, P and dS
// entering their products as two terms):
//   fwd   QK^T, PV          68.7 GFLOP -> 0.0695 ms at 989 TFLOP/s
//   dQ    S, dP, dQ         103  GFLOP -> 0.104 ms
//   dK/dV S, dP, dV, dK     137  GFLOP -> 0.139 ms
// (134-202 MB of operands, 0.04-0.06 ms at 3.35 TB/s); in fp32, against
// the 67 TFLOP/s of the CUDA cores, 1.03, 1.54 and 2.05 ms. The CUDA-core
// kernels stage 117-168 KB of fp32 tiles at D = 128, so one block of 256
// threads runs per SM (hence their launch bound of one block, which lets
// each thread keep its accumulators in up to 255 registers).
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

// Sum / max over the 16 lanes that share a row (tx = lane % 16). The
// butterfly leaves the identical value in every one of them.
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
// memory, d-major: dst[d * kPad + r]. Rows past `rows` and dims past D
// (up to DP) are zero. Consecutive threads read consecutive elements.
template <int DP>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src, int row0,
                                      int rows, int D) {
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP;
    const int d = i % DP;
    float x = 0.f;
    if (row0 + r < rows && d < D)
      x = src[static_cast<size_t>(row0 + r) * D + d];
    dst[d * kPad + r] = x;
  }
}

__device__ __forceinline__ bool visible(int row, int col, int sq, int sk,
                                        int causal) {
  return row < sq && col < sk && (!causal || row >= col);
}

// ------------------------------------------------------------- forward
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int sq, int sk, int D, float scale,
               int causal) {
  constexpr int NC = DP / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + DP * kPad;
  float* vs = ks + DP * kPad;
  float* ps = vs + DP * kPad;  // kTile x kPS

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n_qt = (sq + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - blockIdx.x) * kTile;  // longest causal rows first
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * sq * D;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;

  stage<DP>(qs, qb, q0, sq, D);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  int n_kt = (sk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (q0 + kTile - 1) / kTile + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's reads of ks, vs, ps are done
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
      // a row past sq sees nothing: its m stays kNegInf, its l 0, and it
      // is never written
      const int row = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = visible(row, k0 + tx + 16 * j, sq, sk, causal);
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
    if (row >= sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + (bh * sq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = acc[i][c] / ls;
    }
    if (tx == 0) lse[bh * sq + row] = m[i] + logf(ls);
  }
}

// ------------------------------------------------------------------ dQ
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int sq, int sk, int D, float scale,
              int causal) {
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + DP * kPad;
  float* ks = dos + DP * kPad;
  float* vs = ks + DP * kPad;
  float* dss = vs + DP * kPad;  // kTile x kPS

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n_qt = (sq + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - blockIdx.x) * kTile;
  const size_t bh = blockIdx.y;
  const float* kb = k + bh * sk * D;
  const float* vb = v + bh * sk * D;

  stage<DP>(qs, q + bh * sq * D, q0, sq, D);
  stage<DP>(dos, dout + bh * sq * D, q0, sq, D);
  float lr[4], dr[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lr[i] = row < sq ? lse[bh * sq + row] : 0.f;
    dr[i] = row < sq ? delta[bh * sq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  int n_kt = (sk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (q0 + kTile - 1) / kTile + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage<DP>(ks, kb, k0, sk, D);
    stage<DP>(vs, vb, k0, sk, D);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float a[4], g[4], b[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[d * kPad + ty * 4 + i];
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
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok =
            visible(q0 + ty * 4 + i, k0 + tx + 16 * j, sq, sk, causal);
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        dss[(ty * 4 + i) * kPS + tx + 16 * j] =
            ok ? p * (dp[i][j] - dr[i]) * scale : 0.f;
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
    float* drow = dq + (bh * sq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) drow[d] = acc[i][c];
    }
  }
}

// --------------------------------------------------------------- dK/dV
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int sq, int sk, int D, float scale,
               int causal) {
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + DP * kPad;
  float* qs = vs + DP * kPad;
  float* dos = qs + DP * kPad;
  float* pts = dos + DP * kPad;  // kTile x kPS: P^T of the tile
  float* dst = pts + kTile * kPS;  // kTile x kPS: dS^T of the tile
  float* ls = dst + kTile * kPS;   // lse of the tile's q rows
  float* dl = ls + kTile;          // delta of the tile's q rows

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * sq * D;
  const float* ob = dout + bh * sq * D;

  stage<DP>(ks, k + bh * sk * D, k0, sk, D);
  stage<DP>(vs, v + bh * sk * D, k0, sk, D);
  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int n_qt = (sq + kTile - 1) / kTile;
  // the first q tile holding a row >= k0 (rows below see none of k0..)
  const int qt0 = causal ? k0 / kTile : 0;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    stage<DP>(qs, qb, q0, sq, D);
    stage<DP>(dos, ob, q0, sq, D);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool in = q0 + r < sq;
      ls[r] = in ? lse[bh * sq + q0 + r] : 0.f;
      dl[r] = in ? delta[bh * sq + q0 + r] : 0.f;
    }
    __syncthreads();

    // thread (ty, tx): key rows ty*4+i, q rows tx+16j
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float a[4], w[4], b[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ks[d * kPad + ty * 4 + i];
        w[i] = vs[d * kPad + ty * 4 + i];
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
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const bool ok = visible(q0 + r, k0 + ty * 4 + i, sq, sk, causal);
        const float p = ok ? expf(s[i][j] * scale - ls[r]) : 0.f;
        pts[(ty * 4 + i) * kPS + r] = p;
        dst[(ty * 4 + i) * kPS + r] =
            ok ? p * (dp[i][j] - dl[r]) * scale : 0.f;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= sk) continue;
    float* krow = dk + (bh * sk + row) * D;
    float* vrow = dv + (bh * sk + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        krow[d] = dka[i][c];
        vrow[d] = dva[i][c];
      }
    }
  }
}

// Shared memory of each kernel, in floats, for padded head dim DP.
size_t fwd_floats(int dp) { return 3 * dp * kPad + kTile * kPS; }
size_t dq_floats(int dp) { return 4 * dp * kPad + kTile * kPS; }
size_t dkv_floats(int dp) {
  return 4 * dp * kPad + 2 * kTile * kPS + 2 * kTile;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int padded_dim(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 128; }

template <int DP>
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* o,
                    void* lse, int bh, int sq, int sk, int d, float scale,
                    int causal, cudaStream_t stream) {
  auto kernel = fwd_kernel<DP>;
  const size_t smem = fwd_floats(DP) * sizeof(float);
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sq + kTile - 1) / kTile, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dq_f32(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int sq, int sk, int d, float scale,
                   int causal, cudaStream_t stream) {
  auto kernel = dq_kernel<DP>;
  const size_t smem = dq_floats(DP) * sizeof(float);
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sq + kTile - 1) / kTile, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dkv_f32(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int bh, int sq, int sk, int d,
                    float scale, int causal, cudaStream_t stream) {
  auto kernel = dkv_kernel<DP>;
  const size_t smem = dkv_floats(DP) * sizeof(float);
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((sk + kTile - 1) / kTile, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, d, scale,
      causal);
  return cudaGetLastError();
}

bool args_ok(int bh, int sq, int sk, int d, int dtype) {
  return bh >= 1 && bh <= 65535 && sq >= 1 && sk >= 1 && d >= 1 &&
         d <= 128 && (dtype == kF32 || dtype == kBF16);
}

// The mask of the tensor-core loops (attn_fwd_sm90.cuh, attn_bwd_sm90.cuh):
// the ragged bounds and the top-left causal triangle of `visible`, as the
// rows each column keeps.
struct FlashPolicy {
  static constexpr size_t kExtraBytes = 0;
  int causal;
  int q0, k0, sq, sk;

  // the q-major loops (forward, dQ): this block's q tile
  __device__ __forceinline__ void begin(int, int q0_, int sq_, int sk_) {
    q0 = q0_;
    sq = sq_;
    sk = sk_;
  }
  // no column past the tile's last row under causal masking
  __device__ __forceinline__ int end() const {
    const int n_kt = (sk + kTile - 1) / kTile;
    return causal ? min(n_kt, q0 / kTile + 1) : n_kt;
  }
  __device__ __forceinline__ bool needed(int) const { return true; }
  __device__ __forceinline__ bool full(int kt) const {
    return pair_full(q0, kt * kTile);
  }
  __device__ __forceinline__ void stage(int, void*) const {}
  __device__ __forceinline__ attn_fwd_sm90::Span span(int col, int,
                                                      const void*) const {
    return {causal ? col : INT_MIN, col < sk ? sq : INT_MIN, INT_MAX,
            INT_MIN, INT_MAX, INT_MIN};
  }
  __device__ __forceinline__ bool drops() const { return false; }
  __device__ __forceinline__ float drop(float p, int, int) const { return p; }

  // the k-major loop (dK/dV): this block's k tile; under causal masking
  // no q tile before the one holding row k0 sees it
  __device__ __forceinline__ void begin_k(int, int k0_, int sq_, int sk_) {
    k0 = k0_;
    sq = sq_;
    sk = sk_;
  }
  __device__ __forceinline__ int q_begin() const {
    return causal ? k0 / kTile : 0;
  }
  __device__ __forceinline__ int q_end() const {
    return (sq + kTile - 1) / kTile;
  }
  __device__ __forceinline__ bool needed_q(int) const { return true; }
  __device__ __forceinline__ bool full_q(int qt) const {
    return pair_full(qt * kTile, k0);
  }
  __device__ __forceinline__ attn_fwd_sm90::Span key_span(int col) const {
    return span(col, 0, nullptr);
  }

  // every pair of the tiles at rows q0_ and columns k0_ is kept
  __device__ __forceinline__ bool pair_full(int q0_, int k0_) const {
    return q0_ + kTile <= sq && k0_ + kTile <= sk &&
           (!causal || q0_ >= k0_ + kTile - 1);
  }
};

}  // namespace

// The fp32 (CUDA-core) instantiation of F for the padded head dim.
#define FA_F32(F, ...)                                                   \
  const int dp = padded_dim(d);                                          \
  if (dp == 32) return F<32>(__VA_ARGS__, s);                            \
  if (dp == 64) return F<64>(__VA_ARGS__, s);                            \
  return F<128>(__VA_ARGS__, s)

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of dynamic shared memory each CUDA-core kernel needs at head_dim
// d: 0 the fp32 forward, 1 dQ, 2 dK/dV.
size_t fa_smem_bytes(int kernel, int d) {
  const int dp = padded_dim(d);
  const size_t f = kernel == 0 ? fwd_floats(dp)
                   : kernel == 1 ? dq_floats(dp)
                                 : dkv_floats(dp);
  return f * sizeof(float);
}

// Operands are contiguous (bh, sq|sk, d) slices in `dtype` (0 fp32, 1
// bf16); lse and delta are (bh, sq) fp32. Each call launches one kernel
// on `stream`, allocates nothing, and returns cudaGetLastError().
// bf16 runs the tensor-core kernels, which also need d % 8 == 0 and
// 16-byte aligned bf16 operands and outputs.
int fa_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int sq, int sk, int d, float scale, int causal, int dtype,
           void* stream) {
  if (!args_ok(bh, sq, sk, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    FlashPolicy pol{};
    pol.causal = causal;
    return static_cast<int>(attn_fwd_sm90::run(
        q, k, v, o, lse, bh, sq, sk, d, scale, pol, nullptr, s));
  }
  FA_F32(fwd_f32, q, k, v, o, lse, bh, sq, sk, d, scale, causal);
}

int fa_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int sq,
              int sk, int d, float scale, int causal, int dtype,
              void* stream) {
  if (!args_ok(bh, sq, sk, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    FlashPolicy pol{};
    pol.causal = causal;
    return static_cast<int>(attn_bwd_sm90::run_dq(
        q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale, pol, s));
  }
  FA_F32(dq_f32, q, k, v, dout, lse, delta, dq, bh, sq, sk, d, scale,
         causal);
}

int fa_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int bh, int sq, int sk, int d, float scale, int causal,
               int dtype, void* stream) {
  if (!args_ok(bh, sq, sk, d, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    FlashPolicy pol{};
    pol.causal = causal;
    return static_cast<int>(attn_bwd_sm90::run_dkv(
        q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale, pol, s));
  }
  FA_F32(dkv_f32, q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, scale,
         causal);
}

}  // extern "C"
