// The tensor-core tile loop of paged attention on Hopper (sm_90a), shared
// by csrc/ragged_paged_attention.cu (`ragged_tc_kernel`) and
// csrc/paged_attention.cu (`paged_tc_kernel`, the bf16 route of
// `pa_decode` and `pa_verify`). Both compute GQA attention of bf16 query
// rows over a paged KV cache (bf16 pages, or int8 pages with one fp32
// scale per (head, token)), each row causal to its own column limit.
//
// One block of 4 warps computes one M tile of 64 rows for one KV head h:
// row m is token t0 + m / group and query head h * group + m % group, so
// a tile holds up to 64 / group tokens. The block walks the k tiles
// [kt0, kt1) of 64 columns of one sequence, reached through its
// page-table row. What a block computes and where its rows live is the
// work type's; the loop is this file's:
//   * the sequence's page-table entries for the block's columns read
//     into shared memory once;
//   * K/V tiles gathered by cp.async into a ring of kStages stages: 16-byte
//     copies of column c from page ptab[c / page] at offset c % page into
//     swizzled bf16 tiles, or 8-byte copies into int8 tiles; columns at or
//     past the work's `lim` are zero-filled, never read. c / page is a
//     multiply by a reciprocal (exact below 2^26 columns, which the
//     launches check), rows are 32-bit offsets within a KV head's pages:
//     with 4 warps and at most 2 blocks an SM nothing hides an
//     instruction's latency, and issuing the gathered copies cost as much
//     as the products;
//   * Q read once, straight into m16n8k16 A fragments; S = Q K^T and
//     O += P V by mma.sync.m16n8k16 (bf16 in, fp32 accumulate), the online
//     softmax in registers in the log2 domain, P as bf16 hi + lo (one
//     bf16 term moved rows that see few keys past the bf16 tolerance);
//   * a narrow tile (at most 16 rows: a decode row at group 4 holds 4) is
//     shared by the 4 warps along its columns, 16 each, their softmax
//     states merged at the end; on a wide one a warp whose 16 rows hold
//     no query skips its products;
//   * int8 pages widened to bf16 in shared memory by byte permutes (exact,
//     |x| <= 127), a score column multiplied by its K scale in fp32 after
//     Q K^T, P by its V scale before the hi + lo split, l summing the
//     unscaled P: the result differs from dequantize-then-multiply by the
//     order of sums and the 2^-17 of P.
//
// A work type W provides: `a`, the launch's arguments (q, k, v, k_scale,
// v_scale, D, num_pages, page, pps, scale); `h`, `group`, `m_rows` (M rows
// that hold a query), `lim` (the block's largest column limit), `kt0`,
// `kt1` (its k tiles) and `prow` (the sequence's page-table row);
// `q_row(m)` and `row_lim(m)` for M row m < m_rows; and `finish(...)`, the
// epilogue, given each thread's two rows' O, m and l after the block's
// warps have been merged (warp 0 alone on a narrow tile).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "attn_fwd_sm90.cuh"

namespace paged_tc_sm90 {

namespace tc = attn_fwd_sm90;
using tc::kTileK;
using tc::kTileQ;

// Stages of the K/V copy ring: the copies of the next kStages - 1 k tiles
// fly while one computes.
constexpr int kStages = 3;

// Shared memory of the loop at head dim DP: bf16 pages, a ring of kStages
// K/V tile pairs; int8 pages, a ring of kStages int8 pairs with their
// scales, and one bf16 pair they are widened into; then `pps` page-table
// entries. (Q lives in registers.)
constexpr size_t smem_bytes(int dp, bool quant, int pps) {
  const size_t pair = 2 * static_cast<size_t>(kTileK) * dp;  // elements
  return (quant ? kStages * (pair + 2 * kTileK * 4) + pair * 2
                : kStages * pair * 2) +
         static_cast<size_t>(pps) * 4;
}

// The head dim a kernel is instantiated for: 32, 64 or 128.
inline int padded_dim(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 128; }

// 8 bytes global -> shared; `bytes` 8 copies, 0 zero-fills.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// The loop of one block for work w over its k tiles; KV is int8_t or
// __nv_bfloat16, `smem` the block's dynamic shared memory of
// smem_bytes(DP, ...).
template <int DP, class KV, class W>
__device__ __forceinline__ void tile_loop(const W& w, unsigned char* smem) {
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int KS = DP / 16;  // k-steps of Q K^T
  constexpr int NB = DP / 8;   // 8-dim blocks of the output
  constexpr int kTileElems = kTileK * DP;
  constexpr int kChunks = DP / 8;                // 8-element chunks a row
  constexpr int kStep = tc::kThreads / kChunks;  // rows between two copies
  const auto& a = w.a;
  const int h = w.h;
  const int group = w.group;
  const int m_rows = w.m_rows;
  const int lim = w.lim;
  const int kt0 = w.kt0;
  const int kt1 = w.kt1;
  const int D = a.D;

  // bf16 pages: stage s holds K at kv0 + 2s tiles, V one tile after it.
  // int8 pages: stage s holds int8 K, V at stage8 + 2s tiles, their scales
  // at scales + 2s * 64, and kv0 the one widened bf16 pair.
  __nv_bfloat16* kv0 = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* stage8 = reinterpret_cast<int8_t*>(kv0 + 2 * kTileElems);
  float* scales = reinterpret_cast<float*>(stage8 + kStages * 2 * kTileElems);
  int* ptab = kQuant ? reinterpret_cast<int*>(scales + kStages * 2 * kTileK)
                     : reinterpret_cast<int*>(kv0 + kStages * 2 * kTileElems);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = threadIdx.x / kChunks;  // this thread's copies: chunk c of
  const int c = threadIdx.x % kChunks;   // rows r0, r0 + kStep, ...
  const bool c_in = c * 8 < D;

  // the page-table entries of the block's columns [kt0 * 64, hi): entry
  // p0 + i at ptab[i]
  const int p0 = kt0 * kTileK / a.page;
  const int hi = min(lim, kt1 * kTileK);
  for (int i = threadIdx.x; i < (hi + a.page - 1) / a.page - p0;
       i += tc::kThreads)
    ptab[i] = w.prow[p0 + i];
  __syncthreads();  // the page row, before any K/V copy reads it

  // Issue the copies of k tile kt into stage st: column col = kt * 64 + r
  // from page ptab[col / page - p0] at offset col % page; columns at or
  // past lim and chunks past D are zero-filled (their source, the pool's
  // base, is never read). col / page is a multiply by ceil(2^32 / page)
  // (page 1 needs none), rows are 32-bit within the head's pages.
  const unsigned page_magic =
      static_cast<unsigned>((0x100000000ull + a.page - 1) / a.page);
  const long long head_row0 = static_cast<long long>(h) * a.num_pages * a.page;
  const KV* kh = static_cast<const KV*>(a.k) + head_row0 * D + c * 8;
  const KV* vh = static_cast<const KV*>(a.v) + head_row0 * D + c * 8;
  const float* ksh = a.k_scale + (kQuant ? head_row0 : 0);
  const float* vsh = a.v_scale + (kQuant ? head_row0 : 0);
  auto issue = [&](int kt, int st) {
#pragma unroll
    for (int i = 0; i < kTileK / kStep; ++i) {
      const int r = r0 + i * kStep;
      const unsigned col = kt * kTileK + r;
      const bool in = col < static_cast<unsigned>(lim);
      const unsigned pi = a.page == 1 ? col : __umulhi(col, page_magic);
      // the column's row among the head's (num_pages x page) rows
      const int row = in ? ptab[in ? pi - p0 : 0] * a.page +
                               (col - pi * a.page)
                         : 0;
      const long long off = static_cast<long long>(row) * D;
      const bool cp = in && c_in;
      if constexpr (kQuant) {
        int8_t* ks = stage8 + 2 * st * kTileElems + r * DP + c * 8;
        cp_async8(ks, kh + off, cp ? 8 : 0);
        cp_async8(ks + kTileElems, vh + off, cp ? 8 : 0);
      } else {
        __nv_bfloat16* ks = kv0 + 2 * st * kTileElems + tc::swz<DP>(r, c);
        tc::cp_async16(ks, kh + off, cp ? 16 : 0);
        tc::cp_async16(ks + kTileElems, vh + off, cp ? 16 : 0);
      }
    }
    if constexpr (kQuant) {
      // one scale a thread, so that no warp diverges: K's of column t
      // for threads t < 64, V's of column t - 64 for the others
      static_assert(tc::kThreads == 2 * kTileK, "a scale a thread");
      const int t = threadIdx.x;
      const unsigned col = kt * kTileK + t % kTileK;
      const bool in = col < static_cast<unsigned>(lim);
      const unsigned pi = a.page == 1 ? col : __umulhi(col, page_magic);
      const int row = in ? ptab[in ? pi - p0 : 0] * a.page +
                               (col - pi * a.page)
                         : 0;
      tc::cp_async4(scales + 2 * st * kTileK + t,
                    (t < kTileK ? ksh : vsh) + row, in ? 4 : 0);
    }
  };
  // int8 pages: widen this thread's own chunks of stage st to bf16 into
  // the one bf16 K/V pair. Exact (|x| <= 128 has at most 8 significant
  // bits) and without conversion instructions: byte b becomes the fp32
  // 2^23 + (b ^ 0x80) by a byte permute, minus 2^23 + 128 that is x, and
  // x's upper 16 bits are its bf16.
  auto widen = [&](int st) {
    const int8_t* ks8 = stage8 + 2 * st * kTileElems;
#pragma unroll
    for (int i = 0; i < kTileK / kStep; ++i) {
      const int r = r0 + i * kStep;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const uint2 wv = *reinterpret_cast<const uint2*>(
            ks8 + x * kTileElems + r * DP + c * 8);
        const unsigned half[2] = {wv.x ^ 0x80808080u, wv.y ^ 0x80808080u};
        unsigned f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          f[e] = __float_as_uint(
              __uint_as_float(__byte_perm(half[e / 4], 0x4B000000u,
                                          0x7540u + e % 4)) -
              8388736.f);
        uint4 o;
        o.x = __byte_perm(f[0], f[1], 0x7632u);
        o.y = __byte_perm(f[2], f[3], 0x7632u);
        o.z = __byte_perm(f[4], f[5], 0x7632u);
        o.w = __byte_perm(f[6], f[7], 0x7632u);
        *reinterpret_cast<uint4*>(kv0 + x * kTileElems + tc::swz<DP>(r, c)) =
            o;
      }
    }
  };

  // the first kStages - 1 k tiles in flight, one commit group each (empty
  // past kt1, so that the waits count groups alike)
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (kt0 + i < kt1) issue(kt0 + i, i);
    tc::cp_async_commit();
  }

  // A narrow tile (at most 16 M rows: a decode row, a short verify chunk)
  // is shared by the 4 warps along its columns, warp w taking columns
  // 16w .. 16w + 15 of every k tile for rows 0-15, and their softmax
  // states are merged at the end; a wide one gives warp w rows 16w ..
  // 16w + 15 and all 64 columns.
  const bool narrow = m_rows <= 16;
  // this thread's two rows (fragment rows lane/4 and lane/4 + 8) and the
  // columns each keeps, col < its own limit; a row without a query keeps
  // the tile's lim
  const int row_a = (narrow ? 0 : warp * 16) + lane / 4;
  const int row_b = row_a + 8;
  const bool on_a = row_a < m_rows;
  const bool on_b = row_b < m_rows;
  const int lim_a = on_a ? w.row_lim(row_a) : lim;
  const int lim_b = on_b ? w.row_lim(row_b) : lim;
  // a warp whose rows hold no query skips its products; a k tile below
  // every limit of the warp's rows needs no mask
  const bool warp_on = row_a - lane / 4 < m_rows;
  int warp_lim = min(lim_a, lim_b);
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
    warp_lim = min(warp_lim, __shfl_xor_sync(0xffffffffu, warp_lim, o));
  const int col_in = 2 * (lane % 4);  // first of its two columns per 8
  const float sl2 = a.scale * tc::kLog2e;

  // Q as m16n8k16 A fragments, straight from q (read once a block):
  // registers 0/2 row a, 1/3 row b; columns 16t + col_in (+ 8)
  unsigned qf[KS][4];
  {
    const __nv_bfloat16* qa = w.q_row(row_a);
    const __nv_bfloat16* qb = w.q_row(row_b);
#pragma unroll
    for (int t = 0; t < KS; ++t) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int d = 16 * t + 8 * x + col_in;
        qf[t][2 * x] = on_a && d < D
                           ? *reinterpret_cast<const unsigned*>(qa + d)
                           : 0u;
        qf[t][2 * x + 1] = on_b && d < D
                               ? *reinterpret_cast<const unsigned*>(qb + d)
                               : 0u;
      }
    }
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // One k tile for this warp: columns c0 .. c0 + 8 NJ - 1 of the tile in
  // stage `st` (NJ = 8 on a wide tile, 2 on a narrow one, where c0 = 16w).
  auto tile_step = [&](auto nj_tag, int st, int k0) {
    constexpr int NJ = decltype(nj_tag)::value;
    const int c0 = NJ == 8 ? 0 : warp * 8 * NJ;
    const __nv_bfloat16* ks = kv0 + (kQuant ? 0 : 2 * st * kTileElems);
    const __nv_bfloat16* vs = ks + kTileElems;
    const float* ksc = scales + 2 * st * kTileK;
    const float* vsc = ksc + kTileK;

    // S = Q K^T: NJ blocks of 8 columns, C fragments
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int t = 0; t < KS; ++t) {
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        unsigned bk[4];
        tc::ldsm_x4(bk, ks + tc::swz<DP>(c0 + jp * 16 + (lane % 8) +
                                             (lane / 16) * 8,
                                         2 * t + (lane / 8) % 2));
        tc::mma_bf16(s[2 * jp], qf[t], bk[0], bk[1]);
        tc::mma_bf16(s[2 * jp + 1], qf[t], bk[2], bk[3]);
      }
    }

    // into the log2 domain, int8 columns times their K scale; mask the
    // columns past each row's limit on a tile that reaches one
    const bool full = k0 + kTileK <= warp_lim;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = c0 + 8 * j + col_in + e;
        const float f = kQuant ? sl2 * ksc[cc] : sl2;
        s[j][e] *= f;
        s[j][2 + e] *= f;
        if (!full) {
          if (k0 + cc >= lim_a) s[j][e] = -INFINITY;
          if (k0 + cc >= lim_b) s[j][2 + e] = -INFINITY;
        }
      }
    }

    // online softmax: row maxima over the quad, rescale, exponentiate
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
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
      const float alpha = tc::fast_exp2(m[r] - mu[r]);
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }
    // P = exp2(S - m) into s; l takes P, then int8 columns times their
    // V scale, so PV multiplies the int8 values exactly
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = tc::fast_exp2(s[j][e] - mu[e / 2]);
        l[e / 2] += s[j][e];
        if (kQuant) s[j][e] *= vsc[c0 + 8 * j + col_in + e % 2];
      }
    }

    // O += P V, 16 keys at a time, P as bf16 hi + lo
#pragma unroll
    for (int t = 0; t < NJ / 2; ++t) {
      unsigned hi_f[4], lo_f[4];
      tc::split_a(s[2 * t], s[2 * t + 1], hi_f, lo_f);
      tc::mma_rows<DP>(acc, hi_f, lo_f, vs, c0 + 16 * t);
    }
  };

  for (int kt = kt0, st = 0; kt < kt1;
       ++kt, st = st == kStages - 1 ? 0 : st + 1) {
    tc::cp_async_wait<kStages - 2>();
    // tile kt has landed for every thread, and every warp is done with
    // tile kt - 1, whose stage the copies of tile kt + kStages - 1 refill
    // while this one computes
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < kt1) issue(nxt, st == 0 ? kStages - 1 : st - 1);
    tc::cp_async_commit();
    if constexpr (kQuant) {
      widen(st);
      __syncthreads();
    }
    if (narrow)
      tile_step(std::integral_constant<int, 2>(), st, kt * kTileK);
    else if (warp_on)
      tile_step(std::integral_constant<int, 8>(), st, kt * kTileK);
  }

  // l over the quad
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (narrow) {
    // warps 1-3 hand their states to warp 0 through the ring's memory
    // (every copy has landed and every warp is past its last read):
    // fragment order, lane fastest, so each store and load is one pass
    float4* part = reinterpret_cast<float4*>(smem);
    float4* stats = part + 3 * NB * 32;
    __syncthreads();
    if (warp > 0) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        part[((warp - 1) * NB + j) * 32 + lane] =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      stats[(warp - 1) * 32 + lane] = make_float4(m[0], m[1], l[0], l[1]);
    }
    __syncthreads();
    if (warp > 0) return;
    float sc[4][2];  // each warp's factor exp2(m_w - max_w m_w) per row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mw[4] = {m[r], 0.f, 0.f, 0.f};
      float lw[4] = {l[r], 0.f, 0.f, 0.f};
#pragma unroll
      for (int wi = 1; wi < 4; ++wi) {
        const float4 sw = stats[(wi - 1) * 32 + lane];
        mw[wi] = r == 0 ? sw.x : sw.y;
        lw[wi] = r == 0 ? sw.z : sw.w;
      }
      // a warp whose columns a row never kept has m = -inf: factor 0
      const float mm = fmaxf(fmaxf(mw[0], mw[1]), fmaxf(mw[2], mw[3]));
      const float mu = mm == -INFINITY ? 0.f : mm;
      m[r] = mm;
      l[r] = 0.f;
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        sc[wi][r] = tc::fast_exp2(mw[wi] - mu);
        l[r] += lw[wi] * sc[wi][r];
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= sc[0][e / 2];
#pragma unroll
      for (int wi = 1; wi < 4; ++wi) {
        const float4 pw = part[((wi - 1) * NB + j) * 32 + lane];
        acc[j][0] += pw.x * sc[wi][0];
        acc[j][1] += pw.y * sc[wi][0];
        acc[j][2] += pw.z * sc[wi][1];
        acc[j][3] += pw.w * sc[wi][1];
      }
    }
  }
  // O (relative to exp2 of m, the row's largest score in the log2
  // domain, or -inf with O = l = 0 for a row that kept no column) and l
  // of rows row_a and row_a + 8, columns 8j + col_in (+ 1)
  w.finish(acc, m, l, row_a, col_in);
}

}  // namespace paged_tc_sm90
