"""Varlen (packed) attention (counterpart of
`paddle_tpu/ops/varlen_attention.py`).

Sequences are packed back to back along one token axis and told apart
by segment ids: a (query, key) pair counts where `seg_q == seg_k`, and
under causal masking also where `rev_pos(seg_k) >= rev_pos(seg_q)`
(the distance to the segment's end: bottom-right alignment, so a
segment with more keys than queries is aligned at its end). Padding
carries negative ids, remapped to -1 on the query side and -2 on the
key side so that pads never match pads. A row that sees nothing gets
o = 0 and lse = -1e30, and gradients of 0.

Two implementations of each of the three kernels, in the packed GQA
layout (q and dO (Tq, H, D); k and v (Tk, KVH, D); lse and delta
(H, Tq)):

  * the plain PyTorch versions `varlen_fwd_reference`,
    `varlen_bwd_dq_reference` and `varlen_bwd_dkv_reference`: dense and
    in fp32, one KV head's query group at a time, computing what the TPU
    kernels `_vfwd_kernel`, `_vbwd_dq_kernel` and `_vbwd_dkv_kernel`
    compute (P = exp(S*scale - lse), dS = P (dP - delta) scale, ...),
    not autograd of a reference. The CPU tests hold them to the JAX
    package, and `chip_smoke.py` holds the kernels to them on the card;
  * the Hopper kernels of `csrc/varlen_attention.cu` (`va_fwd`,
    `va_bwd_dq`, `va_bwd_dkv`), for CUDA tensors. dK and dV are the sums
    over each KV head's query group (JAX computes them per repeated head
    and sums them through `jnp.repeat`'s transpose). The bf16 kernels
    run on the tensor cores (`csrc/attn_fwd_sm90.cuh`,
    `csrc/attn_bwd_sm90.cuh`); their operands are padded to a head dim
    that is a multiple of 8, or copied where a base or a stride does not
    suit their 16-byte copies (`flash_attention.tensor_core_operands`).
    `tile_plan` is the plain twin of their tile rule (skip, mask, or
    keep whole) and `dkv_walk` of the dK/dV kernel's walk over it by
    columns. Every launch first computes the segment distances
    (`rev_pos`) on the card (`va_positions`, one kernel).

`flash_attention_varlen` runs them under a `torch.autograd.Function`
whose forward saves (q, k, v, o, lse) and the segment ids and whose
backward computes delta = rowsum(dO * O) in plain torch and then dQ and
dK/dV. Each dispatches on q's device: the plain version for a CPU
tensor, the kernel for a CUDA tensor, an error for anything else; there
is no fallback. `launches_fwd`, `launches_dq` and `launches_dkv` count
kernel launches (only those). `flash_attn_unpadded` is the Paddle-shaped
entry over cu_seqlens; its dropout branch waits for the key stream of
the API surface (ROADMAP.md, Queue 1 item 13).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .flash_attention import tensor_core_operands

__all__ = ["rev_pos", "seg_ids_from_cu_seqlens", "varlen_reference",
           "varlen_fwd_reference", "varlen_bwd_dq_reference",
           "varlen_bwd_dkv_reference", "flash_attention_varlen",
           "flash_attn_unpadded", "tile_plan", "dkv_walk", "launches_fwd",
           "launches_dq", "launches_dkv"]

NEG_INF = -1e30
TILE = 64                     # tokens of a q tile and of a k tile
SKIP, PARTIAL, FULL = 0, 1, 2  # what `tile_plan` decides for a tile

#: kernel launches since import (reset by callers that count a run)
launches_fwd = 0
launches_dq = 0
launches_dkv = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
_MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use


def rev_pos(seg):
    """Per-token distance from its segment's end (monotone seg ids):
    r[i] = (index one past the segment end) - i. Negative ids (padding,
    always trailing) are remapped to a large value before the search so
    that the array stays monotone."""
    seg = seg.to(torch.int64)
    mono = torch.where(seg < 0, 2 ** 31 - 1, seg).contiguous()
    ends = torch.searchsorted(mono, mono, right=True)
    idx = torch.arange(seg.shape[0], dtype=torch.int64, device=seg.device)
    return (ends - idx).to(torch.int32)


def seg_ids_from_cu_seqlens(cu_seqlens, total):
    """cu_seqlens: (B+1,) prefix sums -> (total,) int32 segment ids;
    tokens past cu_seqlens[-1] get -1."""
    cu = cu_seqlens.to(torch.int64)
    pos = torch.arange(total, dtype=torch.int64, device=cu.device)
    seg = torch.searchsorted(cu[1:].contiguous(), pos, right=True)
    return torch.where(pos < cu[-1], seg, -1).to(torch.int32)


def _sentinels(seg_q, seg_k):
    """Any negative id is padding: -1 on the query side, -2 on the key
    side, so that a pad row never attends a pad key."""
    seg_q = torch.where(seg_q < 0, -1, seg_q).to(torch.int32)
    seg_k = torch.where(seg_k < 0, -2, seg_k).to(torch.int32)
    return seg_q, seg_k


def _visible(seg_q, seg_k, causal):
    valid = seg_q[:, None] == seg_k[None, :]
    if causal:
        valid = valid & (rev_pos(seg_k)[None, :] >= rev_pos(seg_q)[:, None])
    return valid


def _tile_ids(seg, n_t):
    """Per 64-token tile of a sentinel id vector: (lo, hi) of its
    non-negative ids (an empty tile: lo > hi, hi = -1) and its one id
    where all 64 tokens lie inside and share one non-negative id, else -1
    (`tile_ranges_kernel`)."""
    s = torch.cat([seg.long(), seg.new_full((n_t * TILE - seg.numel(),),
                                            -1).long()]).reshape(n_t, TILE)
    real = s >= 0
    lo = torch.where(real, s, 2 ** 31 - 1).amin(1)
    hi = torch.where(real, s, -1).amax(1)
    return lo, hi, torch.where(real.all(1) & (lo == hi), lo, -1)


def tile_plan(seg_q, seg_k, causal, same_offsets):
    """The bf16 kernels' tile rule, in plain torch: for every (64-row q
    tile, 64-column k tile) whether the kernels skip it unloaded
    (SKIP), mask it pair by pair (PARTIAL) or keep every pair (FULL).
    Shape (n_qt, n_kt); every query head has this plan. The ids are as
    `flash_attention_varlen` takes them (any negative id is padding).

    A tile is skipped when the [min, max] of the non-negative ids of its
    rows and of its columns are empty or disjoint, or, with causal masking
    and same offsets, when it lies above the diagonal. It is full when
    both tiles lie wholly inside one and the same segment (no pad, no
    token past either axis) and, with causal masking, the offsets are the
    same and the k tile lies wholly before the q tile."""
    seg_q, seg_k = _sentinels(seg_q, seg_k)
    n_qt, n_kt = -(-seg_q.numel() // TILE), -(-seg_k.numel() // TILE)
    q_lo, q_hi, q_one = (x[:, None] for x in _tile_ids(seg_q, n_qt))
    k_lo, k_hi, k_one = (x[None, :] for x in _tile_ids(seg_k, n_kt))
    qt = torch.arange(n_qt, device=seg_q.device)[:, None]
    kt = torch.arange(n_kt, device=seg_q.device)[None, :]
    need = (q_hi >= 0) & (k_hi >= 0) & (k_lo <= q_hi) & (k_hi >= q_lo)
    full = (q_one >= 0) & (k_one == q_one)
    if causal:
        full = full & (kt < qt) & bool(same_offsets)
        if same_offsets:
            need = need & (kt <= qt)
    return torch.where(need, torch.where(full, FULL, PARTIAL), SKIP)


def dkv_walk(seg_q, seg_k, causal, same_offsets):
    """The bf16 dK/dV kernel's walk, in plain torch, one k tile at a
    time as `VarlenPolicy`'s k-major methods decide it: (begin, end,
    plan). Each 64-column k tile visits the q tiles [begin, end)
    (`q_begin`, `q_end`: from its own tile under causal masking with
    same offsets, else from 0; none when it holds no real key), skips
    those whose id range misses its own (`needed_q`), and keeps whole
    those wholly inside its one segment, under causal masking only with
    same offsets and below the diagonal (`full_q`). `plan` is
    (n_kt, n_qt), SKIP outside [begin, end); it equals
    `tile_plan(...).T`, the same rule read by rows."""
    seg_q, seg_k = _sentinels(seg_q, seg_k)
    n_qt, n_kt = -(-seg_q.numel() // TILE), -(-seg_k.numel() // TILE)
    q_lo, q_hi, q_one = (x[None, :] for x in _tile_ids(seg_q, n_qt))
    k_lo, k_hi, k_one = _tile_ids(seg_k, n_kt)
    kt = torch.arange(n_kt, device=seg_k.device)
    qt = torch.arange(n_qt, device=seg_k.device)[None, :]
    begin = kt if causal and same_offsets else torch.zeros_like(kt)
    end = torch.where(k_hi < 0, 0, n_qt)
    kt, k_lo, k_hi, k_one = (x[:, None] for x in (kt, k_lo, k_hi, k_one))
    walk = (qt >= begin[:, None]) & (qt < end[:, None])
    need = walk & (q_hi >= 0) & (q_lo <= k_hi) & (q_hi >= k_lo)
    full = (k_one >= 0) & (q_one == k_one)
    if causal:
        full = full & bool(same_offsets) & (kt < qt)
    return begin, end, torch.where(need, torch.where(full, FULL, PARTIAL),
                                   SKIP)


def varlen_reference(q, k, v, seg_q, seg_k, causal, scale):
    """The JAX package's reference: q (H, Tq, D), k/v (H, Tk, D), seg
    ids (Tq,)/(Tk,) as given. Returns (out (H, Tq, D) in q's dtype,
    lse (H, Tq) fp32)."""
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * scale
    valid = _visible(seg_q, seg_k, causal)
    s = torch.where(valid[None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.where(valid[None], torch.exp(s - m), 0.0)
    l = e.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("hqk,hkd->hqd", e / l_safe, v.float())
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def varlen_fwd_reference(q, k, v, seg_q, seg_k, causal, scale):
    """Plain version of the forward kernel, in its layout: q (Tq, H, D),
    k/v (Tk, KVH, D) with H a multiple of KVH (query head h reads KV
    head h // (H / KVH)), seg ids (Tq,)/(Tk,). Returns (o (Tq, H, D) in
    q's dtype, lse (H, Tq) fp32). Dense fp32 over one KV head's query
    group at a time; fully masked rows give o = 0 and lse = -1e30."""
    tq, hq, d = q.shape
    hk = k.shape[1]
    group = hq // hk
    seg_q, seg_k = _sentinels(seg_q, seg_k)
    valid = _visible(seg_q, seg_k, causal)
    o = torch.empty_like(q)
    lse = torch.empty((hq, tq), dtype=torch.float32, device=q.device)
    for h in range(hk):
        heads = slice(h * group, (h + 1) * group)
        qh = q[:, heads].transpose(0, 1).float()           # (group, Tq, D)
        s = (qh @ k[:, h].float().T) * scale
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), 0.0)
        l = p.sum(-1, keepdim=True)
        l = torch.where(l == 0.0, 1.0, l)
        o[:, heads] = ((p @ v[:, h].float()) / l).transpose(0, 1).to(q.dtype)
        lse[heads] = (m + torch.log(l))[..., 0]
    return o, lse


def _group_dp_ds(q, k, v, do, lse, delta, valid, h, group, scale):
    """(P, dS, q and dO of the group) for KV head h: P = exp(S*scale -
    lse) and dS = P (dO V^T - delta) scale, each (group, Tq, Tk) fp32,
    0 wherever `valid` is not (P is masked itself: lse is -1e30 on a
    row that sees nothing)."""
    heads = slice(h * group, (h + 1) * group)
    qh = q[:, heads].transpose(0, 1).float()               # (group, Tq, D)
    doh = do[:, heads].transpose(0, 1).float()
    s = (qh @ k[:, h].float().T) * scale
    p = torch.where(valid, torch.exp(s - lse[heads, :, None]), 0.0)
    dp = doh @ v[:, h].float().T
    ds = torch.where(valid, p * (dp - delta[heads, :, None]) * scale, 0.0)
    return p, ds, qh, doh


def varlen_bwd_dq_reference(q, k, v, do, lse, delta, seg_q, seg_k, causal,
                            scale):
    """Plain version of the dQ kernel: q, dO (Tq, H, D); k, v (Tk, KVH,
    D); lse, delta (H, Tq) fp32; seg ids (Tq,)/(Tk,). Returns dQ = dS K
    (Tq, H, D) in q's dtype."""
    hq, hk = q.shape[1], k.shape[1]
    group = hq // hk
    valid = _visible(*_sentinels(seg_q, seg_k), causal)
    dq = torch.empty_like(q)
    for h in range(hk):
        _, ds, _, _ = _group_dp_ds(q, k, v, do, lse, delta, valid, h, group,
                                   scale)
        dq[:, h * group:(h + 1) * group] = (
            ds @ k[:, h].float()).transpose(0, 1).to(q.dtype)
    return dq


def varlen_bwd_dkv_reference(q, k, v, do, lse, delta, seg_q, seg_k, causal,
                             scale):
    """Plain version of the dK/dV kernel, operands as for
    `varlen_bwd_dq_reference`. Returns (dK = dS^T Q, dV = P^T dO), each
    (Tk, KVH, D), summed over the KV head's query group in fp32 and cast
    once to k's and v's dtypes."""
    hq, hk = q.shape[1], k.shape[1]
    group = hq // hk
    valid = _visible(*_sentinels(seg_q, seg_k), causal)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    for h in range(hk):
        p, ds, qh, doh = _group_dp_ds(q, k, v, do, lse, delta, valid, h,
                                      group, scale)
        dk[:, h] = (ds.transpose(-1, -2) @ qh).sum(0)
        dv[:, h] = (p.transpose(-1, -2) @ doh).sum(0)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernel
def _check(cond, msg):
    if not cond:
        raise ValueError(f"flash_attention_varlen: {msg}")


_LIB = []


def _lib():
    """The kernel library, built at first use, with its C signatures."""
    if not _LIB:
        from ..kernels import _build
        lib = _build.load("varlen_attention")
        vp, ci, cl, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
        lib.va_error_string.argtypes = [ci]
        lib.va_error_string.restype = ctypes.c_char_p
        lib.va_smem_bytes.argtypes = [ci, ci, ci]
        lib.va_smem_bytes.restype = ctypes.c_size_t
        lib.va_positions.argtypes = [vp, vp, ci, ci, vp, vp, vp]
        # pointers, strides and the stream as 64-bit types: a bare Python
        # int would be passed as a 32-bit int and cut
        lib.va_fwd.argtypes = ([vp] * 10 + [ci] * 5 + [cl] * 6
                               + [cf, ci, ci, ci, vp, vp])
        bwd_tail = [ci] * 5 + [cl] * 8 + [cf, ci, ci, ci, vp, vp]
        lib.va_bwd_dq.argtypes = [vp] * 12 + bwd_tail
        lib.va_bwd_dkv.argtypes = [vp] * 13 + bwd_tail
        for fn in (lib.va_positions, lib.va_fwd, lib.va_bwd_dq,
                   lib.va_bwd_dkv):
            fn.restype = ci
        _LIB.append(lib)
    return _LIB[0]


def _check_operands(q, k, v, seg_q, seg_k, do=None, lse=None, delta=None):
    """Raise on anything the kernels do not take; returns (Tq, Tk, H,
    KVH, D)."""
    _check(q.dim() == 3 and k.dim() == 3,
           f"q {tuple(q.shape)} must be (Tq, H, D) and k {tuple(k.shape)} "
           "(Tk, KVH, D)")
    tq, hq, d = q.shape
    tk, hk, dk = k.shape
    _check(tuple(v.shape) == (tk, hk, dk),
           f"v {tuple(v.shape)} must equal k's shape {(tk, hk, dk)}")
    _check(dk == d, f"head_dim of q ({d}) and k ({dk}) differ")
    _check(1 <= d <= _MAX_HEAD_DIM,
           f"head_dim {d} outside 1..{_MAX_HEAD_DIM}: the card's attention "
           "kernels stop at 256 (ROADMAP.md, Queue 3)")
    _check(hk >= 1 and hq % hk == 0,
           f"q heads ({hq}) not a multiple of KV heads ({hk})")
    _check(1 <= hq <= 65535, f"heads {hq} outside 1..65535")
    _check(tq >= 1 and tk >= 1, "empty token axis")
    _check(q.dtype in _DTYPE_CODE, f"dtype {q.dtype} not float32/bfloat16")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           f"q, k, v dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})")
    operands = [("q", q), ("k", k), ("v", v)]
    if do is not None:
        _check(do.shape == q.shape and do.dtype == q.dtype,
               f"dO ({tuple(do.shape)}, {do.dtype}) must match q's shape "
               f"and dtype ({tuple(q.shape)}, {q.dtype})")
        operands.append(("dO", do))
        for name, t in (("lse", lse), ("delta", delta)):
            _check(t.dtype == torch.float32 and tuple(t.shape) == (hq, tq)
                   and t.is_contiguous(),
                   f"{name} must be contiguous float32 {(hq, tq)}")
    for name, t in operands:
        _check(t.stride(2) == 1, f"{name}'s head_dim must be contiguous")
    for name, s, n in (("seg_q", seg_q, tq), ("seg_k", seg_k, tk)):
        _check(s.dtype == torch.int32 and tuple(s.shape) == (n,),
               f"{name} must be int32 ({n},)")
    for t in (k, v, seg_q, seg_k, do, lse, delta):
        if t is not None:
            _check(t.device == q.device,
                   f"operand on {t.device}, q on {q.device}")
    return tq, tk, hq, hk, d


def _launch(name, kernel, dims, seg_q, seg_k, ins, outs, strides, causal,
            scale, same_offsets, count_tiles):
    """Launch va_<name> on operands `_check_operands` passed (sentinels
    already applied to the segment ids): `kernel` is its shared-memory
    code (0, 1, 2 the fp32 fwd, dq and dkv; 3, 4, 5 the bf16 ones on the
    tensor cores), `dims` what the check
    returned (with the head dim the kernel reads), `ins` the
    operand tensors before the ids (q first), `outs` the tensors it
    writes after the scratch, `strides` the operands' (row, head)
    strides. Returns the tile count when asked, else None."""
    tq, tk, hq, hk, d = dims
    q = ins[0]
    lib = _lib()
    n_qt, n_kt = -(-tq // TILE), -(-tk // TILE)
    n_other = n_qt if kernel == 2 else n_kt
    smem = lib.va_smem_bytes(kernel, n_other, d)
    _check(smem <= _MAX_SMEM,
           f"va_{name}: the ranges of {n_other} "
           f"{'query' if kernel == 2 else 'key'} tiles need {smem} bytes of "
           f"shared memory, more than a block has ({_MAX_SMEM})")
    seg_q, seg_k = seg_q.contiguous(), seg_k.contiguous()
    pos_q, pos_k = torch.empty_like(seg_q), torch.empty_like(seg_k)
    # each tile's id range, then its one id (`tile_ranges_kernel`)
    ranges = torch.empty((3 * (n_qt + n_kt),), dtype=torch.int32,
                         device=q.device)
    tiles = torch.zeros((1,), dtype=torch.int32, device=q.device) \
        if count_tiles else None
    ptrs = [t.data_ptr() for t in (*ins, seg_q, seg_k, pos_q, pos_k, ranges,
                                   *outs)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # pos = rev_pos(seg_q), rev_pos(seg_k), in one launch
        rc = lib.va_positions(seg_q.data_ptr(), seg_k.data_ptr(), tq, tk,
                              pos_q.data_ptr(), pos_k.data_ptr(), stream)
        if rc != 0:
            name = "positions"
        else:
            rc = getattr(lib, f"va_{name}")(
                *ptrs, tq, tk, hq, hk, d, *strides, scale,
                int(causal), int(same_offsets), _DTYPE_CODE[q.dtype],
                None if tiles is None else tiles.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_varlen: va_{name} kernel launch failed: "
            f"{lib.va_error_string(rc).decode()} (cuda error {rc})")
    return int(tiles.item()) if count_tiles else None


def _qkv_strides(q, k, v):
    return [q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1)]


def _launch_fwd(q, k, v, seg_q, seg_k, causal, scale, same_offsets,
                count_tiles=False):
    """Launch `va_fwd` on CUDA operands (sentinels already applied).
    Returns (o (Tq, H, D), lse (H, Tq)), and with `count_tiles` also the
    number of (64-row q tile, 64-column k tile, head) triples the kernel
    computed rather than skipped."""
    global launches_fwd
    tq, tk, hq, hk, d = _check_operands(q, k, v, seg_q, seg_k)
    kernel = 0
    if q.dtype == torch.bfloat16:   # the tensor-core kernel's operands
        q, k, v = tensor_core_operands(q, k, v)
        kernel = 3
    dp = q.shape[-1]
    o = torch.empty((tq, hq, dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((hq, tq), dtype=torch.float32, device=q.device)
    tiles = _launch("fwd", kernel, (tq, tk, hq, hk, dp), seg_q, seg_k,
                    (q, k, v), (o, lse), _qkv_strides(q, k, v), causal,
                    scale, same_offsets, count_tiles)
    launches_fwd += 1
    if dp != d:
        o = o[..., :d].contiguous()
    return (o, lse, tiles) if count_tiles else (o, lse)


def _launch_bwd(name, q, k, v, do, lse, delta, seg_q, seg_k, causal, scale,
                same_offsets, count_tiles):
    """Launch va_bwd_<name> ("dq" or "dkv") on CUDA operands (sentinels
    already applied): bf16 operands go through `tensor_core_operands`
    (the head dim padded to a multiple of 8). Returns the outputs, dQ
    like q or (dK, dV) like k, sliced back to D, and the tile count or
    None."""
    tq, tk, hq, hk, d = _check_operands(q, k, v, seg_q, seg_k, do, lse,
                                        delta)
    kernel = 1 if name == "dq" else 2
    if q.dtype == torch.bfloat16:   # the tensor-core loops' operands
        q, k, v, do = tensor_core_operands(q, k, v, do)
        kernel += 3
    dp = q.shape[-1]
    like = q if name == "dq" else k
    outs = tuple(torch.empty((*like.shape[:2], dp), dtype=like.dtype,
                             device=like.device)
                 for _ in range(1 if name == "dq" else 2))
    tiles = _launch(f"bwd_{name}", kernel, (tq, tk, hq, hk, dp), seg_q, seg_k,
                    (q, k, v, do, lse, delta), outs,
                    _qkv_strides(q, k, v) + [do.stride(0), do.stride(1)],
                    causal, scale, same_offsets, count_tiles)
    if dp != d:
        outs = tuple(t[..., :d].contiguous() for t in outs)
    return outs, tiles


def _launch_bwd_dq(q, k, v, do, lse, delta, seg_q, seg_k, causal, scale,
                   same_offsets, count_tiles=False):
    """Launch `va_bwd_dq` on CUDA operands (sentinels already applied):
    dO like q, lse and delta (H, Tq) fp32. Returns dQ (Tq, H, D) in q's
    dtype, and with `count_tiles` also the (q tile, k tile, query head)
    triples computed."""
    global launches_dq
    (dq,), tiles = _launch_bwd("dq", q, k, v, do, lse, delta, seg_q, seg_k,
                               causal, scale, same_offsets, count_tiles)
    launches_dq += 1
    return (dq, tiles) if count_tiles else dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, seg_q, seg_k, causal, scale,
                    same_offsets, count_tiles=False):
    """Launch `va_bwd_dkv` on CUDA operands, as `_launch_bwd_dq`.
    Returns (dK, dV), each (Tk, KVH, D) in k's dtype and summed over the
    KV head's query group, and with `count_tiles` also the (q tile, k
    tile, query head) triples computed."""
    global launches_dkv
    (dk, dv), tiles = _launch_bwd("dkv", q, k, v, do, lse, delta, seg_q,
                                  seg_k, causal, scale, same_offsets,
                                  count_tiles)
    launches_dkv += 1
    return (dk, dv, tiles) if count_tiles else (dk, dv)


def _on_cpu(t):
    """True for a CPU tensor, False for a CUDA one, ValueError else."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(
            f"flash_attention_varlen: no implementation for device "
            f"{t.device}; use a CUDA or a CPU tensor")
    return False


class _VarlenAttention(torch.autograd.Function):
    """`_varlen_mha` with its custom VJP, over sentinel segment ids.
    Everything the backward needs travels in `ctx`, so a forward run
    again under activation checkpointing stands on its own."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, causal, scale, same_offsets):
        if _on_cpu(q):
            o, lse = varlen_fwd_reference(q, k, v, seg_q, seg_k, causal,
                                          scale)
        else:
            o, lse = _launch_fwd(q, k, v, seg_q, seg_k, causal, scale,
                                 same_offsets)
        ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_k)
        ctx.args = (causal, scale, same_offsets)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse, seg_q, seg_k = ctx.saved_tensors
        causal, scale, same_offsets = ctx.args
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).T.contiguous()   # (H, Tq)
        args = (q, k, v, do, lse, delta, seg_q, seg_k, causal, scale)
        if _on_cpu(q):
            dq = varlen_bwd_dq_reference(*args)
            dk, dv = varlen_bwd_dkv_reference(*args)
        else:
            dq = _launch_bwd_dq(*args, same_offsets)
            dk, dv = _launch_bwd_dkv(*args, same_offsets)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_varlen(q, k, v, seg_q, seg_k, causal=False,
                           sm_scale=None, same_offsets=None):
    """Packed-layout attention with segment-id masking, differentiable
    in q, k and v.

    q: (Tq, H, D); k/v: (Tk, KVH, D), H a multiple of KVH; seg ids
    (Tq,)/(Tk,) integers, tokens of one sequence sharing an id, real ids
    non-decreasing and padding (any negative id) trailing. Causal
    masking is bottom-right aligned per segment. `same_offsets=True`
    (by default when seg_q is seg_k) says that query and key token i
    sit at the same place, which lets the kernels skip tiles above the
    diagonal. Returns (Tq, H, D) in q's dtype.

    A CPU q runs the plain versions. A CUDA q launches the Hopper
    kernels, which take float32 or bfloat16 with head_dim up to 256 and
    the head dim contiguous (other strides are read as they are; the
    bf16 kernels pad a head dim that is not a multiple of 8 and copy
    operands whose base or strides do not suit their 16-byte copies), and
    raise on anything else."""
    d = q.shape[-1]
    scale = float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(d))
    if same_offsets is None:
        same_offsets = seg_q is seg_k
    seg_q, seg_k = _sentinels(seg_q, seg_k)
    return _VarlenAttention.apply(q, k, v, seg_q, seg_k, bool(causal), scale,
                                  bool(same_offsets))


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        training=True, name=None):
    """Paddle's varlen attention
    (python/paddle/nn/functional/flash_attention.py:756), as the JAX
    package's `flash_attn_unpadded`.

    query: (total_q, H, D) packed across the batch; key/value:
    (total_k, KVH, D); cu_seqlens_q/k: (B+1,) token-offset prefix sums
    (tensors, arrays or lists). Returns (out, None): the kernels never
    hold the softmax. `max_seqlen_*`, `return_softmax` and `name` are
    accepted and ignored. Equal cu_seqlens (the same object, or equal
    values) let the kernels skip tiles above the diagonal.

    Dropout while training (dropout > 0 and training) raises
    NotImplementedError: it draws from the API surface's key stream
    (ROADMAP.md, Queue 1 item 13). dropout > 0 with training=False runs
    the kernels, as in the JAX package."""
    if dropout > 0.0 and training:
        raise NotImplementedError(
            "paddle_tpu_torch: attention dropout in flash_attn_unpadded "
            "(training=True) draws from the API surface's key stream, "
            "which is not ported yet (ROADMAP.md, Queue 1 item 13); pass "
            "dropout=0.0 or training=False")
    cu_q = torch.as_tensor(cu_seqlens_q, device=query.device).long()
    cu_k = torch.as_tensor(cu_seqlens_k, device=query.device).long()
    same = cu_seqlens_k is cu_seqlens_q or (
        cu_q.shape == cu_k.shape and bool(torch.equal(cu_q, cu_k)))
    seg_q = seg_ids_from_cu_seqlens(cu_q, query.shape[0])
    seg_k = seg_ids_from_cu_seqlens(cu_k, key.shape[0])
    out = flash_attention_varlen(query, key, value, seg_q, seg_k,
                                 causal=causal, sm_scale=scale,
                                 same_offsets=same)
    return out, None
