"""Varlen (packed) attention forward (counterpart of
`paddle_tpu/ops/varlen_attention.py`, forward only).

Sequences are packed back to back along one token axis and told apart
by segment ids: a (query, key) pair counts where `seg_q == seg_k`, and
under causal masking also where `rev_pos(seg_k) >= rev_pos(seg_q)`
(the distance to the segment's end: bottom-right alignment, so a
segment with more keys than queries is aligned at its end). Padding
carries negative ids, remapped to -1 on the query side and -2 on the
key side so that pads never match pads. A row that sees nothing gets
o = 0 and lse = -1e30.

Two implementations of one function:

  * `varlen_fwd_reference` — plain PyTorch, dense and in fp32, one KV
    head's query group at a time: what the TPU kernel `_vfwd_kernel`
    computes, (o, lse) in the packed GQA layout. The CPU tests hold it
    to the JAX package, and `chip_smoke.py` holds the kernel to it on
    the card;
  * the Hopper kernel of `csrc/varlen_attention.cu` (`va_fwd`), for
    CUDA tensors.

`flash_attention_varlen` dispatches on q's device: the plain version
for a CPU tensor, the kernel for a CUDA tensor, an error for anything
else; there is no fallback. `launches_fwd` counts kernel launches (only
those). The port serves only: the varlen backward kernels (Queue 2 rows
10-11) are not ported, so a CUDA call that autograd would have to
differentiate raises NotImplementedError rather than detach. The
Paddle-shaped `flash_attn_unpadded` waits with them.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["rev_pos", "seg_ids_from_cu_seqlens", "varlen_reference",
           "varlen_fwd_reference", "flash_attention_varlen",
           "launches_fwd"]

NEG_INF = -1e30

#: kernel launches since import (reset by callers that count a run)
launches_fwd = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
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
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.va_error_string.argtypes = [ci]
        lib.va_error_string.restype = ctypes.c_char_p
        lib.va_smem_bytes.argtypes = [ci, ci]
        lib.va_smem_bytes.restype = ctypes.c_size_t
        # pointers, strides and the stream as 64-bit types: a bare Python
        # int would be passed as a 32-bit int and cut
        lib.va_fwd.argtypes = ([vp] * 10 + [ci] * 5 + [cl] * 6
                               + [ctypes.c_float, ci, ci, ci, vp, vp])
        lib.va_fwd.restype = ci
        _LIB.append(lib)
    return _LIB[0]


def _launch_fwd(q, k, v, seg_q, seg_k, causal, scale, same_offsets,
                count_tiles=False):
    """Launch `va_fwd` on CUDA operands (sentinels already applied).
    Returns (o (Tq, H, D), lse (H, Tq)), and with `count_tiles` also the
    number of (64-row q tile, 64-column k tile, head) triples the kernel
    computed rather than skipped."""
    global launches_fwd
    _check(q.dim() == 3 and k.dim() == 3,
           f"q {tuple(q.shape)} must be (Tq, H, D) and k {tuple(k.shape)} "
           "(Tk, KVH, D)")
    tq, hq, d = q.shape
    tk, hk, dk = k.shape
    _check(tuple(v.shape) == (tk, hk, dk),
           f"v {tuple(v.shape)} must equal k's shape {(tk, hk, dk)}")
    _check(dk == d, f"head_dim of q ({d}) and k ({dk}) differ")
    _check(1 <= d <= _MAX_HEAD_DIM, f"head_dim {d} outside 1..{_MAX_HEAD_DIM}")
    _check(hk >= 1 and hq % hk == 0,
           f"q heads ({hq}) not a multiple of KV heads ({hk})")
    _check(1 <= hq <= 65535, f"heads {hq} outside 1..65535")
    _check(tq >= 1 and tk >= 1, "empty token axis")
    _check(q.dtype in _DTYPE_CODE, f"dtype {q.dtype} not float32/bfloat16")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           f"q, k, v dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.stride(2) == 1, f"{name}'s head_dim must be contiguous")
    for name, s, n in (("seg_q", seg_q, tq), ("seg_k", seg_k, tk)):
        _check(s.dtype == torch.int32 and tuple(s.shape) == (n,),
               f"{name} must be int32 ({n},)")
    for t in (k, v, seg_q, seg_k):
        _check(t.device == q.device, f"operand on {t.device}, q on {q.device}")
    lib = _lib()
    n_qt, n_kt = -(-tq // 64), -(-tk // 64)
    smem = lib.va_smem_bytes(n_kt, d)
    _check(smem <= _MAX_SMEM,
           f"{tk} keys need {smem} bytes of shared memory, more than a "
           f"block has ({_MAX_SMEM})")
    seg_q, seg_k = seg_q.contiguous(), seg_k.contiguous()
    pos_q, pos_k = rev_pos(seg_q), rev_pos(seg_k)
    o = torch.empty((tq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((hq, tq), dtype=torch.float32, device=q.device)
    ranges = torch.empty((n_qt + n_kt, 2), dtype=torch.int32, device=q.device)
    tiles = torch.zeros((1,), dtype=torch.int32, device=q.device) \
        if count_tiles else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.va_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(),
            seg_k.data_ptr(), pos_q.data_ptr(), pos_k.data_ptr(),
            ranges.data_ptr(), o.data_ptr(), lse.data_ptr(),
            tq, tk, hq, hk, d, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), scale, int(causal),
            int(same_offsets), _DTYPE_CODE[q.dtype],
            None if tiles is None else tiles.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            "flash_attention_varlen: kernel launch failed: "
            f"{lib.va_error_string(rc).decode()} (cuda error {rc})")
    launches_fwd += 1
    if count_tiles:
        return o, lse, int(tiles.item())
    return o, lse


def flash_attention_varlen(q, k, v, seg_q, seg_k, causal=False,
                           sm_scale=None, same_offsets=None):
    """Packed-layout attention with segment-id masking.

    q: (Tq, H, D); k/v: (Tk, KVH, D), H a multiple of KVH; seg ids
    (Tq,)/(Tk,) integers, tokens of one sequence sharing an id, real ids
    non-decreasing and padding (any negative id) trailing. Causal
    masking is bottom-right aligned per segment. `same_offsets=True`
    (by default when seg_q is seg_k) says that query and key token i
    sit at the same place, which lets the kernel skip tiles above the
    diagonal. Returns (Tq, H, D) in q's dtype.

    A CPU q runs the plain version. A CUDA q launches the Hopper kernel,
    which takes float32 or bfloat16 with head_dim up to 128, the head
    dim contiguous (other strides are read as they are), and raises on
    anything else, and on operands that need a gradient."""
    d = q.shape[-1]
    scale = float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(d))
    if same_offsets is None:
        same_offsets = seg_q is seg_k
    seg_q, seg_k = _sentinels(seg_q, seg_k)
    if q.device.type == "cpu":
        return varlen_fwd_reference(q, k, v, seg_q, seg_k, causal, scale)[0]
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention_varlen: no implementation for device "
            f"{q.device}; use a CUDA or a CPU tensor")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "paddle_tpu_torch: the backward of flash_attention_varlen (the "
            "varlen dQ and dK/dV kernels) is not ported yet (ROADMAP.md, "
            "Queue 1 item 9c); call it under torch.no_grad() or on "
            "tensors that need no gradient")
    return _launch_fwd(q, k, v, seg_q, seg_k, causal, scale,
                       bool(same_offsets))[0]
