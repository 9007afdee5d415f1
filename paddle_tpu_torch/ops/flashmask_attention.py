"""FlashMask attention (counterpart of `paddle_tpu/ops/flashmask_attention.py`).

Sparse attention masks given, per key column, as start/end row indices
(`startend_row_indices`, "sri"), never as a dense (S, S) mask. q, k, v
are (B, H, S, D) with equal head counts (the caller repeats GQA K/V
heads); sri is (B, Hs, S_k, n) int32 with Hs equal to 1 (one mask for
every head) or H. With n = trailing dim, a pair (row r, column j) is
masked when

    causal,  n=1:  r >= start_j
    causal,  n=2:  start_j <= r < end_j
    ~causal, n=2:  r >= start_j  or  r < end_j
    ~causal, n=4:  s0_j <= r < e0_j  or  s1_j <= r < e1_j

on top of the causal triangle (top-left: row i sees columns <= i, as the
reference masks, so sq != sk has one meaning) and an optional sliding
window (left, right). Dropout drops the normalized probabilities with a
counter-based murmur hash of the absolute (row, col, b*H + h, seed)
coordinates (`dropout_keep_mask`), bit-equal to the JAX package's, so
the forward and both backward kernels regenerate the same mask.

Two implementations of each of the three kernels:

  * the plain PyTorch versions `flashmask_fwd_reference`,
    `flashmask_bwd_dq_reference` and `flashmask_bwd_dkv_reference`:
    dense, in fp32, computing what the TPU kernels compute (lse from the
    undropped P, O from the dropped P, dP masked and scaled by the
    dropout mask before dS = P (dP - delta) scale), not autograd of
    `flashmask_reference`. The CPU tests hold them to the JAX package,
    and `chip_smoke.py` holds the kernels to them on the card;
  * the Hopper kernels of `csrc/flashmask_attention.cu`, for CUDA
    tensors. They read sri in place and skip every (q tile, k tile)
    whose pairs are all masked before loading Q, K or V. The bf16
    forward runs on the tensor cores (`csrc/attn_fwd_sm90.cuh`), after a
    small kernel has reduced sri per 64-column tile (`tile_plan` is its
    plain twin); its operands go through `tensor_core_operands` as in
    `ops/flash_attention.py`. Everything else runs on fp32 CUDA cores.

`flashmask_attention_bhsd` runs them under a `torch.autograd.Function`
whose forward saves (q, k, v, sri, o, lse) and whose backward computes
delta = rowsum(dO * O) in plain torch and then dQ and dK/dV. Each
dispatches on q's device: the plain version for a CPU tensor, the kernel
for a CUDA tensor, an error for anything else; there is no fallback. The
launch counters `launches_fwd`, `launches_dq` and `launches_dkv` count
kernel launches (only those). The TPU tile knobs (`block_q`, `block_k`,
`use_pallas`, `interpret`) do not carry over.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .flash_attention import tensor_core_operands

__all__ = ["dropout_keep_mask", "flashmask_reference",
           "flashmask_fwd_reference", "flashmask_bwd_dq_reference",
           "flashmask_bwd_dkv_reference", "flashmask_attention_bhsd",
           "tile_plan", "launches_fwd", "launches_dq", "launches_dkv"]

NEG_INF = -1e30

#: kernel launches since import (reset by callers that count a run)
launches_fwd = 0
launches_dq = 0
launches_dkv = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_VALID_N = {True: (1, 2), False: (2, 4)}   # causal -> allowed sri widths
_M32 = 0xFFFFFFFF
TILE = 64                     # rows of a q tile and columns of a k tile
SKIP, PARTIAL, FULL = 0, 1, 2  # what `tile_plan` decides for a tile


# ------------------------------------------------------------ dropout mask
def _mul32(x, c):
    """x * c mod 2^32 for int64 x in [0, 2^32) and c < 2^32, split in
    16-bit halves so that no partial product leaves int64 (torch has no
    uint32 arithmetic on the CPU)."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def dropout_threshold(dropout):
    """The uint32 threshold of the keep test (keep <=> hash >= it)."""
    return min(int(float(dropout) * 4294967296.0), 4294967295)


def _inv_keep(dropout):
    """fp32(1 / (1 - rate)): the kernels' scale of a kept probability."""
    return float(np.float32(1.0 / (1.0 - float(dropout))))


def dropout_keep_mask(rows, cols, bh, seed, dropout):
    """Deterministic counter-based dropout keep-mask (True = keep), bit
    for bit `paddle_tpu.ops.flashmask_attention.dropout_keep_mask`: a
    murmur3 finalizer of the absolute (row, col, batch*head, seed)
    coordinates in uint32, computed here in int64 with every product
    and xor cut to 32 bits.

    rows / cols / bh: broadcastable integer tensors or ints; seed: an
    int (its int32 bits); dropout: the rate in [0, 1)."""
    dev = rows.device if torch.is_tensor(rows) else None

    def u32(a):
        return torch.as_tensor(a, device=dev).to(torch.int64) & _M32
    x = (_mul32(u32(rows), 0x9E3779B1) ^ _mul32(u32(cols), 0x85EBCA77)
         ^ _mul32(u32(bh), 0xC2B2AE3D) ^ (int(seed) & _M32))
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= dropout_threshold(dropout)


def _drop_mask(b, h, sq, sk, seed, dropout, device):
    """(B, H, Sq, Sk) keep-mask of the dense versions."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    bh = (torch.arange(b, device=device)[:, None] * h
          + torch.arange(h, device=device)[None, :])[..., None, None]
    return dropout_keep_mask(rows, cols, bh, seed, dropout)


# ------------------------------------------------------------------ masks
def _check_n(causal, n):
    if n not in _VALID_N[bool(causal)]:
        raise ValueError(f"startend_row_indices last dim {n} invalid for "
                         f"causal={causal}")


def _norm_window(window):
    """None, an int (symmetric) or (left, right) -> None or two ints."""
    if window is None:
        return None
    if isinstance(window, (int, np.integer)):
        return int(window), int(window)
    return int(window[0]), int(window[1])


def _sri_masked(rows, sri, causal):
    """rows (Sq, 1); sri (B, Hs, Sk, n) -> (B, Hs, Sq, Sk) bool, the
    pairs the start/end indices mask."""
    n = sri.shape[-1]
    _check_n(causal, n)
    sc = sri.transpose(-1, -2)[:, :, :, None, :]        # (B, Hs, n, 1, Sk)

    def col(i):
        return sc[:, :, i]
    if causal and n == 1:
        return rows >= col(0)
    if causal and n == 2:
        return (rows >= col(0)) & (rows < col(1))
    if n == 2:
        return (rows >= col(0)) | (rows < col(1))
    return (((rows >= col(0)) & (rows < col(1)))
            | ((rows >= col(2)) & (rows < col(3))))


def _keep(sq, sk, sri, causal, window, device):
    """The visible pairs: (Sq, Sk), or (B, Hs, Sq, Sk) with sri."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        keep = keep & (cols <= rows)
    if window is not None:
        keep = keep & (cols >= rows - window[0])
        if not causal:
            keep = keep & (cols <= rows + window[1])
    if sri is not None:
        keep = keep & ~_sri_masked(rows, sri, causal)
    return keep


def tile_plan(sri, sq, sk, causal, window=None):
    """The bf16 forward kernel's tile rule, in plain torch: for every
    (b, sri head, 64-row q tile, 64-column k tile) whether the kernel
    skips it unloaded (SKIP), masks it pair by pair (PARTIAL) or keeps
    every pair (FULL). Shape (B, Hs, n_qt, n_kt), or (1, 1, n_qt, n_kt)
    without sri; every head of a shared (B, 1, S, n) mask has its plan.

    A tile is skipped when the causal triangle or the window hides it, or
    when the max of each start and the min of each end over its columns
    < sk show every pair masked (`_sri_all_masked`). It is full when it
    lies inside the ragged bounds, wholly under the diagonal and inside
    the window, and the min of each start and the max of each end show
    that no interval reaches its rows."""
    window = _norm_window(window)
    dev = sri.device if sri is not None else torch.device("cpu")
    n_qt, n_kt = -(-sq // TILE), -(-sk // TILE)
    q0 = torch.arange(n_qt, device=dev)[:, None] * TILE
    k0 = torch.arange(n_kt, device=dev)[None, :] * TILE
    r1, c1 = (q0 + TILE).clamp(max=sq) - 1, (k0 + TILE).clamp(max=sk) - 1
    rl, cl = q0 + TILE - 1, k0 + TILE - 1
    need = torch.ones((n_qt, n_kt), dtype=torch.bool, device=dev)
    full = (rl < sq) & (cl < sk)
    if causal:
        need = need & (r1 >= k0)
        full = full & (q0 >= cl)
    if window is not None:
        need = need & (c1 >= q0 - window[0])
        full = full & (k0 >= rl - window[0])
        if not causal:
            need = need & (k0 <= r1 + window[1])
            full = full & (cl <= q0 + window[1])
    if sri is None:
        return torch.where(need, torch.where(full, FULL, PARTIAL),
                           SKIP)[None, None]
    _check_n(causal, sri.shape[-1])
    b, hs, _, n = sri.shape
    x = sri[:, :, :sk].long()
    pad = n_kt * TILE - sk

    def reduce(fill, op):     # (B, Hs, n_kt, n) over each tile's columns
        t = torch.cat([x, x.new_full((b, hs, pad, n), fill)], 2)
        return op(t.reshape(b, hs, n_kt, TILE, n), 3)[:, :, None]
    mx = reduce(-(1 << 31), torch.amax)                # (B, Hs, 1, n_kt, n)
    mn = reduce((1 << 31) - 1, torch.amin)

    def below(i):   # every row at or past each start i
        return q0 >= mx[..., i]

    def above(i):   # every row before each end i
        return r1 < mn[..., i]

    def clear(i):   # no interval [start i, end i + 1) reaches a row
        return (rl < mn[..., i]) | (q0 >= mx[..., i + 1])
    if n == 1:
        masked, kept = below(0), rl < mn[..., 0]
    elif n == 2 and causal:
        masked, kept = below(0) & above(1), clear(0)
    elif n == 2:
        masked = below(0) | above(1)
        kept = (rl < mn[..., 0]) & (q0 >= mx[..., 1])
    else:
        masked = (below(0) & above(1)) | (below(2) & above(3))
        kept = clear(0) & clear(2)
    need = need & ~masked
    return torch.where(need, torch.where(full & kept, FULL, PARTIAL), SKIP)


# ------------------------------------------------------------ references
def flashmask_reference(q, k, v, sri=None, causal=True, window=None,
                        sm_scale=None, dropout=0.0, dropout_seed=None):
    """The dense baseline with the JAX signature: q, k, v (B, H, S, D);
    sri (B, Hs, S_k, n). Returns (out in q's dtype, lse fp32 (B, H,
    Sq)). Materializes the dense mask; differentiable by autograd."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    window = _norm_window(window)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    keep = _keep(sq, sk, sri, causal, window, q.device)
    s = torch.where(keep, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    if dropout > 0.0:
        if dropout_seed is None:
            raise ValueError("flashmask dropout requires dropout_seed")
        b, h = p.shape[:2]
        keep_p = _drop_mask(b, h, sq, sk, dropout_seed, dropout, q.device)
        p = torch.where(keep_p, p / (1.0 - dropout), 0.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def _scores(q, k, sri, causal, window, scale):
    """(S * scale in fp32 masked to NEG_INF, the visibility mask)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    keep = _keep(q.shape[-2], k.shape[-2], sri, causal, window, q.device)
    return torch.where(keep, s, NEG_INF), keep


def _dropper(shape, seed, dropout, device):
    """x -> where(keep_drop, x * fp32(1 / (1 - rate)), 0), as the
    kernels drop; the identity without dropout."""
    if dropout <= 0.0:
        return lambda x: x
    keep = _drop_mask(*shape, seed, dropout, device)
    inv = _inv_keep(dropout)
    return lambda x: torch.where(keep, x * inv, 0.0)


def flashmask_fwd_reference(q, k, v, sri, causal, window, scale,
                            dropout=0.0, seed=None):
    """Plain version of the forward kernel: (o in q's dtype, lse fp32
    (B, H, Sq)). lse takes the undropped P, o the dropped one; a row
    with every pair masked gives o = 0 and lse = -1e30."""
    s, keep = _scores(q, k, sri, causal, window, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    drop = _dropper(p.shape, seed, dropout, q.device)
    o = (drop(p) @ v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _p_ds(q, k, v, sri, do, lse, delta, causal, window, scale, dropout,
          seed):
    """(P, the dropout map, dS) of the backward kernels."""
    s, keep = _scores(q, k, sri, causal, window, scale)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    drop = _dropper(p.shape, seed, dropout, q.device)
    dp = drop(do.float() @ v.float().transpose(-1, -2))
    ds = torch.where(keep, p * (dp - delta[..., None]) * scale, 0.0)
    return p, drop, ds


def flashmask_bwd_dq_reference(q, k, v, sri, do, lse, delta, causal,
                               window, scale, dropout=0.0, seed=None):
    """Plain version of the dQ kernel: dQ = dS K, in q's dtype."""
    _, _, ds = _p_ds(q, k, v, sri, do, lse, delta, causal, window, scale,
                     dropout, seed)
    return (ds @ k.float()).to(q.dtype)


def flashmask_bwd_dkv_reference(q, k, v, sri, do, lse, delta, causal,
                                window, scale, dropout=0.0, seed=None):
    """Plain version of the dK/dV kernel: (dS^T Q, dropped(P)^T dO) in
    k's and v's dtypes."""
    p, drop, ds = _p_ds(q, k, v, sri, do, lse, delta, causal, window,
                        scale, dropout, seed)
    dk = ds.transpose(-1, -2) @ q.float()
    dv = drop(p).transpose(-1, -2) @ do.float()
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernels
class _Mask(NamedTuple):
    """What the kernels mask and drop, in the plain versions' order."""
    causal: bool
    window: Optional[Tuple[int, int]]
    scale: float
    dropout: float
    seed: Optional[int]


def _check(cond, msg):
    if not cond:
        raise ValueError(f"flashmask_attention: {msg}")


_LIB = []


def _lib():
    """The kernel library, built at first use, with its C signatures."""
    if not _LIB:
        from ..kernels import _build
        lib = _build.load("flashmask_attention")
        vp, ci, cu, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float)
        lib.fm_error_string.argtypes = [ci]
        lib.fm_error_string.restype = ctypes.c_char_p
        lib.fm_smem_bytes.argtypes = [ci, ci]
        lib.fm_smem_bytes.restype = ctypes.c_size_t
        # pointers and the stream as c_void_p: a bare Python int would
        # be passed as a 32-bit int and cut
        tail = [ci] * 5 + [cf] + [ci] * 7 + [cu, cu, cf, ci, vp]
        lib.fm_fwd.argtypes = [vp] * 8 + tail
        lib.fm_bwd_dq.argtypes = [vp] * 8 + tail
        lib.fm_bwd_dkv.argtypes = [vp] * 9 + tail
        for fn in (lib.fm_fwd, lib.fm_bwd_dq, lib.fm_bwd_dkv):
            fn.restype = ci
        _LIB.append(lib)
    return _LIB[0]


def _check_operands(q, k, v, sri, m, do=None, lse=None, delta=None):
    """Raise on anything the kernels do not take; returns (B, H, sq, sk,
    D)."""
    _check(q.dim() == 4, f"q must be (B, H, S, D), got {tuple(q.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2] if k.dim() == 4 else -1
    for name, t in (("k", k), ("v", v)):
        _check(tuple(t.shape) == (b, h, sk, d),
               f"{name} {tuple(t.shape)} must be (B, H, S_k, D) = "
               f"{(b, h, sk, d)}")
    _check(q.dtype in _DTYPE_CODE,
           f"dtype {q.dtype} not float32/bfloat16")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           f"q, k, v dtypes differ ({q.dtype}, {k.dtype}, {v.dtype})")
    _check(1 <= d <= _MAX_HEAD_DIM, f"head_dim {d} outside 1..{_MAX_HEAD_DIM}")
    _check(sq >= 1 and sk >= 1, "empty sequence")
    _check(1 <= b * h <= 65535, f"batch*heads {b * h} outside 1..65535")
    operands = [q, k, v]
    if sri is not None:
        _check(sri.dtype == torch.int32, f"sri dtype {sri.dtype} not int32")
        _check(sri.dim() == 4 and sri.shape[0] == b and sri.shape[1] in (1, h)
               and sri.shape[2] == sk,
               f"sri {tuple(sri.shape)} must be (B, 1 or H, S_k, n) with "
               f"(B, H, S_k) = {(b, h, sk)}")
        _check_n(m.causal, sri.shape[3])
        operands.append(sri)
    if do is not None:
        _check(do.shape == q.shape and do.dtype == q.dtype,
               "dO must match q's shape and dtype")
        for name, t in (("lse", lse), ("delta", delta)):
            _check(t.dtype == torch.float32 and tuple(t.shape) == (b, h, sq),
                   f"{name} must be float32 {(b, h, sq)}")
        operands += [do, lse, delta]
    for t in operands:
        _check(t.device == q.device, f"operand on {t.device}, q on {q.device}")
        _check(t.is_contiguous(), "every operand must be contiguous")
    return b, h, sq, sk, d


def _run(fn, name, ptrs, q, sk, sri, m):
    b, h, sq, d = q.shape
    win = m.window if m.window is not None else (0, 0)
    # a window wider than any sequence is no window: clamp so that the
    # kernels' int arithmetic cannot overflow
    wl, wr = (max(-(1 << 30), min(x, 1 << 30)) for x in win)
    drop = m.dropout > 0.0
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, b, h, sq, sk, d, m.scale,
                sri.shape[1] if sri is not None else 1,
                sri.shape[3] if sri is not None else 0, int(m.causal),
                int(m.window is not None), wl, wr, int(drop),
                (int(m.seed) & _M32) if drop else 0,
                dropout_threshold(m.dropout) if drop else 0,
                _inv_keep(m.dropout) if drop else 1.0,
                _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"flashmask_attention: {name} kernel launch failed: "
            f"{lib.fm_error_string(rc).decode()} (cuda error {rc})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, sri, m, count_tiles=False):
    """(o, lse), and with `count_tiles` also the number of (q tile, k
    tile, batch*head) triples the kernel computed."""
    global launches_fwd
    b, h, sq, sk, d = _check_operands(q, k, v, sri, m)
    agg = None
    if q.dtype == torch.bfloat16:
        q, k, v = tensor_core_operands(q, k, v)
        if sri is not None:   # the tile aggregates of every sri slice
            agg = torch.empty((b * sri.shape[1] * -(-sk // TILE) * 2
                               * sri.shape[3],), dtype=torch.int32,
                              device=q.device)
    tiles = (torch.zeros((1,), dtype=torch.int32, device=q.device)
             if count_tiles else None)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _run(_lib().fm_fwd, "fwd",
         [_ptr(x) for x in (q, k, v, sri, agg, tiles, o, lse)], q, sk, sri,
         m)
    launches_fwd += 1
    o = o if o.shape[-1] == d else o[..., :d].contiguous()
    return (o, lse, int(tiles.item())) if count_tiles else (o, lse)


def _launch_dq(q, k, v, sri, do, lse, delta, m):
    global launches_dq
    _, _, _, sk, _ = _check_operands(q, k, v, sri, m, do, lse, delta)
    dq = torch.empty_like(q)
    _run(_lib().fm_bwd_dq, "dq",
         [_ptr(x) for x in (q, k, v, sri, do, lse, delta, dq)],
         q, sk, sri, m)
    launches_dq += 1
    return dq


def _launch_dkv(q, k, v, sri, do, lse, delta, m):
    global launches_dkv
    _, _, _, sk, _ = _check_operands(q, k, v, sri, m, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _run(_lib().fm_bwd_dkv, "dkv",
         [_ptr(x) for x in (q, k, v, sri, do, lse, delta, dk, dv)],
         q, sk, sri, m)
    launches_dkv += 1
    return dk, dv


def _on_cpu(t):
    """True for a CPU tensor, False for a CUDA one, ValueError else."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(
            f"flashmask_attention: no implementation for device {t.device}; "
            "use a CUDA or a CPU tensor")
    return False


def _fwd(q, k, v, sri, m):
    if _on_cpu(q):
        return flashmask_fwd_reference(q, k, v, sri, *m)
    return _launch_fwd(q, k, v, sri, m)


def _bwd_dq(q, k, v, sri, do, lse, delta, m):
    if _on_cpu(q):
        return flashmask_bwd_dq_reference(q, k, v, sri, do, lse, delta, *m)
    return _launch_dq(q, k, v, sri, do, lse, delta, m)


def _bwd_dkv(q, k, v, sri, do, lse, delta, m):
    if _on_cpu(q):
        return flashmask_bwd_dkv_reference(q, k, v, sri, do, lse, delta, *m)
    return _launch_dkv(q, k, v, sri, do, lse, delta, m)


class _FlashMask(torch.autograd.Function):
    """`_flashmask` with its custom VJP. Everything the backward needs
    travels in `ctx`, so a forward run again under activation
    checkpointing stands on its own."""

    @staticmethod
    def forward(ctx, q, k, v, sri, m):
        o, lse = _fwd(q, k, v, sri, m)
        ctx.save_for_backward(q, k, v, sri, o, lse)
        ctx.m = m
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, sri, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = _bwd_dq(q, k, v, sri, do, lse, delta, ctx.m)
        dk, dv = _bwd_dkv(q, k, v, sri, do, lse, delta, ctx.m)
        return dq, dk, dv, None, None


def flashmask_attention_bhsd(q, k, v, startend_row_indices=None,
                             causal=True, window=None, sm_scale=None,
                             dropout=0.0, dropout_seed=None):
    """Attention over (B, H, S, D) q, k, v under the FlashMask mask ->
    (B, H, Sq, D) in q's dtype, differentiable in q, k and v.

    startend_row_indices: None or (B, 1 or H, S_k, n) integer indices
    (cast to int32); n must be 1 or 2 when causal, 2 or 4 otherwise
    (ValueError else). window: None, an int or (left, right). dropout:
    the probability-dropout rate, which needs dropout_seed.

    A CPU q runs the plain versions. A CUDA q launches the Hopper
    kernels, which take float32 or bfloat16 with head_dim up to 128 and
    raise on anything else."""
    d = q.shape[-1]
    scale = float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(d))
    dropout = float(dropout)
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"flashmask dropout {dropout} outside [0, 1)")
    if dropout > 0.0 and dropout_seed is None:
        raise ValueError("flashmask dropout requires dropout_seed")
    sri = startend_row_indices
    if sri is not None:
        _check_n(causal, sri.shape[-1])
        sri = sri.to(torch.int32).contiguous()
    m = _Mask(bool(causal), _norm_window(window), scale, dropout,
              int(dropout_seed) if dropout > 0.0 else None)
    return _FlashMask.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            sri, m)
