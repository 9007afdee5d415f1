"""Flash attention (counterpart of `paddle_tpu/ops/flash_attention.py`).

q, k, v are (B, H, S, D) with equal head counts (the caller repeats
GQA K/V heads); outputs come back in the input dtype, the per-row
logsumexp in fp32.

Two implementations of each of the three kernels:

  * the plain PyTorch versions `flash_fwd_reference`,
    `flash_bwd_dq_reference` and `flash_bwd_dkv_reference`: dense, in
    fp32, computing what the TPU kernels compute (P = exp(S*scale - lse),
    dS = P (dP - delta) scale, ...), not autograd of a reference. The CPU
    tests hold them to the JAX package, and `chip_smoke.py` holds the
    kernels to them on the card;
  * the Hopper kernels of `csrc/flash_attention.cu`, for CUDA tensors:
    bf16 on the tensor cores (the forward through `csrc/attn_fwd_sm90.cuh`,
    dQ and dK/dV through `csrc/attn_bwd_sm90.cuh`, which take a head dim
    that is a multiple of 8 and 16-byte aligned operands:
    `tensor_core_operands` pads or realigns, and the outputs are sliced
    back), fp32 on CUDA cores.

`flash_attention_bhsd` runs them under a `torch.autograd.Function` whose
forward saves (q, k, v, o, lse) and whose backward computes
delta = rowsum(dO * O) in plain torch and then dQ and dK/dV. Each
dispatches on q's device: the plain version for a CPU tensor, the kernel
for a CUDA tensor, an error for anything else; there is no fallback. The
launch counters `launches_fwd`, `launches_dq` and `launches_dkv` count
kernel launches (only those).

`flash_attention` is the Paddle-shaped (B, S, H, D) surface over them,
GQA heads repeated; its dropout branch waits for the key stream of the
API surface (ROADMAP.md, Queue 1 item 13). The TPU tile knobs
(`block_q`/`block_k`, `LANES`, `_fit_lanes`) do not carry over.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["mha_reference", "flash_fwd_reference", "flash_bwd_dq_reference",
           "flash_bwd_dkv_reference", "flash_attention_bhsd",
           "flash_attention", "tensor_core_operands", "launches_fwd",
           "launches_dq", "launches_dkv"]

NEG_INF = -1e30

#: kernel launches since import (reset by callers that count a run)
launches_fwd = 0
launches_dq = 0
launches_dkv = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def mha_reference(q, k, v, bias=None, causal=False, sm_scale=None):
    """q, k, v: (B, H, S, D). Returns (out in q's dtype, logsumexp fp32).
    Causal here is aligned bottom-right (`tril(k=sk - sq)`), as in the
    JAX reference; the kernels align top-left, which agrees only when
    sq == sk."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(mask, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def _scores(q, k, causal, scale):
    """(S * scale in fp32, masked to NEG_INF; visibility mask or None).
    Causal is top-left: row i sees columns <= i, as the kernels mask."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if not causal:
        return s, None
    sq, sk = s.shape[-2:]
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    valid = rows >= cols
    return torch.where(valid, s, NEG_INF), valid


def _probs(q, k, lse, causal, scale):
    """P = exp(S * scale - lse), 0 where masked."""
    s, valid = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    return p if valid is None else torch.where(valid, p, 0.0)


def flash_fwd_reference(q, k, v, causal, scale):
    """Plain version of the forward kernel: (o in q's dtype, lse fp32
    (B, H, S))."""
    s, valid = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    o = (p @ v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _dp_ds(q, k, v, do, lse, delta, causal, scale):
    p = _probs(q, k, lse, causal, scale)
    dp = do.float() @ v.float().transpose(-1, -2)
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale):
    """Plain version of the dQ kernel: dQ = dS K, in q's dtype."""
    _, ds = _dp_ds(q, k, v, do, lse, delta, causal, scale)
    return (ds @ k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale):
    """Plain version of the dK/dV kernel: (dS^T Q, P^T dO) in k's and
    v's dtypes."""
    p, ds = _dp_ds(q, k, v, do, lse, delta, causal, scale)
    dk = ds.transpose(-1, -2) @ q.float()
    dv = p.transpose(-1, -2) @ do.float()
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernels
def _check(cond, msg):
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


_LIB = []


def _lib():
    """The kernel library, built at first use, with its C signatures."""
    if not _LIB:
        from ..kernels import _build
        lib = _build.load("flash_attention")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fa_error_string.argtypes = [ci]
        lib.fa_error_string.restype = ctypes.c_char_p
        lib.fa_smem_bytes.argtypes = [ci, ci]
        lib.fa_smem_bytes.restype = ctypes.c_size_t
        # pointers and the stream as c_void_p: a bare Python int would
        # be passed as a 32-bit int and cut
        tail = [ci] * 4 + [cf, ci, ci, vp]
        lib.fa_fwd.argtypes = [vp] * 5 + tail
        lib.fa_bwd_dq.argtypes = [vp] * 7 + tail
        lib.fa_bwd_dkv.argtypes = [vp] * 8 + tail
        for fn in (lib.fa_fwd, lib.fa_bwd_dq, lib.fa_bwd_dkv):
            fn.restype = ci
        _LIB.append(lib)
    return _LIB[0]


def _check_operands(q, k, v, do=None, lse=None, delta=None):
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


def _run(fn, name, ptrs, q, sq, sk, scale, causal):
    b, h, _, d = q.shape
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, b * h, sq, sk, d, scale, int(causal),
                _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention: {name} kernel launch failed: "
            f"{lib.fa_error_string(rc).decode()} (cuda error {rc})")


def tensor_core_operands(*ts):
    """The (..., D) operands as the bf16 tensor-core kernels take them:
    the head dim zero-padded to a multiple of 8 (their 16-byte copies
    move 8 values), and each base 16-byte aligned (a contiguous view at
    another storage offset is cloned). Zero dims add nothing to Q K^T or
    dO V^T, so P and dS do not change, and they give zero output columns
    (O, dQ, dK, dV), which the caller slices off; the scale is passed
    explicitly, so it does not change. Tensors already so are returned
    as they are."""
    pad = -ts[0].shape[-1] % 8
    out = []
    for t in ts:
        if pad:
            t = torch.nn.functional.pad(t, (0, pad))
        elif t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return tuple(out)


def _launch_fwd(q, k, v, causal, scale):
    global launches_fwd
    b, h, sq, sk, d = _check_operands(q, k, v)
    if q.dtype == torch.bfloat16:
        q, k, v = tensor_core_operands(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _run(_lib().fa_fwd, "fwd", [x.data_ptr() for x in (q, k, v, o, lse)],
         q, sq, sk, scale, causal)
    launches_fwd += 1
    return (o if o.shape[-1] == d else o[..., :d].contiguous()), lse


def _launch_dq(q, k, v, do, lse, delta, causal, scale):
    global launches_dq
    _, _, sq, sk, d = _check_operands(q, k, v, do, lse, delta)
    if q.dtype == torch.bfloat16:
        q, k, v, do = tensor_core_operands(q, k, v, do)
    dq = torch.empty_like(q)
    _run(_lib().fa_bwd_dq, "dq",
         [x.data_ptr() for x in (q, k, v, do, lse, delta, dq)],
         q, sq, sk, scale, causal)
    launches_dq += 1
    return dq if dq.shape[-1] == d else dq[..., :d].contiguous()


def _launch_dkv(q, k, v, do, lse, delta, causal, scale):
    global launches_dkv
    _, _, sq, sk, d = _check_operands(q, k, v, do, lse, delta)
    if q.dtype == torch.bfloat16:
        q, k, v, do = tensor_core_operands(q, k, v, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _run(_lib().fa_bwd_dkv, "dkv",
         [x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv)],
         q, sq, sk, scale, causal)
    launches_dkv += 1
    if dk.shape[-1] != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


def _on_cpu(t):
    """True for a CPU tensor, False for a CUDA one, ValueError else."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(
            f"flash_attention: no implementation for device {t.device}; "
            "use a CUDA or a CPU tensor")
    return False


def _fwd(q, k, v, causal, scale):
    if _on_cpu(q):
        return flash_fwd_reference(q, k, v, causal, scale)
    return _launch_fwd(q, k, v, causal, scale)


def _bwd_dq(q, k, v, do, lse, delta, causal, scale):
    if _on_cpu(q):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    return _launch_dq(q, k, v, do, lse, delta, causal, scale)


def _bwd_dkv(q, k, v, do, lse, delta, causal, scale):
    if _on_cpu(q):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal,
                                       scale)
    return _launch_dkv(q, k, v, do, lse, delta, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """`_flash_mha` with its custom VJP. Everything the backward needs
    travels in `ctx`, so a forward run again under activation
    checkpointing stands on its own."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.scale = scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = _bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dk, dv = _bwd_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_bhsd(q, k, v, causal=False, sm_scale=None):
    """Attention over (B, H, S, D) q, k, v -> (B, H, S, D) in q's dtype,
    differentiable in q, k and v.

    Causal masking is aligned top-left (row i sees columns <= i), which
    is what the TPU kernels compute; it is only defined here for
    sq == sk, and raises ValueError otherwise.

    A CPU q runs the plain versions. A CUDA q launches the Hopper
    kernels, which take float32 or bfloat16 with head_dim up to 128 and
    raise on anything else."""
    sq, sk = q.shape[-2], k.shape[-2]
    if causal and sq != sk:
        raise ValueError(
            f"flash_attention_bhsd: causal attention needs sq == sk (got "
            f"{sq} and {sk}): the kernels align the mask top-left, the "
            "JAX reference bottom-right, and the two agree only there")
    scale = float(sm_scale if sm_scale is not None
                  else 1.0 / math.sqrt(q.shape[-1]))
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal), scale)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, sm_scale=None, training=True,
                    **kwargs):
    """Paddle's surface (python/paddle/nn/functional/flash_attention.py),
    as the JAX package's `flash_attention`: query (B, S, H, D), key and
    value (B, S_k, KVH, D) with H a multiple of KVH (KV head j serves
    query heads j*rep .. j*rep+rep-1). Returns (out (B, S, H, D), None),
    or (out, None, None) with `return_softmax`: the kernels never hold
    the softmax. Paddle's other arguments (fixed_seed_offset, rng_name,
    name) are accepted and ignored. Causal needs S == S_k
    (`flash_attention_bhsd`).

    Dropout while training (dropout > 0 and training) raises
    NotImplementedError: it draws from the API surface's key stream
    (ROADMAP.md, Queue 1 item 13). dropout > 0 with training=False runs
    the kernels, as in the JAX package."""
    if dropout > 0.0 and training:
        raise NotImplementedError(
            "paddle_tpu_torch: attention dropout in flash_attention "
            "(training=True) draws from the API surface's key stream, "
            "which is not ported yet (ROADMAP.md, Queue 1 item 13); pass "
            "dropout=0.0 or training=False")
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    out = flash_attention_bhsd(q, k, v, causal=causal,
                               sm_scale=sm_scale).transpose(1, 2)
    return (out, None, None) if return_softmax else (out, None)
