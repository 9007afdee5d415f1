"""RMSNorm and SwiGLU as the serving step computes them (counterparts
of `_rms` and the MLP line of `paddle_tpu/models/llama_serving.py`),
and the fused linear + cross-entropy head (counterpart of
`fused_linear_cross_entropy` in `paddle_tpu/ops/fused.py`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "swiglu", "fused_linear_cross_entropy"]


def rms_norm(x, w, eps):
    """fp32 statistics, output cast back to x's dtype."""
    xf = x.to(torch.float32)
    return (xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
            * w.to(torch.float32)).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """down(silu(x @ gate) * (x @ up))."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _tensor_cores(weight):
    """bf16 weights on the card: the head's products take bf16 operands
    on the tensor cores with fp32 output (the products of bf16 values
    are exact, the sums fp32), so the 128,256-wide head is never upcast.
    Anywhere else they are fp32 products of fp32 upcasts, as the JAX op
    computes them."""
    return weight.is_cuda and weight.dtype == torch.bfloat16


def _mm_f32(a, b):
    """a @ b with an fp32 result, as `_tensor_cores` says."""
    if a.dtype == torch.bfloat16 and _tensor_cores(b):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_logits(x, weight, bias, base, chunk):
    """fp32 logits of vocabulary columns [base, base + chunk): the last
    chunk is sliced short, which gives what the JAX op's padded columns
    (logits -1e30) give."""
    w = weight[:, base:base + chunk]
    logits = _mm_f32(x, w)
    if bias is not None:
        logits = logits + bias[base:base + chunk].float()
    return logits, w


class _FusedLinearCE(torch.autograd.Function):
    """Per-row CE(x @ weight + bias, labels), chunked over the
    vocabulary with an online logsumexp; the backward recomputes each
    chunk's softmax. Only one (N, chunk) slab of logits lives at a
    time."""

    @staticmethod
    def forward(ctx, x, weight, bias, labels, chunk, group=None):
        n, vocab = x.shape[0], weight.shape[1]
        m = torch.full((n,), -1e30, dtype=torch.float32, device=x.device)
        s = torch.zeros((n,), dtype=torch.float32, device=x.device)
        lab = torch.zeros((n,), dtype=torch.float32, device=x.device)
        for base in range(0, vocab, chunk):
            logits, _ = _chunk_logits(x, weight, bias, base, chunk)
            width = logits.shape[1]
            in_chunk = (labels >= base) & (labels < base + width)
            local = (labels - base).clamp(0, width - 1)
            picked = logits.gather(1, local[:, None])[:, 0]
            lab = torch.where(in_chunk, picked, lab)
            m_new = torch.maximum(m, logits.amax(1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(1)
            m = m_new
        if group is not None:
            # this rank's columns: the max, the sum of exponentials and
            # the target logit (0 where another rank owns it) over all
            from ..distributed import collective as C
            m_all = C.all_reduce(m.clone(), C.ReduceOp.MAX, group)
            s = C.all_reduce(s * torch.exp(m - m_all), group=group)
            lab = C.all_reduce(lab, group=group)
            m = m_all
        lse = m + torch.log(s)
        ctx.save_for_backward(x, weight, bias, labels, lse)
        ctx.chunk = chunk
        return lse - lab

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight, bias, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        g = g.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty_like(weight)
        db = None if bias is None else torch.empty_like(bias)
        for base in range(0, weight.shape[1], chunk):
            logits, w = _chunk_logits(x, weight, bias, base, chunk)
            width = logits.shape[1]
            p = torch.exp(logits - lse[:, None])               # softmax chunk
            onehot = torch.arange(width, device=x.device)[None, :] == (
                labels - base)[:, None]
            d_logits = (p - onehot.float()) * g[:, None]     # (N, chunk) fp32
            d_in = d_logits.to(weight.dtype) if _tensor_cores(weight) \
                else d_logits
            dx += _mm_f32(d_in, w.T)
            dw[:, base:base + width] = _mm_f32(x.T, d_in).to(weight.dtype)
            if db is not None:
                db[base:base + width] = d_logits.sum(0).to(bias.dtype)
        return dx.to(x.dtype), dw, db, None, None, None


def fused_linear_cross_entropy(x, weight, labels, bias=None, chunk_size=8192,
                               reduction="mean", ignore_index=-100,
                               group=None):
    """CE(x @ weight + bias, labels) without materializing the logits.

    x: (N, H) hidden states; weight: (H, V); labels: (N,) integers, rows
    labelled `ignore_index` contributing 0 (and counting for nothing in
    the mean). reduction: "mean", "sum" or "none" (per row, fp32).
    Differentiable in x, weight and bias; the gradients come back in
    their dtypes. The logits are computed `chunk_size` vocabulary
    columns at a time in fp32 and recomputed in the backward.

    group: a process group (`distributed.collective.Group`) over which
    the vocabulary is split: `weight` (and `bias`) hold this rank's
    block of columns, labels stay whole-vocabulary ids, x enters through
    `copy_to_group`, and every rank gets every row's loss; the logits
    are never gathered."""
    labels = labels.long()
    chunk = min(int(chunk_size), weight.shape[1])
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    if group is not None and group.nranks > 1:
        from ..distributed import collective as C
        x = C.copy_to_group(x, group)
        safe = safe - group.rank * weight.shape[1]
    else:
        group = None
    loss = _FusedLinearCE.apply(x, weight, bias, safe, chunk, group)
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1)
    if reduction == "sum":
        return loss.sum()
    return loss
