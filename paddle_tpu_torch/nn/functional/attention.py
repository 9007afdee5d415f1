"""Attention functionals (counterpart of
`paddle_tpu/nn/functional/attention.py`), on the port's kernels:

  * `scaled_dot_product_attention` (no mask), `flash_attention` and
    `flash_attn_qkvpacked` run `ops.flash_attention` (the flash kernels);
  * `flash_attn_unpadded` and `flash_attn_varlen_qkvpacked` run
    `ops.varlen_attention` (the varlen kernels);
  * `flashmask_attention` runs `ops.flashmask_attention` (the FlashMask
    kernels), or the flash kernels when it has no mask and no window.

Each is differentiable through the kernels' autograd Functions. Dropout
while training raises NotImplementedError in the flash and varlen
entry points, as their ops do (ROADMAP.md, Queue 1 item 13); FlashMask's
in-kernel dropout draws its seed from the ported key stream, as the
reference's does. An explicit `attn_mask` and `sparse_attention` are
plain torch math, as in the reference."""
from __future__ import annotations

import contextlib
import math

import torch

from ... import _prng
from ..._core.state import prng
from ..._core.tensor import apply, unwrap
from ...ops import flash_attention as _fa
from ...ops import flashmask_attention as _fm
from ...ops import varlen_attention as _va


@contextlib.contextmanager
def sdp_kernel(enable_flash=True, enable_math=True,
               enable_mem_efficient=True):
    yield


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """q, k, v: (B, S, H, D). Without a mask: the flash kernels; with
    one, a plain softmax over the masked scores."""
    if attn_mask is None:
        return apply(lambda q, k, v: _fa.flash_attention(
            q, k, v, dropout=dropout_p, causal=is_causal,
            training=training)[0], query, key, value)

    def fn(q, k, v, m):
        qh = q.transpose(1, 2).float()
        kh = k.transpose(1, 2).float()
        vh = v.transpose(1, 2)
        hq, hk = qh.shape[1], kh.shape[1]
        if hk != hq:
            kh = kh.repeat_interleave(hq // hk, 1)
            vh = vh.repeat_interleave(hq // hk, 1)
        s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(qh.shape[-1])
        if m.dtype == torch.bool:
            s = torch.where(m, s, torch.tensor(-1e30, device=s.device))
        else:
            s = s + m.float()
        if is_causal:
            sq, sk = s.shape[-2], s.shape[-1]
            cm = torch.ones((sq, sk), dtype=torch.bool,
                            device=s.device).tril(sk - sq)
            s = torch.where(cm, s, torch.tensor(-1e30, device=s.device))
        p = torch.softmax(s, -1)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vh.float())
        return o.transpose(1, 2).to(q.dtype)
    return apply(fn, query, key, value, attn_mask)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """paddle.nn.functional.flash_attention.flash_attention: (B, S, H, D)
    in and out, GQA when K/V have fewer heads. Returns (out, None)."""
    out = apply(lambda q, k, v: _fa.flash_attention(
        q, k, v, dropout=dropout, causal=causal, training=training)[0],
        query, key, value)
    return (out, None)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        training=True, name=None):
    """Varlen attention over packed (total, H, D) tensors. Returns
    (out, None)."""
    out = apply(lambda q, k, v: _va.flash_attn_unpadded(
        q, k, v, unwrap(cu_seqlens_q), unwrap(cu_seqlens_k), max_seqlen_q,
        max_seqlen_k, scale=scale, dropout=dropout, causal=causal,
        training=training)[0], query, key, value)
    return (out, None)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, fixed_seed_offset=None,
                         rng_name="", training=True, name=None):
    """qkv: (B, S, H/Hk + 2, Hk, D); the leading groups are the query
    heads, the last two K and V."""
    def fn(p):
        b, s, gp2, hk, d = p.shape
        q = p[:, :, :-2].reshape(b, s, (gp2 - 2) * hk, d)
        return _fa.flash_attention(q, p[:, :, -2], p[:, :, -1],
                                   dropout=dropout, causal=causal,
                                   training=training)[0]
    return (apply(fn, qkv), None)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q=None, max_seqlen_k=None,
                                scale=None, dropout=0.0, causal=False,
                                return_softmax=False, fixed_seed_offset=None,
                                rng_name="", varlen_padded=True,
                                training=True, name=None):
    """qkv: (total, H/Hk + 2, Hk, D)."""
    def fn(p):
        t, gp2, hk, d = p.shape
        q = p[:, :-2].reshape(t, (gp2 - 2) * hk, d)
        return _va.flash_attn_unpadded(
            q, p[:, -2], p[:, -1], unwrap(cu_seqlens_q),
            unwrap(cu_seqlens_k), max_seqlen_q, max_seqlen_k, scale=scale,
            dropout=dropout, causal=causal, training=training)[0]
    return (apply(fn, qkv), None)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None, max_nnz=None):
    """Attention where each query row sees only its CSR columns (a
    gather formulation). query/key/value: (B, H, S, D); offsets
    (B, H, S+1), columns (B, H, nnz)."""
    off_c = unwrap(sparse_csr_offset)
    derived = int(torch.diff(off_c, dim=-1).max()) if off_c.numel() > 1 \
        else 0
    if max_nnz is None:
        max_nnz = derived
    elif max_nnz < derived:
        raise ValueError(
            f"max_nnz={max_nnz} is smaller than the widest CSR row "
            f"({derived} columns): attention would be silently truncated")
    has_kpm, has_am = key_padding_mask is not None, attn_mask is not None

    def fn(q, k, v, off, cols, *rest):
        rest = list(rest)
        kpm = rest.pop(0) if has_kpm else None
        am = rest.pop(0) if has_am else None
        b_, h_, s_ = off.shape[0], off.shape[1], off.shape[2] - 1
        off, cols = off.long(), cols.long()
        row_nnz = torch.diff(off, dim=-1)
        lane = torch.arange(max_nnz, device=q.device)
        base = off[..., :-1, None] + lane
        mask = lane < row_nnz[..., None]
        base = torch.where(mask, base, torch.zeros_like(base))
        gi = torch.gather(cols[..., None, :].expand(b_, h_, s_,
                                                    cols.shape[-1]), -1,
                          base)
        d = q.shape[-1]
        kg = torch.gather(k[:, :, None].expand(b_, h_, s_, *k.shape[2:]), 3,
                          gi[..., None].expand(*gi.shape, d))
        vg = torch.gather(v[:, :, None].expand(b_, h_, s_, *v.shape[2:]), 3,
                          gi[..., None].expand(*gi.shape, d))
        scores = torch.einsum("bhsd,bhsnd->bhsn", q.float(),
                              kg.float()) / math.sqrt(d)
        if kpm is not None:
            keep = torch.gather(kpm[:, None, None, :].expand(
                b_, h_, s_, kpm.shape[-1]), -1, gi)
            mask = mask & (keep if keep.dtype == torch.bool else keep > -1.0)
        scores = torch.where(mask, scores, torch.tensor(
            float("-inf"), device=q.device))
        if am is not None:
            scores = scores + torch.gather(am.float(), -1, gi)
        p = torch.softmax(scores, -1)
        p = torch.where(mask, p, torch.zeros_like(p))
        out = torch.einsum("bhsn,bhsnd->bhsd", p, vg.float())
        return out.to(q.dtype)

    args = [query, key, value, sparse_csr_offset, sparse_csr_columns]
    args += [a for a in (key_padding_mask, attn_mask) if a is not None]
    return apply(fn, *args)


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """FlashMask attention: sparse masks as per-column start/end row
    indices, (B, Hk, S_k, {1, 2, 4}) int32. No indices and no window:
    the flash kernels."""
    if startend_row_indices is None and window_size is None:
        return flash_attention(query, key, value, dropout=dropout,
                               causal=causal, training=training)
    use_dropout = dropout > 0.0 and training
    dropout_seed = None
    if use_dropout:
        # drawn once, outside the op: the kernel regenerates its mask
        # from (seed, coordinates) in the backward
        dropout_seed = int(_prng.randint(prng.next_key(), (), 0,
                                         2 ** 31 - 1, 32))

    def fn(q, k, v, *rest):
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        h = qh.shape[1]
        if kh.shape[1] != h:
            kh = kh.repeat_interleave(h // kh.shape[1], 1)
            vh = vh.repeat_interleave(h // vh.shape[1], 1)
        sri = None
        if rest:
            sri = rest[0].to(torch.int32)
            if sri.shape[1] != h:
                sri = sri.repeat_interleave(h // sri.shape[1], 1)
        out = _fm.flashmask_attention_bhsd(
            qh, kh, vh, sri, causal=causal, window=window_size,
            dropout=dropout if use_dropout else 0.0,
            dropout_seed=dropout_seed)
        return out.transpose(1, 2).to(q.dtype)

    args = [query, key, value]
    if startend_row_indices is not None:
        args.append(startend_row_indices)
    return apply(fn, *args)
