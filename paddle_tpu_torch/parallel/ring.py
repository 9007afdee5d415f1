"""Ring attention: sequence (context) parallelism for long sequences
(counterpart of `paddle_tpu/parallel/ring.py`).

Each rank of the `sp` axis holds one contiguous block of the sequence.
K/V blocks rotate around the ring through the differentiable
`ppermute`, and an online-softmax merge keeps O(S_local) memory; the
backward is the reverse ring, run by autograd. Plain PyTorch, as the
JAX package's is plain jnp: no kernel is launched here."""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.collective import ppermute, tie

NEG_INF = -1e30


def _block_attn(q, k, v, scale, mask=None):
    """(m, l, acc) partials of q (B, H, Sq, D) against one K/V block."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(-1), torch.einsum("bhqk,bhkd->bhqd", p, v.float())


def ring_attention_local(q, k, v, group, causal=False, sm_scale=None,
                         q_chunk=None):
    """q, k, v: this rank's (B, H, S_local, D) blocks of a sequence
    sharded over `group` (a mesh axis's group, rank i holding block i).
    Returns (B, H, S_local, D) in q's dtype.

    The causal rule is the JAX package's: the block that started on
    this rank (src == idx) is masked rows >= cols, earlier ranks' blocks
    (src < idx) are kept whole, later ones are masked out; a fully
    masked block adds nothing to the merge, so it is not computed.
    q_chunk (default 512) bounds the score tile to (chunk, S_local); each
    chunk runs under torch.utils.checkpoint, so the backward recomputes
    its scores instead of keeping them."""
    n, idx = group.nranks, group.rank
    d, s_local = q.shape[-1], q.shape[-2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    q_chunk = min(q_chunk or 512, s_local)
    starts = range(0, s_local, q_chunk)
    cols = torch.arange(s_local, device=q.device)

    def one_chunk(qc, row0, k_rot, v_rot, diag):
        mask = None
        if diag:
            rows = row0 + torch.arange(qc.shape[-2], device=q.device)
            mask = rows[:, None] >= cols[None, :]
        return _block_attn(qc, k_rot, v_rot, scale, mask)

    def block(k_rot, v_rot, diag):
        if len(starts) == 1:
            return one_chunk(q, 0, k_rot, v_rot, diag)
        parts = [checkpoint(one_chunk, q[..., r0:r0 + q_chunk, :], r0,
                            k_rot, v_rot, diag, use_reentrant=False)
                 for r0 in starts]
        return tuple(torch.cat(x, dim=2) for x in zip(*parts))

    m_acc = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_acc = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    perm = [(i, (i + 1) % n) for i in range(n)]
    for t in range(n):
        src = (idx - t) % n              # whose K/V this rank holds now
        if not causal or src <= idx:
            m_b, l_b, acc_b = block(kv[0], kv[1], causal and src == idx)
            m_new = torch.maximum(m_acc, m_b)
            a1 = torch.exp(m_acc - m_new)
            a2 = torch.exp(m_b - m_new)
            l_acc = l_acc * a1 + l_b * a2
            acc = acc * a1[..., None] + acc_b * a2[..., None]
            m_acc = m_new
        elif t > 0:
            # a later rank's block: skipped, but the transfer that brought
            # it stays in this rank's backward (the ring's reverse hops)
            acc = tie(acc, kv)
        if t < n - 1:
            # K and V ride one transfer: one chain, one backward order
            kv = ppermute(kv, perm, group)
    l_safe = torch.where(l_acc == 0.0, 1.0, l_acc)
    return (acc / l_safe[..., None]).to(q.dtype)


def ring_attention(q, k, v, mesh, sp_axis="sp", causal=False, sm_scale=None,
                   q_chunk=None):
    """q, k, v: this rank's (B, H, S_local, D) blocks, the sequence
    sharded over `sp_axis` of the rank mesh; returns the same."""
    return ring_attention_local(q, k, v, mesh.group(sp_axis), causal,
                                sm_scale, q_chunk)


def sequence_shard(x, mesh, sp_axis="sp", seq_dim=1):
    """This rank's contiguous block of `x` along `seq_dim` (the
    sequence sharded over `sp_axis`, Megatron-SP style)."""
    n = mesh.shape.get(sp_axis, 1)
    if x.shape[seq_dim] % n:
        raise ValueError(f"sequence {x.shape[seq_dim]} does not divide over "
                         f"{sp_axis}={n}")
    return x.chunk(n, seq_dim)[mesh.coord(sp_axis)]
