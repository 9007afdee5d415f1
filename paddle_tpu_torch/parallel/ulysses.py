"""Ulysses (all-to-all) sequence parallelism (counterpart of
`paddle_tpu/parallel/ulysses.py`).

On n ranks of the `sp` axis, each holding (B, H, S/n, D):

    (B, H, S/n, D)  --all_to_all-->  (B, H/n, S, D)
    full causal attention on this rank's heads: the flash kernels
    (`ops/flash_attention.py`: fa_fwd, fa_bwd_dq, fa_bwd_dkv on the card)
    (B, H/n, S, D)  --all_to_all-->  (B, H, S/n, D)

Against the ring (`ring.py`), Ulysses moves q, k, v and o once each and
runs the kernel over the whole sequence; it needs heads % n == 0."""
from __future__ import annotations

from ..distributed.collective import all_to_all
from ..ops.flash_attention import flash_attention_bhsd


def ulysses_attention_local(q, k, v, group, causal=False, sm_scale=None):
    """q: this rank's (B, H, S_local, D) block, H divisible by the group's
    size. k and v may carry fewer (GQA) heads: when kv_heads also divides
    by the group's size they cross at KV width and are repeated to the
    query heads after the re-shard (KV head j serving query heads j*rep
    .. j*rep+rep-1); otherwise they are repeated first. Returns (B, H,
    S_local, D)."""
    n = group.nranks
    H, Hkv = q.shape[1], k.shape[1]
    if H % n:
        raise ValueError(
            f"ulysses attention needs heads ({H}) divisible by the sp "
            f"axis size ({n}); use ring attention to scale sequence "
            "past the head count")
    if v.shape[1] != Hkv or H % Hkv:
        raise ValueError(
            f"k/v head counts ({Hkv}, {v.shape[1]}) must match and "
            f"divide q heads ({H})")
    if Hkv != H and Hkv % n:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    # heads scatter, sequence gathers: the blocks received concatenate in
    # rank order, which is token order
    qh, kh, vh = (all_to_all(t, group, 1, 2) for t in (q, k, v))
    if kh.shape[1] != qh.shape[1]:
        rep = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    o = flash_attention_bhsd(qh, kh, vh, causal=causal, sm_scale=sm_scale)
    return all_to_all(o, group, 2, 1)


def ulysses_attention(q, k, v, mesh, sp_axis="sp", causal=False,
                      sm_scale=None):
    """q, k, v: this rank's (B, H, S_local, D) blocks, the sequence
    sharded over `sp_axis` of the rank mesh; returns the same."""
    return ulysses_attention_local(q, k, v, mesh.group(sp_axis), causal,
                                   sm_scale)
