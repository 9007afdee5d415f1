"""Llama serving: the unified ragged step, the bucketed entry points,
and the continuous-batching engine that drives them (counterpart of
`paddle_tpu/models/llama_serving.py`).

One `unified_step` call serves an arbitrary mix of prefill chunks and
single-token decodes from a flat token buffer: token gather, RMSNorm
and QKV, RoPE, the paged KV scatter (int8-quantized on write when the
pool is int8), ragged paged attention, SwiGLU, the lean `lm_head`, and
device-side sampling. The engine keeps page tables and lengths on the
host, ships one snapshot of them per step, and reads one record back.

The bucketed entry points (`ServingEngine(..., ragged=False)`) split
the same work in three: `prefill` runs one prompt padded to a
power-of-two bucket through causal flash attention
(`ops/flash_attention.py`, after the GQA repeat); `prefill_varlen`
runs an admission wave of several prompts packed into one bucket
through varlen attention (`ops/varlen_attention.py`); `decode_step`
feeds one token per slot through paged decode attention
(`ops/paged_attention.py`) and samples on the device. Prefill K/V is
scattered into the pools afterwards (quantized then, with int8 pools).
On the CPU: `ServingEngine(params, config, ragged=False,
device="cpu")`; on the card, `python3 chip_smoke.py --phases
device,build,bucket_kernel,bucket_parity,bucket_serve` checks and
times this path. Its kernels count their launches in
`ops.varlen_attention.launches_fwd`, `ops.flash_attention.launches_fwd`
(a lone prefill) and `ops.paged_attention.launches_decode` /
`launches_decode_int8`.

Speculative decoding and chunked prefill (`ServingEngine(...,
spec_decode=G, spec_sample=..., chunked_prefill=...)`): each step
drafts up to G-1 tokens per slot by prompt lookup
(`prompt_lookup_draft`), verifies every chunk in ONE forward —
`verify_step` on the bucketed engine, whose attention is the paged
verify kernel (`ops.paged_attention.paged_verify_attention`, counted in
`launches_verify` / `launches_verify_int8`), or `unified_step` rows on
the ragged engine — and accepts greedily or by rejection sampling
(`speculative_sample`, candidate probabilities from `cand_tok`). On the
card, `python3 chip_smoke.py --phases
device,build,spec_kernel,spec_parity,spec_serve` checks and times it.

Differences from the JAX package that a reader should know:

  * the KV pools (and the device token ring) are updated IN PLACE —
    torch tensors are not functional arrays. Anything that must outlive
    a page's release (the preemption offload, a spilled prefix page) is
    copied to the host, in stream order, before the page goes back to
    the pool;
  * the layer loop is a Python loop (the JAX package scans);
  * host tables go to the device as snapshots: packed into one pinned
    host buffer per step and copied asynchronously, so the host may
    edit its tables while the step is still queued;
  * each step's record is copied to pinned host memory right behind the
    step, with a CUDA event; `_fetch_results` waits on that event — the
    one device->host sync of the step loop — so `run_pipelined` keeps
    step N+1 queued while the host consumes step N.

The prefix cache, the host KV tier and KV handoff (ROADMAP.md, Queue 1
item 6): `ServingEngine(..., prefix_cache=True)` indexes full KV pages
by a chained hash of their tokens (`serving/kvcache.py`), so admissions
that share a prompt prefix map the same pages and prefill only their
suffix — the ragged and chunked engines start the prompt feed at the
cached count, the bucketed engine runs the suffix as ONE `verify_step`
chunk (`_prefill_suffix_into`). `host_tier_bytes > 0` demotes evicted
pages to host RAM (`serving/kvtier.py`, int8 unless
`tier_quantize=False`) and restores them on a later match. A request
flagged `_handoff_export` leaves the engine with its KV as a
`serving.handoff.KVHandoff` once its prompt is seeded; one flagged
`_kv_import` scatters such a payload back and decodes on. On the card,
`python3 chip_smoke.py --phases
device,build,prefix_kernel,prefix_parity,prefix_serve` checks and times
these paths.

The serving runtime's hooks (ROADMAP.md, Queue 1 item 7): `metrics`
takes an `EngineMetrics` (`serving/metrics.py`) that the step loop
reports TTFT, TPOT, tokens, finishes, cancels, host gaps, pages,
preemptions, prefix lookups and handoffs into; `faults=` (default
`FaultPlan.from_env()`, the PT_FAULTS variable) arms a seeded
`serving.faults.FaultPlan` at the engine's failure sites (`_fire`), and
`crash_reset` returns a failed engine to a clean, servable state for the
scheduler's recovery. Admissions, preemptions, prefix hits and handoffs
leave flight records, and a request the scheduler gave a timeline gets
its marks (`_tl_mark`, `_tl_count`). With `metrics=None` and no fault
plan each hook is an attribute test. `serving.RequestScheduler`,
`ServingServer` and `Router` drive the engine; on the card `python3
chip_smoke.py --phases device,build,runtime` serves it over HTTP.

Tensor-parallel serving (ported as ROADMAP.md item 10b; the host KV
tier and handoffs under a tp mesh are item 10c):
`ServingEngine(..., ragged=False, mesh=create_mesh({"tp": n}))` in each
of n ranks (processes on torch.distributed, `parallel/mesh.py`) keeps
this rank's Megatron shard of the weights (`llama_spmd.place_params`,
pp=False: q/k/v, gate and up by columns, o and down by rows, the
embedding and `lm_head` by vocabulary) and of the KV pools and int8
scales (their KV-head axis). The step functions take the rank's plan
(`par`): heads are local (nh / n query heads, nkv / n KV heads), the
token lookup is the vocabulary-parallel `llama_spmd._embed`, the `wo`
and `w_down` products are summed over the tp group (`reduce_from_group`)
and the logits all-gathered along the vocabulary before any sampling,
so every rank holds the same logits and draws the same token. The
paged, varlen and flash kernels run unchanged on the local heads and
pool shard. Page tables, lengths, the page pool, admission, preemption
and the prefix cache are host state, the same on every rank: every rank
runs the same engine on the same submissions, in lockstep
(`distributed.launch.serve` drives one in spawned ranks). On the card,
`python3 chip_smoke.py --phases device,build,tp_parity,tp_serve`.

Out of scope, raising NotImplementedError that names the ROADMAP.md
item: the host KV tier and KV handoff under a tp mesh (item 10c).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import _prng
from .._device import DEFAULT_DEVICE, resolve_device
from ..distributed import collective as _coll
from ..observability import compile_telemetry as _compile
from ..observability import device_telemetry as _devtel
from ..observability import flight_recorder as _flight
from ..observability import trace_context as _tc
from ..observability.compile_telemetry import track_jit
from ..kernels.ragged_paged_attention import (ragged_paged_attention,
                                              step_plan)
from ..ops.flash_attention import flash_attention_bhsd
from ..ops.fused import rms_norm as _rms
from ..ops.fused import swiglu
from ..ops.paged_attention import (dequantize_kv, paged_attention,
                                   paged_verify_attention, quantize_kv)
from ..ops.varlen_attention import (flash_attention_varlen,
                                    seg_ids_from_cu_seqlens)
from ..ops.rope import apply_rotary_emb, rope_cos_sin
from ..serving.faults import FaultPlan
from ..serving.handoff import KVHandoff
from ..serving.kvcache import PagePool, PrefixCache
from ..serving.kvtier import HostTier
from .generation import filtered_probs_np, sample_logits_np
from .llama import LlamaConfig

__all__ = ["unified_step", "prefill", "prefill_varlen", "decode_step",
           "verify_step", "speculative_sample", "prompt_lookup_draft",
           "Request", "StepTicket", "RaggedTicket", "PipelineStall",
           "ServingEngine"]

_M32 = 0xFFFFFFFF


def _not_ported(what, item):
    return NotImplementedError(
        f"paddle_tpu_torch: {what} is not ported yet (ROADMAP.md, Queue 1 "
        f"item {item})")


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------
def _scatter_kv(kp, vp, ksp, vsp, li, page_ids, off, kt, vt, quant):
    """Write kt/vt (KVH, *idx, D) into layer li of the K/V pools at
    (page_ids, off), IN PLACE, quantizing on write when the pool is int8
    (per-token scales go to ksp/vsp). Returns this layer's views
    (kl, vl, ksl, vsl) for the attention read."""
    kl, vl = kp[li], vp[li]
    ksl = vsl = None
    if quant:
        kt, kts = quantize_kv(kt)
        vt, vts = quantize_kv(vt)
        ksl, vsl = ksp[li], vsp[li]
        ksl[:, page_ids, off] = kts
        vsl[:, page_ids, off] = vts
    kl[:, page_ids, off] = kt.to(kl.dtype)
    vl[:, page_ids, off] = vt.to(vl.dtype)
    return kl, vl, ksl, vsl


def _filtered_logits(lg, temp, top_k, top_p):
    """Temperature/top_k/top_p filter: lg (N, V) f32 -> temperature-
    scaled logits with dropped entries at -1e30. One descending sort
    plus threshold arithmetic, as in the JAX package: with Z the
    probability mass of the top-k set, `cum - prob <= p * Z` over the
    unfiltered probabilities is the include-crossing-token top_p test
    on the top-k-renormalized distribution."""
    V = lg.shape[-1]
    sampled_on = temp > 0.0
    # greedy rows run the arithmetic too (the caller's final where
    # masks them); guard the divide so temp=0 rows cannot overflow
    lt = lg / torch.where(sampled_on, torch.clamp_min(temp, 1e-6),
                          1.0)[:, None]
    if lg.device.type == "cpu" and not bool(
            ((top_k > 0) & (top_k < V)).any()) and bool((top_p >= 1.0).all()):
        # nothing to filter: every row keeps its whole vocabulary (the
        # threshold below would be each row's least logit). On the card
        # the arithmetic runs anyway (no host sync); on the CPU skip its
        # sort over the vocabulary
        return lt
    k = torch.where(top_k > 0, torch.clamp_max(top_k, V), V).long()
    sv = torch.sort(lt, dim=-1, descending=True).values
    probs = torch.softmax(sv, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    z = torch.gather(cum, -1, (k - 1)[:, None])
    cols = torch.arange(V, device=lg.device)
    keep = (cols[None, :] < k[:, None]) & (cum - probs <= top_p[:, None] * z)
    nkeep = torch.clamp_min(keep.sum(-1), 1)           # crossing token stays
    thresh = torch.gather(sv, -1, (nkeep - 1)[:, None])
    return torch.where(lt < thresh, -1e30, lt)


def _filter_draw(lg, temp, top_k, top_p, key, fold):
    """Filtered categorical draw: lg (N, V) f32; temp/top_k/top_p/fold
    (N,); key (N, 2) uint32 words in int64. The draw is
    `categorical(fold_in(key, fold), filtered logits)` with the JAX
    package's threefry bits (`_prng`). Returns (token (N,) int64,
    raw-model logprob at that token (N,) f32); temp == 0 rows take the
    argmax."""
    greedy = torch.argmax(lg, dim=-1)
    if lg.device.type == "cpu" and not bool((temp > 0.0).any()):
        # every row greedy: the draw would be masked out. On the card
        # the draw runs anyway (no host sync); on the CPU skip its sort
        # and threefry bits over the vocabulary
        tok = greedy
    else:
        lt = _filtered_logits(lg, temp, top_k, top_p)
        drawn = _prng.categorical(_prng.fold_in(key, fold), lt)
        tok = torch.where(temp > 0.0, drawn, greedy)
    lp = torch.gather(torch.log_softmax(lg, dim=-1), -1, tok[:, None])[:, 0]
    return tok, lp


def _sample_record(logits, lengths, active, sample):
    """One draw per slot for `decode_step`: per-slot sampling params
    (temp, top_k, top_p, key, eos, remaining), PRNG fold `lengths` (the
    length including the fed token, i.e. its position + 1: the same
    (seed, position) key as the ragged step's). Returns (next_token (B,)
    int64, done (B,) bool, logprob (B,) f32)."""
    tok, lp = _filter_draw(logits.to(torch.float32), sample["temp"],
                           sample["top_k"], sample["top_p"], sample["key"],
                           lengths.long())
    eos = sample["eos"]
    done = active & ((sample["remaining"] <= 1) |
                     ((eos >= 0) & (tok == eos)))
    return tok, done, lp


def _spec_dist_rows(lg, temp, top_k, top_p):
    """Filtered sampling DISTRIBUTION rows for the spec-decode rejection
    sampler: lg (N, V) raw logits -> (N, V) f32 softmax over
    `_filtered_logits`, the distribution the device draw samples
    from."""
    return torch.softmax(_filtered_logits(lg.to(torch.float32), temp, top_k,
                                          top_p), dim=-1)


def _sample_grid(logits, lengths, sample):
    """Verify-chunk twin of `_sample_record`: logits (B, G, V), one draw
    per chunk position. The emission after chunk token g sits at cache
    position lengths + g + 1 pre-advanced, the fold plain decode uses
    for that emission, so an un-drafted sampled slot draws the token
    plain decode would. Returns (token (B, G) int64, logprob (B, G)
    f32)."""
    B, G, V = logits.shape
    lg = logits.to(torch.float32).reshape(B * G, V)
    pos = (lengths.long()[:, None] +
           torch.arange(G, device=logits.device)[None, :] + 1).reshape(-1)

    def rep(a):
        return torch.repeat_interleave(a, G, dim=0)
    tok, lp = _filter_draw(lg, rep(sample["temp"]), rep(sample["top_k"]),
                           rep(sample["top_p"]), rep(sample["key"]), pos)
    return tok.reshape(B, G), lp.reshape(B, G)


def _sample_flat(logits, tok_slot, tok_pos, row_on, sample):
    """One draw per buffer row: per-slot sampling params gathered
    through `tok_slot`, PRNG fold `tok_pos + 1` (the request's
    (seed, position) key, the fold both bucketed paths use). A `sample`
    without eos/remaining (spec engines stop on the host) gives
    done=False everywhere. Returns (next_token (T,) int64, done (T,)
    bool, logprob (T,) f32)."""
    slot = tok_slot.long()

    def g(a):
        return a[slot]
    tok, lp = _filter_draw(logits.to(torch.float32), g(sample["temp"]),
                           g(sample["top_k"]), g(sample["top_p"]),
                           g(sample["key"]), tok_pos.long() + 1)
    if "remaining" not in sample:
        return tok, torch.zeros_like(row_on), lp
    eos = g(sample["eos"])
    done = row_on & ((g(sample["remaining"]) <= 1) |
                     ((eos >= 0) & (tok == eos)))
    return tok, done, lp


def _cand_probs(logits, tok_slot, sample, cand):
    """Per-row probability of a CANDIDATE token (the draft that follows
    the row) under the filtered distribution: logits (R, V), cand (R,)
    -> (R,) f32. Shares `_filtered_logits` with the device draw, so the
    rejection sampler accepts a draft under exactly the distribution
    the device samples from, and the host reads R floats instead of R
    vocabulary rows."""
    slot = tok_slot.long()

    def g(a):
        return a[slot]
    dist = _spec_dist_rows(logits, g(sample["temp"]), g(sample["top_k"]),
                           g(sample["top_p"]))
    return torch.gather(dist, -1, cand.long()[:, None])[:, 0]


def _qkv(x, lw, li, shape, nh, nkv, hd):
    """Layer li's q, k, v projections of x, reshaped to (*shape, heads,
    head_dim)."""
    return ((x @ lw["wq"][li]).reshape(*shape, nh, hd),
            (x @ lw["wk"][li]).reshape(*shape, nkv, hd),
            (x @ lw["wv"][li]).reshape(*shape, nkv, hd))


class _TPPlan:
    """This rank's place in tensor-parallel serving, the `par` of the
    step functions: its tp group (`llama_spmd._embed` takes the rank's
    vocabulary rows by its index in it)."""

    __slots__ = ("tp",)

    def __init__(self, mesh, config):
        self.tp = mesh.group("tp")

    def __repr__(self):
        # the step functions' compile telemetry keys calls by the reprs
        # of their arguments: one signature per plan, not per object
        return f"_TPPlan(tp={self.tp.nranks}, rank={self.tp.rank})"


def _heads(params, config):
    """(query heads, KV heads, head_dim) of the layers in `params`: all
    of them, or this rank's under tensor parallelism."""
    hd = config.hidden_size // config.num_attention_heads
    lw = params["layers"]
    return lw["wq"].shape[-1] // hd, lw["wk"].shape[-1] // hd, hd


def _embed(params, ids, par):
    """The token lookup; under tensor parallelism the vocabulary-parallel
    one of the train step (this rank's rows, summed over the tp axis)."""
    if par is None:
        return params["embed"][ids.long()]
    from .llama_spmd import _embed as embed_tp  # it imports this module
    return embed_tp(ids.long(), params["embed"], par)


def _reduce(x, par):
    """A row-split product (`wo`, `w_down`): this rank's partial sums,
    summed over the tp axis."""
    return x if par is None else _coll.reduce_from_group(x, par.tp)


def _logits(h, params, par):
    """h @ lm_head; under tensor parallelism this rank's vocabulary
    columns, all-gathered along the vocabulary, so every rank holds the
    whole row and draws the same token from it."""
    lg = h @ params["lm_head"]
    return lg if par is None else _coll.all_gather_cat(lg, par.tp, dim=-1)


def unified_step(params, k_pool, v_pool, page_table, tokens, tok_slot,
                 tok_pos, config: LlamaConfig, page_size, k_scale=None,
                 v_scale=None, sample=None, carry_tok=None,
                 carry_gather=None, carry_mask=None, need_rows=None,
                 cand_tok=None, tok_buf=None, buf_write=None):
    """One forward over a flat token buffer of any prefill/decode mix.

    tokens (T,) token ids; tok_slot (T,) int32 owning slot; tok_pos
    (T,) int32 absolute cache position, -1 for inactive slack rows
    (their K/V lands on the trash page, the last one, and attention
    skips every page for them); page_table (B, pages_per_seq) int32.
    Every row's K/V is scattered before attention; row i reads columns
    < tok_pos[i] + 1.

    The K/V pools (L, KVH, P, page, D), their int8 scales, and
    `tok_buf` are updated IN PLACE.

    `sample` (dict of per-slot tensors: temp, top_k, top_p, key, eos,
    remaining) turns on device-side sampling. `carry_tok`/`carry_gather`
    /`carry_mask` feed a row the previous step's device-resident token
    (`carry_tok[carry_gather[i]]`), so a pipelined pump launches step
    N+1 before it has read step N. `need_rows` ((N,), -1 = inactive) is
    the lean epilogue: the final hidden states are gathered down to
    those rows before `lm_head`. `cand_tok` (one per epilogue row: need
    rows when lean) appends each row's filtered-distribution
    probability of that candidate token to the record (`_cand_probs`),
    for the spec-decode rejection sampler. `tok_buf` ((B, max_seq_len+1) int32)
    makes token values device-resident: rows read their input token
    from it, and rows marked in `buf_write` write their sampled token
    back at column pos+1.

    Returns logits (T|N, V), or (logits, (next_token, done, logprob
    [, cand_prob])) when `sample` is given."""
    c = config
    nh, nkv = c.num_attention_heads, c.num_key_value_heads
    hd = c.hidden_size // nh
    eps = c.rms_norm_eps
    t = tokens.shape[0]
    Pn = k_pool.shape[2]
    quant = k_scale is not None
    if carry_tok is not None:
        tokens = torch.where(carry_mask, carry_tok[carry_gather.long()],
                             tokens)
    row_on = tok_pos >= 0
    pos = torch.clamp_min(tok_pos, 0).long()
    slot = tok_slot.long()
    if tok_buf is not None:
        # column p of a slot's ring row holds the token consumed at
        # cache position p; inactive rows read slot 0's column 0, whose
        # value is never observed (trash-page K/V, masked sampling)
        tokens = tok_buf[slot, pos]
    cos, sin = rope_cos_sin(None, hd, base=c.rope_theta, position_ids=pos)
    h = params["embed"][tokens.long()]                    # (T, H)

    page_ids = page_table.long()[slot, pos // page_size]
    # every inactive row writes the trash page at offset 0: duplicate
    # indices, harmless because nothing ever reads the trash page
    page_ids = torch.where(row_on, page_ids, Pn - 1)
    off = pos % page_size

    lw = params["layers"]
    plan = None
    for li in range(k_pool.shape[0]):
        x = _rms(h, lw["ln1"][li], eps)
        q, k, v = _qkv(x, lw, li, (t,), nh, nkv, hd)
        q, k = apply_rotary_emb(q, k, cos[:, None], sin[:, None])
        kl, vl, ksl, vsl = _scatter_kv(
            k_pool, v_pool, k_scale, v_scale, li, page_ids, off,
            k.transpose(0, 1), v.transpose(0, 1), quant)
        if li == 0:
            # the tensor-core kernel's work plan depends only on tok_slot
            # and tok_pos: one per step, shared by every layer
            plan = step_plan(q, kl, page_table, tok_slot, tok_pos)
        o = ragged_paged_attention(q, kl, vl, page_table, tok_slot, tok_pos,
                                   k_scale=ksl, v_scale=vsl,
                                   plan=plan)                 # (T, QH, D)
        h = h + o.reshape(t, -1).to(h.dtype) @ lw["wo"][li]
        x = _rms(h, lw["ln2"][li], eps)
        h = h + swiglu(x, lw["w_gate"][li], lw["w_up"][li], lw["w_down"][li])
    h = _rms(h, params["final_norm"], eps)
    if need_rows is not None:
        # lean epilogue: gather the needed rows first, so lm_head and
        # sampling run at (N, ...) and the (T, vocab) buffer never exists
        idx = torch.clamp_min(need_rows, 0).long()
        h = h[idx]
        tok_slot = tok_slot[idx]
        tok_pos = tok_pos[idx]
        row_on = (need_rows >= 0) & (tok_pos >= 0)
    logits = h @ params["lm_head"]                        # (T|N, V)
    if sample is None:
        return logits
    rec = _sample_flat(logits, tok_slot, tok_pos, row_on, sample)
    if cand_tok is not None:
        rec = rec + (_cand_probs(logits, tok_slot, sample, cand_tok),)
    if tok_buf is not None:
        # the token sampled at position p is the one position p+1
        # consumes. Rows not marked for write-back (seed rows, inactive
        # rows) park on the last column: a position that is never
        # consumed (lengths stay < max_seq_len), so like the trash page
        # it absorbs writes nobody reads — torch's index_put_ has no
        # "drop" mode
        last = tok_buf.shape[1] - 1
        col = torch.where(buf_write & row_on,
                          torch.clamp_min(tok_pos, 0).long() + 1, last)
        tok_buf[tok_slot.long(), col] = rec[0].to(tok_buf.dtype)
    return logits, rec


@torch.no_grad()
def prefill(params, input_ids, length, config: LlamaConfig, par=None):
    """One prompt, padded to its bucket. input_ids: (1, S_padded) token
    ids; length: the prompt's real length. Causal flash attention over
    the padded row (the GQA K/V heads repeated first; rows past `length`
    compute values nobody reads). Returns (next-token logits (V,),
    k_all, v_all: (L, KVH, S_padded, D)), K after RoPE. `par`: this
    rank's `_TPPlan` under tensor parallelism (its heads, its K/V), or
    None on one device, as for every step function here."""
    c = config
    nh, nkv, hd = _heads(params, c)
    eps = c.rms_norm_eps
    b, s = input_ids.shape
    cos, sin = rope_cos_sin(s, hd, base=c.rope_theta,
                            device=input_ids.device)
    h = _embed(params, input_ids, par)                    # (1, S, H)
    lw = params["layers"]
    ks, vs = [], []
    for li in range(lw["wq"].shape[0]):
        x = _rms(h, lw["ln1"][li], eps)
        q, k, v = (t.transpose(1, 2)
                   for t in _qkv(x, lw, li, (b, s), nh, nkv, hd))
        q, k = apply_rotary_emb(q, k, cos[None, None], sin[None, None])
        rep = nh // nkv
        kr = k.repeat_interleave(rep, dim=1) if rep > 1 else k
        vr = v.repeat_interleave(rep, dim=1) if rep > 1 else v
        o = flash_attention_bhsd(q, kr, vr, causal=True)  # (1, QH, S, D)
        h = h + _reduce(o.transpose(1, 2).reshape(b, s, -1) @ lw["wo"][li],
                        par)
        x = _rms(h, lw["ln2"][li], eps)
        h = h + _reduce(swiglu(x, lw["w_gate"][li], lw["w_up"][li],
                               lw["w_down"][li]), par)
        ks.append(k[0])
        vs.append(v[0])
    h = _rms(h, params["final_norm"], eps)
    logits = _logits(h[0, int(length) - 1], params, par)
    return logits, torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def prefill_varlen(params, input_ids, cu_seqlens, config: LlamaConfig,
                   par=None):
    """An admission wave in ONE call: input_ids (T_pad,) all prompts
    packed back to back; cu_seqlens (B+1,) prefix sums (unused tail
    entries repeat the last offset: zero-length segments). Each token's
    RoPE position is its place in its segment; attention is causal
    within a segment (`flash_attention_varlen`, same offsets). Returns
    (per-segment next-token logits (B, V), k_all, v_all: (L, KVH, T_pad,
    D)), K after RoPE."""
    c = config
    nh, nkv, hd = _heads(params, c)
    eps = c.rms_norm_eps
    t = input_ids.shape[0]
    dev = input_ids.device
    seg = seg_ids_from_cu_seqlens(cu_seqlens, t)
    cu = cu_seqlens.long()
    # in-segment position; a pad (seg -1) takes start 0, as in the JAX
    # package (its rows are masked and its K/V lands on the trash page)
    starts = torch.cat([cu[:1] * 0, cu])[seg.long() + 1]
    pos = torch.clamp_min(torch.arange(t, device=dev) - starts, 0)
    cos, sin = rope_cos_sin(None, hd, base=c.rope_theta, position_ids=pos)
    h = _embed(params, input_ids, par)                    # (T, H)
    lw = params["layers"]
    ks, vs = [], []
    for li in range(lw["wq"].shape[0]):
        x = _rms(h, lw["ln1"][li], eps)
        q, k, v = _qkv(x, lw, li, (t,), nh, nkv, hd)
        q, k = apply_rotary_emb(q, k, cos[:, None], sin[:, None])
        o = flash_attention_varlen(q, k, v, seg, seg, causal=True,
                                   same_offsets=True)    # (T, QH, D)
        h = h + _reduce(o.reshape(t, -1) @ lw["wo"][li], par)
        x = _rms(h, lw["ln2"][li], eps)
        h = h + _reduce(swiglu(x, lw["w_gate"][li], lw["w_up"][li],
                               lw["w_down"][li]), par)
        ks.append(k)
        vs.append(v)
    h = _rms(h, params["final_norm"], eps)
    # row-sparse epilogue: one final row per packed segment
    last = torch.clamp_min(cu[1:] - 1, 0)
    logits = _logits(h[last], params, par)                # (B, V)
    # (L, T, KVH, D) -> (L, KVH, T, D), the pool scatter layout
    return (logits, torch.stack(ks).transpose(1, 2),
            torch.stack(vs).transpose(1, 2))


@torch.no_grad()
def decode_step(params, k_pool, v_pool, page_table, lengths, tokens, active,
                config: LlamaConfig, page_size, k_scale=None, v_scale=None,
                sample=None, carry_tok=None, carry_mask=None, par=None):
    """One token for every slot.

    k_pool/v_pool: (L, KVH, P, page, D); page_table (B, pages_per_seq)
    int32; tokens (B,) the input tokens; lengths (B,) int32 INCLUDING
    the fed token; active (B,) bool. An inactive slot's K/V lands on the
    trash page (the last one). The new token's K/V is scattered (int8
    quantized, with its scales, when the pool is int8) and then every
    slot attends over its first `lengths` columns. The pools and scales
    are updated IN PLACE.

    `sample` (dict of per-slot tensors: temp, top_k, top_p, key, eos,
    remaining) turns on device-side sampling; `carry_tok`/`carry_mask`
    feed slot s the previous step's device-resident token where the mask
    is set, so a pipelined pump launches step N+1 before reading step N.
    Returns logits (B, V), or (logits, (next_token, done, logprob)) when
    `sample` is given."""
    c = config
    if carry_tok is not None:
        tokens = torch.where(carry_mask, carry_tok, tokens)
    nh, nkv, hd = _heads(params, c)
    eps = c.rms_norm_eps
    B = tokens.shape[0]
    Pn = k_pool.shape[2]
    quant = k_scale is not None
    pos = torch.clamp_min(lengths.long() - 1, 0)
    cos, sin = rope_cos_sin(None, hd, base=c.rope_theta, position_ids=pos)
    h = _embed(params, tokens, par)                       # (B, H)
    page_ids = page_table.long()[torch.arange(B, device=pos.device),
                                 pos // page_size]
    page_ids = torch.where(active, page_ids, Pn - 1)      # trash page
    off = pos % page_size
    lw = params["layers"]
    for li in range(k_pool.shape[0]):
        x = _rms(h, lw["ln1"][li], eps)
        q, k, v = _qkv(x, lw, li, (B,), nh, nkv, hd)
        q, k = apply_rotary_emb(q, k, cos[:, None], sin[:, None])
        kl, vl, ksl, vsl = _scatter_kv(
            k_pool, v_pool, k_scale, v_scale, li, page_ids, off,
            k.transpose(0, 1), v.transpose(0, 1), quant)
        o = paged_attention(q, kl, vl, page_table, lengths, k_scale=ksl,
                            v_scale=vsl)                  # (B, QH, D)
        h = h + _reduce(o.reshape(B, -1).to(h.dtype) @ lw["wo"][li], par)
        x = _rms(h, lw["ln2"][li], eps)
        h = h + _reduce(swiglu(x, lw["w_gate"][li], lw["w_up"][li],
                               lw["w_down"][li]), par)
    h = _rms(h, params["final_norm"], eps)
    logits = _logits(h, params, par)                      # (B, V)
    if sample is None:
        return logits
    return logits, _sample_record(logits, lengths, active, sample)


@torch.no_grad()
def verify_step(params, k_pool, v_pool, page_table, lengths, tokens, n_tok,
                active, config: LlamaConfig, page_size, k_scale=None,
                v_scale=None, sample=None, need_rows=None, cand_tok=None,
                par=None):
    """Speculative-decoding verify and chunked prefill: G chunk tokens
    per slot in ONE forward, every matmul at (B, G, ...).

    tokens (B, G): [pending next token, draft_1 .. draft_{G-1}] or the
    next G prompt tokens, right-padded per slot; n_tok (B,) the real
    chunk length (1..G); lengths (B,) int32 the cache length BEFORE the
    chunk (token g lands at position lengths + g; decode_step takes
    lengths pre-advanced); active (B,) bool. Padded positions and
    inactive slots write their K/V to the trash page (the last one). The
    real tokens' K/V is scattered into the pools IN PLACE before
    attention (`paged_verify_attention`: token g sees the columns
    < lengths + g + 1); entries past the prefix the host accepts stay
    beyond the slot's length, masked from every later read, and are
    overwritten when those positions are reached.

    `need_rows` ((M,) rows of the flattened (B * G) grid) is the lean
    epilogue: only those rows reach `lm_head`, and the call returns
    their logits (M, V) and samples nothing. Otherwise it returns logits
    (B, G, V) (logits[:, g] follows chunk token g), or, with `sample`
    (per-slot temp, top_k, top_p, key), (logits, (token (B, G), logprob
    (B, G)[, cand_prob (B, G)])): the position-keyed draws
    (`_sample_grid`) and, with `cand_tok` (B, G), the probability of
    each candidate token under the filtered distribution
    (`_cand_probs`)."""
    c = config
    nh, nkv, hd = _heads(params, c)
    eps = c.rms_norm_eps
    B, G = tokens.shape
    Pn = k_pool.shape[2]
    quant = k_scale is not None
    dev = tokens.device
    ar = torch.arange(G, device=dev)
    pos = lengths.long()[:, None] + ar[None, :]               # (B, G)
    cos, sin = rope_cos_sin(None, hd, base=c.rope_theta,
                            position_ids=pos)                 # (B, G, hd)
    h = _embed(params, tokens, par)                           # (B, G, H)
    # a padded position may lie past the table's last page (a slot near
    # max_seq_len); it writes the trash page, so any in-range page will do
    pidx = torch.clamp_max(pos // page_size, page_table.shape[1] - 1)
    page_ids = page_table.long()[torch.arange(B, device=dev)[:, None], pidx]
    real = active[:, None] & (ar[None, :] < n_tok.long()[:, None])
    page_ids = torch.where(real, page_ids, Pn - 1)            # trash page
    off = pos % page_size
    lw = params["layers"]
    for li in range(k_pool.shape[0]):
        x = _rms(h, lw["ln1"][li], eps)
        q, k, v = (t.transpose(1, 2)
                   for t in _qkv(x, lw, li, (B, G), nh, nkv, hd))
        q, k = apply_rotary_emb(q, k, cos[:, None], sin[:, None])
        kl, vl, ksl, vsl = _scatter_kv(
            k_pool, v_pool, k_scale, v_scale, li, page_ids, off,
            k.transpose(0, 1), v.transpose(0, 1), quant)
        o = paged_verify_attention(q.contiguous(), kl, vl, page_table,
                                   lengths, k_scale=ksl,
                                   v_scale=vsl)           # (B, QH, G, D)
        h = h + _reduce(o.transpose(1, 2).reshape(B, G, -1).to(h.dtype)
                        @ lw["wo"][li], par)
        x = _rms(h, lw["ln2"][li], eps)
        h = h + _reduce(swiglu(x, lw["w_gate"][li], lw["w_up"][li],
                               lw["w_down"][li]), par)
    h = _rms(h, params["final_norm"], eps)
    if need_rows is not None:
        hf = h.reshape(B * G, -1)[torch.clamp_min(need_rows, 0).long()]
        return _logits(hf, params, par)                       # (M, V)
    logits = _logits(h, params, par)                          # (B, G, V)
    if sample is None:
        return logits
    rec = _sample_grid(logits, lengths, sample)
    if cand_tok is not None:
        slot_of = torch.repeat_interleave(torch.arange(B, device=dev), G)
        cand_p = _cand_probs(logits.reshape(B * G, -1), slot_of, sample,
                             cand_tok.reshape(-1))
        rec = rec + (cand_p.reshape(B, G),)
    return logits, rec


# every serving step function reports to the compile telemetry (calls
# and first-seen signatures, `pt_compile_fn_*` on /metrics) and, on the
# card, its analytic cost to the device telemetry (`pt_mfu`)
prefill = track_jit("serving.prefill")(prefill)
prefill_varlen = track_jit("serving.prefill_varlen")(prefill_varlen)
decode_step = track_jit("serving.decode_step")(decode_step)
verify_step = track_jit("serving.verify_step")(verify_step)
unified_step = track_jit("serving.unified_step")(unified_step)


def speculative_sample(prob_rows, drafts, rng, cand_probs=None):
    """Rejection-sampled acceptance of a deterministic draft sequence
    (speculative sampling, Leviathan et al.).

    prob_rows: the request's filtered sampling distributions, row g
    applying after chunk token g: a sequence of (V,) arrays or a
    callable g -> (V,) array, materialized lazily. drafts: (n-1,)
    proposed tokens d_1..d_{n-1}; rng: the request's
    np.random.RandomState. cand_probs (optional, (n-1,)): p_g(d_{g+1})
    precomputed (the step record's `_cand_probs`), so a row is
    materialized only on divergence or for the final draw. The rng is
    consumed in the same order either way: one rand() per accept test,
    one choice() per divergence or final draw.

    Accept d_{g+1} with probability p_g(d_{g+1}); on rejection sample
    from p_g with d removed, renormalized. Every emitted token is
    distributed exactly as p_g. Returns (tokens, n_accepted): up to n
    tokens (accepted drafts + one final sample)."""
    row = prob_rows if callable(prob_rows) else prob_rows.__getitem__
    out = []
    n = len(drafts) + 1
    for g in range(n - 1):
        d = int(drafts[g])
        p_d = float(cand_probs[g]) if cand_probs is not None else None
        if p_d is None:
            p = row(g)
            p_d = p[d]
        else:
            p = None                # materialized only on rejection
        if rng.rand() < p_d:
            out.append(d)           # accepted: the token IS the draft
            continue
        if p is None:
            p = row(g)
        resid = p.copy()
        resid[d] = 0.0
        tot = resid.sum()
        if tot <= 0.0:              # p was a point mass on d: forced
            out.append(d)
            continue
        out.append(int(rng.choice(len(resid), p=resid / tot)))
        return out, g               # divergence: stop consuming drafts
    p_last = row(n - 1)
    out.append(int(rng.choice(len(p_last), p=p_last)))
    return out, n - 1


def prompt_lookup_draft(ctx, G, ngram=2):
    """Draft continuation tokens by n-gram lookup in the request's own
    context (prompt lookup, no draft model): the up-to-G tokens that
    followed the most recent earlier occurrence of the trailing `ngram`
    tokens. Returns [] when there is none."""
    L = len(ctx)
    if L < ngram + 1:
        return []
    key = list(ctx[-ngram:])
    for i in range(L - ngram - 1, -1, -1):
        if list(ctx[i:i + ngram]) == key:
            return [int(t) for t in ctx[i + ngram:i + ngram + G]]
    return []


# ---------------------------------------------------------------------------
# engine (host-side orchestration)
# ---------------------------------------------------------------------------
class PipelineStall(RuntimeError):
    """`step_launch(carry=...)` needed a preemption victim while a step
    was still in flight. The caller must consume the in-flight ticket
    first (`step_finish`), then relaunch with carry=None."""


class StepTicket:
    """One launched-but-unconsumed bucketed `decode_step`. `reqs` maps a
    launched slot to the Request that held it at launch: `step_finish`
    applies a slot's result only while that identity still holds (a slot
    released or reused in between makes the result a discarded zombie),
    and sets a finishing slot's entry to None in the NEXT ticket so its
    overrun token is never emitted. `next_tok` is the device record's
    token row (the carry); `host` holds the record's pinned host copies
    (next_tok, done, logprob), complete once `event` has fired."""

    __slots__ = ("slots", "reqs", "next_tok", "host", "event")

    def __init__(self, slots, reqs, next_tok, host, event):
        self.slots = slots          # launched slot ids, ascending
        self.reqs = reqs            # slot -> Request at launch
        self.next_tok = next_tok    # device (B,) next tokens (the carry)
        self.host = host            # (next_tok, done, logprob)
        self.event = event          # CUDA event after the copies, or None


class RaggedTicket:
    """One launched-but-unconsumed `unified_step` wave. `flat` maps a
    decode slot to its record row; `seeds` lists (slot, req) whose
    prefill completed this wave — their first token is picked host-side
    from `seed_rows` at finish. `host` holds the record's pinned host
    copies, complete once `event` has fired."""

    __slots__ = ("reqs", "flat", "next_tok", "seeds", "slots", "host",
                 "event")

    def __init__(self, reqs, flat, next_tok, seeds, slots, host, event):
        self.reqs = reqs            # slot -> Request (decode rows only)
        self.flat = flat            # slot -> record row index
        self.next_tok = next_tok    # device (T|N,) next tokens (the carry)
        self.seeds = seeds          # [(slot, req)] completed prefills
        self.slots = slots          # slots with any row this wave
        self.host = host            # (next_tok, done, logprob, seed_rows)
        self.event = event          # CUDA event after the copies, or None


class Request:
    """One generation request: temperature=0 is greedy; top_k/top_p
    restrict the candidate set before sampling."""

    def __init__(self, rid, prompt_ids, max_new_tokens=64, eos_id=None,
                 temperature=0.0, top_k=0, top_p=1.0, seed=None,
                 logprobs=False):
        self.rid = rid
        self.prompt = list(prompt_ids)
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.rng = np.random.RandomState(seed) if seed is not None or \
            temperature > 0 else None
        # the raw threefry key jax.random.PRNGKey(seed) would hold,
        # [seed >> 32, seed & 0xffffffff]; the step samples with
        # fold_in(key, position), so the trajectory is a function of
        # (seed, position) alone
        if self.temperature > 0:
            sk = seed if seed is not None \
                else int(np.random.randint(0, 2 ** 31 - 1))
            self._base_key = np.array(
                [(sk >> 32) & _M32, sk & _M32], np.uint32)
        else:
            self._base_key = None
        self.output = []
        self.slot = None
        self.next_token = None
        # prompt tokens served from the prefix KV cache at admission
        self.cached_tokens = 0
        # honoured at step boundaries; the stamps feed TTFT and TPOT
        self.cancelled = False
        self._t_submit = None
        self._t_first = None
        self._t_last = None
        self.want_logprobs = bool(logprobs)
        self.logprobs = [] if logprobs else None
        # engine bookkeeping
        self._resume = False        # re-admission after a preemption
        self._offload = None        # {"len", "pages"} of stashed host KV
        self._pf_feed = None        # tokens to prefill
        self._pf_cursor = 0         # how many of them were fed
        self._pf_sample = False     # pick a first token when the feed ends
        self._admit_order = 0
        self._kv_match = None       # (pages, cached) acquired at admission
        # KV handoff: a KVHandoff to scatter in at admission, the flag
        # that exports this request once its prompt is seeded, and the
        # KVHandoff that export made
        self._kv_import = None
        self._handoff_export = False
        self._handoff_done = None

    def pick(self, logits_row):
        """Select the next token from this request's logits row."""
        return sample_logits_np(logits_row, self.temperature, self.top_k,
                                self.top_p, self.rng)

    def note_logprob(self, tok, logits_row):
        """Record the raw-model logprob of an emitted token."""
        if not self.want_logprobs:
            return
        x = np.asarray(logits_row, np.float64)
        x = x - x.max()
        self.logprobs.append(float(x[tok] - np.log(np.exp(x).sum())))

    @property
    def done(self):
        return (len(self.output) >= self.max_new_tokens or
                (self.eos_id is not None and self.output and
                 self.output[-1] == self.eos_id))


class _record_span:
    """A dispatch span, as the reference's `profiler.record_span`: a
    trace_context span (the flight recorder, and the span ring when
    tracing is on) and a torch.profiler range of the same name, so a
    profile of a serving run attributes wall time to the engine's
    phases."""

    __slots__ = ("_span", "_range")

    def __init__(self, name):
        self._span = _tc.span(name)
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        self._span.__enter__()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return self._span.__exit__(*exc)


def _tl_mark(req, name):
    """Stamp an exceptional transition (preempted / resumed, spill /
    restore, handoff_export / import) on the request's timeline, which
    the scheduler attaches (`serving/timeline.py`); a bare engine's
    requests have none. Host clock only."""
    tl = getattr(req, "_timeline", None)
    if tl is not None:
        tl.mark(name)


def _tl_count(req, phase, n=1):
    """Bump the request's per-phase step counter (same timeline)."""
    tl = getattr(req, "_timeline", None)
    if tl is not None:
        tl.count(phase, n)


class ServingEngine:
    """Continuous batching over a paged KV cache. With `ragged=True` (the
    default) every dispatch is one `unified_step` over a flat buffer of
    `ragged_tokens` rows. With `ragged=False` (the bucketed entry
    points) admission prefills at once — `prefill` for a single request,
    one packed `prefill_varlen` for a wave of two or more, padded to a
    power-of-two bucket (`pad_tokens` counts the padding) — and every
    step is one `decode_step` with one row per slot.

    submit() rejects requests that can never fit `max_seq_len`; requests
    that fit but exceed the current capacity queue. `num_pages` may
    oversubscribe the pool: when a step runs out of pages, the most
    recently admitted request is preempted and re-enters the head of
    the queue. `preempt_policy="offload"` copies its KV pages to the
    host tier's stash and scatters them back on resume;
    `"recompute"` drops them and re-prefills prompt + output.

    `cache_dtype="int8"` stores the pool int8 with per-token fp32
    scales; otherwise the pool stores `dtype` (default: the parameters'
    dtype). `lean` gathers the logits rows a wave samples before
    `lm_head` (ragged step), and lets a spec step's sampled slots read
    candidate probabilities instead of vocabulary rows; `tokbuf` keeps
    token values in a device ring (ragged plain decode only).

    `spec_decode=G >= 2` verifies the pending token and up to G-1
    prompt-lookup drafts (`spec_ngram`-gram) of each greedy slot in one
    forward (`verify_step` bucketed, `unified_step` ragged) and emits
    the accepted prefix plus one model token: greedy output equals plain
    decode. `spec_sample` drafts for sampled requests too, accepted by
    rejection sampling. `chunked_prefill` feeds prompts G tokens per
    verify step instead of prefilling at admission. A spec engine steps
    synchronously (`run_pipelined` runs `run`).

    `prefix_cache=True` indexes full KV pages by a chained block hash of
    their tokens: admissions sharing a prompt prefix map the same pages
    (ref-counted by the PagePool) and prefill only their suffix.
    Refcount-0 pages that are still indexed park in an LRU that
    allocation reclaims last. `host_tier_bytes > 0` adds a bounded
    host-RAM tier under that LRU: evictions demote their pages (an
    asynchronous copy; int8 with per-token fp32 scales unless
    `tier_quantize=False`) and admission lookups fall through device ->
    host. A request with `_handoff_export` set finishes with its KV
    exported as a KVHandoff (`_handoff_done`) once its prompt is seeded;
    one with `_kv_import` set resumes from such a payload.

    `mesh`: a rank mesh (`parallel.create_mesh`) whose `tp` axis has
    more than one rank makes this rank's engine one of a tensor-parallel
    group: it keeps its shard of the weights and of the pools (module
    docstring), and the group's ranks must run the same submissions in
    the same order (`distributed.launch.serve`). tp must divide the
    query and KV heads (and, as `place_params` cuts them, the vocabulary
    and the FFN width). Only the bucketed engine runs under such a mesh:
    `ragged` defaults to True without one and to False with one, and
    ragged=True with one raises, as in the JAX package. A mesh without
    a tp axis, or of tp 1, builds the unsharded engine.

    Runs on `device` ("cuda" by default; raises without a CUDA device —
    pass device="cpu" to run on the CPU). `params` must already live
    there; under a tp mesh they may also be the full tree on the CPU
    (each rank copies only its shard to `device`) or a tree already
    placed by `place_params`."""

    def __init__(self, params, config: LlamaConfig, max_seqs=4,
                 max_seq_len=512, page_size=16, dtype=None, num_pages=None,
                 cache_dtype=None, preempt_policy="offload", spec_decode=0,
                 spec_ngram=2, chunked_prefill=False, spec_sample=False,
                 mesh=None, prefix_cache=False,
                 host_tier_bytes=0, tier_quantize=True, faults=None,
                 ragged=None, ragged_tokens=None, lean=True, tokbuf=True,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        c = config
        # this rank's tensor-parallel plan; None serves on one device.
        # `_tp` is what the step calls take for it: nothing on one device
        self._par, self._tp = None, {}
        tp = 1 if mesh is None else mesh.shape.get("tp", 1)
        if tp > 1:
            if c.num_attention_heads % tp or c.num_key_value_heads % tp:
                raise ValueError(
                    f"tp={tp} must divide num_attention_heads="
                    f"{c.num_attention_heads} and num_key_value_heads="
                    f"{c.num_key_value_heads} (degenerate GQA shardings "
                    "are not supported)")
            if ragged:
                raise ValueError(
                    "ragged=True does not run under tensor parallelism yet "
                    "— build the engine with ragged=False to keep the "
                    "bucketed entry points")
            ragged = False
            if host_tier_bytes:
                raise _not_ported(
                    "the host KV tier under tensor parallelism "
                    "(host_tier_bytes with a tp mesh)", "10c")
            self._par = _TPPlan(mesh, c)
            self._tp = {"par": self._par}
            params = self._place(params, c, mesh)
        elif params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on "
                f"{self.device}: build them there (init_params(device=) / "
                "params_from_jax(device=))")
        self.params = params
        self.config = c
        self.page_size = page_size
        self.max_seqs = max_seqs
        self.max_seq_len = max_seq_len
        self.pages_per_seq = -(-max_seq_len // page_size)
        # +1 trash page for the writes of inactive rows
        if num_pages is None:
            num_pages = max_seqs * self.pages_per_seq + 1
        else:
            num_pages = int(num_pages)
            if num_pages < self.pages_per_seq + 1:
                raise ValueError(
                    f"num_pages={num_pages} cannot hold even one "
                    f"max_seq_len sequence ({self.pages_per_seq} pages) "
                    "+ the trash page")
        if cache_dtype not in (None, "int8", torch.int8):
            raise ValueError(
                f"cache_dtype={cache_dtype!r} unsupported: use 'int8' "
                "(quantized pool + per-token scales) or None (pool "
                "stores `dtype`)")
        if preempt_policy not in ("offload", "recompute"):
            raise ValueError(
                f"preempt_policy={preempt_policy!r}: use 'offload' "
                "(host-swap KV pages) or 'recompute' (re-prefill)")
        self.preempt_policy = preempt_policy
        self.preemptions = 0
        self.prefill_tokens = 0
        self.device_steps = 0
        # speculative decoding: spec_decode = G, the verify chunk width
        # (the pending token + up to G-1 prompt-lookup drafts); 0/1 is
        # plain decode
        self.spec_decode = int(spec_decode)
        self.spec_ngram = int(spec_ngram)
        if self.spec_decode < 0:
            raise ValueError(f"spec_decode={spec_decode}: want >= 0")
        # chunked prefill: admissions feed their prompt G tokens per
        # verify step, riding the verify chunk
        self.chunked_prefill = bool(chunked_prefill)
        if self.chunked_prefill and self.spec_decode < 2:
            raise ValueError(
                "chunked_prefill rides the spec verify chunk: set "
                "spec_decode >= 2 (the chunk width)")
        # spec_sample: draft for sampled requests too, accepted by
        # rejection sampling (same output distribution, another rng
        # order than plain sampling, so opt-in)
        self.spec_sample = bool(spec_sample)
        if self.spec_sample and self.spec_decode < 2:
            raise ValueError("spec_sample needs spec_decode >= 2")
        self.spec_drafted = 0    # draft tokens fed to verify
        self.spec_accepted = 0   # draft tokens accepted
        # padding rows the bucketed prefills dispatched (`_bucket_for`)
        self.pad_tokens = 0
        # rows the ragged waves fed (decode rows, feeds, verify chunks)
        self.ragged_tokens = 0
        self.ragged = True if ragged is None else bool(ragged)
        G_ = max(self.spec_decode, 1)
        if ragged_tokens is None:
            ragged_tokens = 1 << math.ceil(math.log2(max(max_seqs * G_, 16)))
        self.ragged_buf = int(ragged_tokens)
        if self.ragged and self.ragged_buf < max_seqs * G_:
            raise ValueError(
                f"ragged_tokens={self.ragged_buf} cannot hold one row per "
                f"slot ({max_seqs} slots x chunk width {G_})")
        self.lean = bool(lean)
        # a wave needs at most one sampled row per decoding slot (x G
        # under spec) plus one seed row per prefilling slot, and a slot
        # is never both
        self.need_buf = max_seqs * G_
        # lm_head rows computed, and rows the lean epilogue avoided
        self.logit_rows = 0
        self.logit_rows_skipped = 0
        dev = self.device
        # a bucketed decode is one row per slot already, and a verify
        # chunk takes host-fed tokens: no token ring for either
        self.tok_buf = torch.zeros((max_seqs, max_seq_len + 1),
                                   dtype=torch.int32, device=dev) \
            if tokbuf and self.ragged and self.spec_decode <= 1 else None
        # this rank's KV heads: the pools and scales are cut over them
        kvh = c.num_key_value_heads // tp
        hd = c.hidden_size // c.num_attention_heads
        L = c.num_hidden_layers
        self.cache_quant = cache_dtype in ("int8", torch.int8)
        pool_dtype = torch.int8 if self.cache_quant else \
            (dtype if dtype is not None else params["embed"].dtype)
        self.num_pages = num_pages
        pshape = (L, kvh, num_pages, page_size, hd)
        self.k_pool = torch.zeros(pshape, dtype=pool_dtype, device=dev)
        self.v_pool = torch.zeros(pshape, dtype=pool_dtype, device=dev)
        if self.cache_quant:
            self.k_scale = torch.zeros(pshape[:-1] + (1,),
                                       dtype=torch.float32, device=dev)
            self.v_scale = torch.zeros_like(self.k_scale)
        else:
            self.k_scale = self.v_scale = None
        # page_table/lengths are host numpy state, shipped once per step;
        # unassigned entries point at the trash page, never page 0
        self.page_table = np.full((max_seqs, self.pages_per_seq),
                                  self.num_pages - 1, np.int32)
        self.lengths = np.zeros((max_seqs,), np.int32)
        # the trash page (last id) is outside the pool, the cache and
        # the tier
        self.prefix_cache = PrefixCache(page_size) if prefix_cache else None
        self.pool = PagePool(num_pages - 1, cache=self.prefix_cache)
        # one ledger for all host-resident KV: the preemption stash
        # always, spilled prefix pages with host_tier_bytes > 0
        if host_tier_bytes and not prefix_cache:
            raise ValueError(
                f"host_tier_bytes={host_tier_bytes} needs "
                "prefix_cache=True: only the prefix cache's evictions "
                "feed the spill tier")
        self.host_tier = HostTier(page_size, tier_bytes=host_tier_bytes,
                                  quantize=tier_quantize)
        # the telemetry sink (an `EngineMetrics` or anything of its
        # shape); None costs an attribute test a hook
        self.metrics = None
        # a seeded fault plan armed at the engine's and the tier's
        # failure sites (`serving/faults.py`); None when PT_FAULTS is
        # unset. `restarts` counts crash_reset() warm restarts
        self.faults = faults if faults is not None else FaultPlan.from_env()
        self.host_tier.faults = self.faults
        self.restarts = 0
        if self.prefix_cache is not None:
            self.prefix_cache.on_evict = self._note_prefix_evict
            if self.host_tier.enabled:
                self.prefix_cache.on_spill = self._spill_page
        self.handoff_exports = 0
        self.handoff_imports = 0
        self.handoff_bytes = 0
        self.handoff_failures = 0
        # each handoff's seconds, drained into pt_handoff_seconds by
        # EngineMetrics.on_handoff (both on the pump thread)
        self._handoff_times = []
        # flagged requests not yet exported: the per-launch harvest scan
        # runs only while this is positive
        self._handoff_pending = 0
        self._index_suspend = False  # set while releasing failed slots
        # launch telemetry: wall time between a step's dispatch returning
        # and the next dispatch (pt_step_host_gap_seconds), and launched
        # steps not yet consumed (pt_pipeline_depth)
        self._t_launch_end = None
        self.last_host_gap_s = 0.0
        self.pipeline_depth = 0
        self._seq_pages = {s: [] for s in range(max_seqs)}
        self._slots = [None] * max_seqs          # slot -> Request
        self._live = set()                       # occupied slots
        self._waiting = []
        self.finished = []
        self._order = 0

    def _place(self, params, config, mesh):
        """This rank's shard of `params` on the engine's device: a full
        tree (on any device) cut by `place_params` with pp=False, as the
        JAX engine places it, or a tree that is already this rank's
        shard, taken as it is."""
        from . import llama_spmd as _spmd
        tp = mesh.shape["tp"]
        rows = params["embed"].shape[0]
        if rows == config.vocab_size:
            params = _spmd.place_params(params, config, mesh, pp=False)
        elif rows * tp != config.vocab_size or \
                params["layers"]["wq"].shape[-1] * tp != config.hidden_size:
            raise ValueError(
                f"params are neither the full tree nor a tp={tp} shard of "
                f"it (embed {tuple(params['embed'].shape)}, vocab "
                f"{config.vocab_size})")
        return {k: ({kk: vv.to(self.device) for kk, vv in v.items()}
                    if isinstance(v, dict) else v.to(self.device))
                for k, v in params.items()}

    @property
    def _free(self):
        """The pool's free list (a view for the metrics and tools;
        engine code goes through `self.pool`)."""
        return self.pool.free

    # -- host <-> device -------------------------------------------------
    def _h2d(self, arr):
        """A device snapshot of a host array (numpy or CPU tensor). On
        the card it is staged through a fresh pinned buffer and copied
        asynchronously: the host may edit its own array at once, and
        the pinned block is not reused before the copy has run."""
        t = torch.from_numpy(np.ascontiguousarray(arr)) \
            if isinstance(arr, np.ndarray) else arr
        if self.device.type == "cpu":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _stage(self, parts):
        """Ship a step's host tables in ONE copy: `parts` maps names to
        int32-viewable numpy arrays; returns the same names mapped to
        int32 device tensors of the same shapes (views of one buffer)."""
        flat = np.concatenate([np.ascontiguousarray(a).view(np.int32)
                               .reshape(-1) for a in parts.values()])
        dev = self._h2d(flat)
        out, o = {}, 0
        for name, a in parts.items():
            n = a.size
            out[name] = dev[o:o + n].view(a.shape)
            o += n
        return out

    def _d2h(self, tensors):
        """Queue pinned host copies of a step's record right behind the
        step; returns (copies, event). Nothing waits here."""
        if self.device.type == "cpu":
            return tensors, None
        host = tuple(None if x is None else x.to("cpu", non_blocking=True)
                     for x in tensors)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return host, ev

    def _fetch_results(self, ticket):
        """The ONE device->host sync of the step loop: wait for the
        ticket's record copies (its event only, not whatever was queued
        after it) and return them as numpy arrays."""
        if ticket.event is not None:
            ticket.event.synchronize()
        return tuple(None if x is None else x.numpy() for x in ticket.host)

    def _read(self, tensors):
        """Copy device tensors (None passes through) to the host now and
        return them as numpy arrays: the synchronous spec step's read."""
        host, event = self._d2h(tensors)
        if event is not None:
            event.synchronize()
        return tuple(None if x is None else x.numpy() for x in host)

    # -- request admission ------------------------------------------------
    def validate(self, req: Request):
        """Raise ValueError for a request that could never run."""
        S = len(req.prompt)
        if S == 0:
            raise ValueError("serving: empty prompt")
        if S + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"serving: prompt ({S} tokens) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_seq_len="
                f"{self.max_seq_len}; truncate the prompt, lower "
                "max_new_tokens, or build the engine with a larger "
                "max_seq_len")

    def submit(self, req: Request):
        """Validate-or-reject now; queue what fits."""
        self.validate(req)
        if self._par is not None and (req._handoff_export or
                                      req._kv_import is not None):
            raise _not_ported("KV handoff under tensor parallelism (a "
                              "request to export or import with a tp "
                              "mesh)", "10c")
        if req._t_submit is None:
            req._t_submit = time.perf_counter()
        if req._handoff_export:
            self._handoff_pending += 1
        self._waiting.append(req)
        m = self.metrics
        if m is not None:
            m.on_submit(self)

    def cancel(self, req: Request):
        """Cancel a queued or active request: a queued one leaves the
        queue now; an active slot is released at the next step boundary.
        Either way the request lands in `finished` with cancelled=True.
        Returns True if the request was queued or active. Not
        thread-safe: call from the thread that steps the engine (the
        scheduler's pump)."""
        req.cancelled = True
        if req in self._waiting:
            self._waiting.remove(req)
            self._drop_offload(req)
            self._clear_handoff_flag(req)
            self.finished.append(req)
            m = self.metrics
            if m is not None:
                m.on_cancel("queued")
            return True
        return req.slot is not None

    def _sweep_cancelled(self):
        m = self.metrics
        for s in sorted(self._live):
            r = self._slots[s]
            if r is not None and r.cancelled:
                self.finished.append(r)
                self._release(s)
                r.slot = None
                if m is not None:
                    m.on_cancel("active")
        if any(r.cancelled for r in self._waiting):
            keep = []
            for r in self._waiting:
                if r.cancelled:
                    self._drop_offload(r)
                    self._clear_handoff_flag(r)
                    self.finished.append(r)
                    if m is not None:
                        m.on_cancel("queued")
                else:
                    keep.append(r)
            self._waiting = keep

    def _note_emit(self, req: Request, n: int):
        """Token accounting: the first emission closes the TTFT clock
        (from submit, queueing included), later ones feed the per-token
        latency histogram."""
        m = self.metrics
        if m is None or n <= 0:
            return
        _tl_count(req, "decode")
        now = time.perf_counter()
        if req._t_first is None:
            req._t_first = now
            if req._t_submit is not None:
                m.observe_ttft(now - req._t_submit)
        elif req._t_last is not None:
            m.observe_tpot((now - req._t_last) / n)
        req._t_last = now
        m.on_tokens(n)

    def _note_finish(self, req: Request):
        m = self.metrics
        if m is not None:
            dt = None if req._t_submit is None \
                else time.perf_counter() - req._t_submit
            m.on_finish(req, dt)

    def _note_step(self, n_active: int):
        m = self.metrics
        if m is not None:
            m.on_step(self, n_active)

    def _fire(self, point, value=None, rids=None):
        """Fault-injection hook (`serving/faults.py`): nothing unless a
        FaultPlan is attached; an armed rule may raise, sleep or corrupt
        `value` here, at the stack's real failure site."""
        f = self.faults
        if f is None:
            return value
        return f.fire(point, value, rids=rids)

    def _cost_hint(self, rows, head_rows, cols, kv_tokens):
        """Tell the device telemetry the work of the step about to be
        dispatched, which its padded shapes do not fix: the rows of live
        tokens, the rows whose logits are read, the attention's key
        columns summed over its rows and the cached tokens read. Steps
        on the CPU are not costed."""
        if self.device.type == "cuda":
            _devtel.COSTS.hint(rows, head_rows, cols, kv_tokens)

    def crash_reset(self):
        """The engine half of a warm restart after a step exception:
        release every slot as a failure must (prefix indexing suspended,
        since a failed step's K/V may be partial; a slot that was
        mid-admission holds pages but no Request, so the sweep keys on
        either), drop the engine-queued requests' stashed KV, and clear
        the launch clock. What happens to the requests (requeue,
        quarantine, fail) is the scheduler's decision. Returns the
        requests that were engine-queued at the crash."""
        self.restarts += 1
        self._t_launch_end = None
        self._index_suspend = True
        try:
            for s in range(self.max_seqs):
                if self._slots[s] is not None or self._seq_pages[s]:
                    self._release(s)
        finally:
            self._index_suspend = False
        for r in self._waiting:
            self._drop_offload(r)
        waiting, self._waiting = self._waiting, []
        # requeued requests keep their export flags; re-submission
        # counts them again, so the pending count restarts from zero
        self._handoff_pending = 0
        return waiting

    def _attach(self, slot, req):
        """Single site that occupies a slot (release is the other
        mutator of `_slots`/`_live`)."""
        self._slots[slot] = req
        self._live.add(slot)

    def _stage_tokbuf(self, slot, req):
        """(Re)write one slot's device token-ring row: prompt + output,
        zero-padded. No-op on the host token path."""
        if self.tok_buf is None:
            return
        vals = np.zeros((self.max_seq_len + 1,), np.int32)
        toks = list(req.prompt) + [int(t) for t in req.output]
        n = min(len(toks), self.max_seq_len + 1)
        vals[:n] = toks[:n]
        self.tok_buf[slot] = self._h2d(vals)

    @staticmethod
    def _feed_ids(req):
        """Tokens to prefill: the prompt, plus — after a preemption —
        everything generated except the pending next_token."""
        if req._resume:
            return list(req.prompt) + [int(t) for t in req.output[:-1]]
        return list(req.prompt)

    @staticmethod
    def _prefilling(req):
        """True while an admission still has prompt tokens to feed."""
        return req is not None and req._pf_feed is not None and \
            req._pf_cursor < len(req._pf_feed)

    def _admit(self):
        """Admit the waiting requests that both slots and KV pages can
        hold, reserving the pages live slots will need this step. A
        candidate's cached prefix is acquired (ref-counted) as it is
        considered, so a later candidate's allocation cannot evict it,
        and its page need counts only the uncached pages. Offloaded
        victims scatter their pages back and handoff imports their
        payload; the ragged engine, and any engine with
        `chunked_prefill`, attaches the rest to feed their prompts from
        the first uncached token through the coming steps; the bucketed
        engine otherwise prefills them here: a prefix hit through
        `_prefill_suffix_into`, the misses alone through `prefill` or as
        ONE packed `prefill_varlen` wave."""
        free_slots = [s for s in range(self.max_seqs)
                      if self._slots[s] is None]
        G = max(self.spec_decode, 1)
        ps = self.page_size

        def _reserve(s):
            r = self._slots[s]
            if self._prefilling(r):
                # a mid-prefill slot's whole remaining prompt is spoken for
                horizon = len(r._pf_feed)
            else:
                # a decode step writes one position, a verify chunk up to G
                horizon = min(int(self.lengths[s]) + G, self.max_seq_len)
            return max(0, -(-horizon // ps) - len(self._seq_pages[s]))
        reserve = sum(_reserve(s) for s in sorted(self._live))
        take = 0
        for req in self._waiting[:len(free_slots)]:
            ofl, hin = req._offload, req._kv_import
            if ofl is not None:
                need = ofl["pages"]
                if ofl["len"] % ps == 0 and need * ps <= ofl["len"]:
                    need += 1  # boundary growth this same step
            elif hin is not None:
                # an import scatters its shipped pages as a restore does:
                # the payload is the prefix, so the cache is not probed
                need = hin.pages
                if hin.length % ps == 0 and need * ps <= hin.length:
                    need += 1
            else:
                feed = self._feed_ids(req)
                feed_len = max(len(feed), 1)
                req._kv_match = self._cache_acquire(feed, req)
                need = -(-feed_len // ps) - len(req._kv_match[0])
                if feed_len % ps == 0:
                    need += 1  # its own first decode boundary, same step
            # available() counts free and reclaimable (parked) pages; an
            # acquired match already left the reclaimable side
            if need > self.pool.available() - reserve:
                self._cache_unacquire(req)
                break
            reserve += need
            take += 1
        if take == 0:
            return
        admitted = [self._waiting.pop(0) for _ in range(take)]
        _flight.record(
            "engine.admit", rids=[str(r.rid) for r in admitted],
            resumed=sum(1 for r in admitted if r._offload is not None),
            free_pages=len(self._free))
        reqs, slots = [], []
        for slot, req in zip(free_slots, admitted):
            if req._resume:
                # swap-in, recompute-resume or a crash requeue: one mark
                # whichever path below runs
                _tl_mark(req, "resumed")
            match = req._kv_match or ([], 0)
            req._kv_match = None
            if req._offload is not None:
                self._restore_into(slot, req)
            elif req._kv_import is not None and \
                    self._import_handoff(slot, req):
                pass  # scattered and attached; a failure falls through
            elif self.ragged or self.chunked_prefill:
                req._pf_feed = self._feed_ids(req)
                req._pf_cursor = 0
                # seed a first token iff none was ever seeded: a resumed
                # decoding request keeps its pending next_token
                req._pf_sample = not req.output
                req._resume = False
                req.slot = slot
                req._admit_order = self._order
                self._order += 1
                self._attach(slot, req)
                self._stage_tokbuf(slot, req)
                if match[0]:
                    # map the shared pages in and start the feed at the
                    # first uncached token (the ring row holds the whole
                    # feed from position 0, and lengths = the cursor)
                    self._map_prefix(slot, match)
                    req._pf_cursor = match[1]
                self._note_prefix_admit(req, match)
            elif match[0]:
                self._prefill_suffix_into(slot, req, match)
            else:
                self._note_prefix_admit(req, match)
                reqs.append(req)
                slots.append(slot)
        if len(reqs) == 1:
            self._prefill_into(slots[0], reqs[0])
        elif reqs:
            self._prefill_packed(slots, reqs)

    def _bucket_for(self, n):
        """The power-of-two padding bucket of an n-token bucketed
        prefill; counts its `b - n` padding rows into `pad_tokens` and
        tags the next tracked call with it (`set_context(bucket=)`)."""
        b = max(self.page_size, 1 << math.ceil(math.log2(max(n, 1))))
        self.pad_tokens += b - n
        _compile.set_context(bucket=b)
        return b

    def _seat(self, slot, req, row):
        """Occupy `slot` with a just-prefilled request; seed its first
        token from `row` (its last-position logits, numpy (V,)) unless
        it resumes after a preemption with its next token pending."""
        req.slot = slot
        req._admit_order = self._order
        self._order += 1
        self._attach(slot, req)
        # index BEFORE seeding: a max_new_tokens == 1 request finishes
        # (and releases) inside _seed_first_token
        self._index_slot(slot, req)
        if req._resume:
            req._resume = False
        else:
            self._seed_first_token(slot, req, row)

    def _prefill_into(self, slot, req):
        """One request's prefill through `prefill`, padded to its
        bucket, and the scatter of its K/V into fresh pages."""
        feed = self._feed_ids(req)
        S = len(feed)
        self.prefill_tokens += S
        _tl_count(req, "prefill")
        ids = np.zeros((1, self._bucket_for(S)), np.int32)
        ids[0, :S] = feed
        self.logit_rows += 1            # one final row
        self._cost_hint(S, 0 if req._resume else 1, S * (S + 1) // 2, S)
        with _record_span("serving.prefill"):
            logits, k_all, v_all = prefill(self.params, self._h2d(ids), S,
                                           self.config, **self._tp)
        self._scatter_prompt(slot, k_all, v_all, S)
        row = None if req._resume else \
            logits.to(torch.float32).cpu().numpy()
        self._seat(slot, req, row)

    def _prefill_packed(self, slots, reqs):
        """An admission wave of two or more requests: their feeds packed
        back to back into one bucket, ONE `prefill_varlen` call, one
        read of the seed rows, one scatter of the packed K/V."""
        feeds = [self._feed_ids(r) for r in reqs]
        for r in reqs:
            _tl_count(r, "prefill")
        lens = [len(f) for f in feeds]
        total = sum(lens)
        self.prefill_tokens += total
        ids = np.zeros((self._bucket_for(total),), np.int32)
        cu = np.zeros((self.max_seqs + 1,), np.int32)
        off = 0
        for i, f in enumerate(feeds):
            ids[off:off + lens[i]] = f
            off += lens[i]
            cu[i + 1] = off
        cu[len(reqs) + 1:] = off      # unused tail: zero-length segments
        self.logit_rows += self.max_seqs  # one final row per segment
        d = self._stage({"ids": ids, "cu": cu})
        self._cost_hint(total, sum(not r._resume for r in reqs),
                        sum(n * (n + 1) // 2 for n in lens), total)
        with _record_span("serving.prefill"):
            logits, k_all, v_all = prefill_varlen(self.params, d["ids"],
                                                  d["cu"], self.config,
                                                  **self._tp)
        pg, po = self._packed_indices(ids.shape[0])
        seed = [i for i, r in enumerate(reqs) if not r._resume]
        rows = dict(zip(seed, logits[seed].to(torch.float32).cpu().numpy())) \
            if seed else {}
        for i, (slot, req) in enumerate(zip(slots, reqs)):
            self._fill_indices(pg, po, slot, int(cu[i]), lens[i])
            self._seat(slot, req, rows.get(i))
        self._scatter_packed(k_all, v_all, pg, po)

    def _packed_indices(self, t):
        """(page, offset) index arrays of length t pointing at the trash
        page; `_fill_indices` points the real positions elsewhere."""
        pg = np.full((t,), self.num_pages - 1, np.int32)
        off = (np.arange(t) % self.page_size).astype(np.int32)
        return pg, off

    def _fill_indices(self, pg, off, slot, start, S):
        """Point packed positions start..start+S at slot's freshly
        allocated pages and set its length."""
        self._seq_pages[slot] = []
        pages = self._alloc_pages(slot, -(-S // self.page_size))
        pos = np.arange(S)
        pg[start:start + S] = np.asarray(pages)[pos // self.page_size]
        off[start:start + S] = pos % self.page_size
        self.lengths[slot] = S

    def _scatter_packed(self, kq, vq, pg, off):
        """Scatter packed per-layer K/V (L, KVH, T, D) into the pools at
        (pg, off), in place, quantizing on the way into an int8 pool;
        the trash page absorbs the padding."""
        idx = self._stage({"pg": pg, "off": off})
        pg_t, off_t = idx["pg"].long(), idx["off"].long()
        if self.cache_quant:
            kq, ks = quantize_kv(kq)
            vq, vs = quantize_kv(vq)
            self.k_scale[:, :, pg_t, off_t] = ks
            self.v_scale[:, :, pg_t, off_t] = vs
        self.k_pool[:, :, pg_t, off_t] = kq.to(self.k_pool.dtype)
        self.v_pool[:, :, pg_t, off_t] = vq.to(self.v_pool.dtype)

    def _scatter_prompt(self, slot, kq, vq, S):
        """Scatter one prompt's per-layer K/V (L, KVH, T >= S, D) into
        fresh pages of `slot`; positions past S land on the trash page."""
        pg, off = self._packed_indices(kq.shape[2])
        self._fill_indices(pg, off, slot, 0, S)
        self._scatter_packed(kq, vq, pg, off)

    def _alloc_pages(self, slot, n):
        if not self.pool.can_alloc(n):
            raise RuntimeError("serving: out of KV pages")
        if len(self._seq_pages[slot]) + n > self.pages_per_seq:
            raise RuntimeError("serving: sequence exceeds max_seq_len")
        pages = self.pool.alloc(n)
        self._seq_pages[slot].extend(pages)
        start = len(self._seq_pages[slot]) - n
        for i, pg in enumerate(pages):
            self.page_table[slot, start + i] = pg
        m = self.metrics
        if m is not None:
            m.on_page_alloc(n)
        return pages

    def _grow_one(self, s, carry, what):
        """Give slot s one more page, preempting the newest other
        admission while the pool is dry."""
        while not self.pool.can_alloc(1):
            if carry is not None:
                raise PipelineStall(
                    f"{what} needs a preemption victim with a step in "
                    "flight")
            if not self._preempt_one(exclude=s):
                raise RuntimeError(
                    "serving: KV page pool exhausted with a single active "
                    "sequence — num_pages is too small for max_seq_len")
        self._alloc_pages(s, 1)

    def _preempt_one(self, exclude):
        """Evict the most recently admitted active request (never
        `exclude`) to the head of the queue. "offload" first copies its
        KV pages to the host stash — synchronously, BEFORE `_release`
        hands the pages back: the pools are updated in place, so a later
        step would overwrite them. A slot in the middle of a chunked
        prefill is evictable too: its feed cursor lives on the Request,
        so an offloaded one resumes the feed where it stopped and a
        recomputed one feeds its prompt again. Returns False when
        nothing can be evicted."""
        victims = [s for s, r in enumerate(self._slots)
                   if r is not None and s != exclude]
        if not victims:
            return False
        s = max(victims, key=lambda v: self._slots[v]._admit_order)
        req = self._slots[s]
        if self.preempt_policy == "offload":
            n_pg = len(self._seq_pages[s])
            pg = self._h2d(np.asarray(self._seq_pages[s], np.int64))

            def gather(pool):
                return None if pool is None else pool[:, :, pg].cpu()
            payload = {"k": gather(self.k_pool), "v": gather(self.v_pool),
                       "ks": gather(self.k_scale), "vs": gather(self.v_scale)}
            self.host_tier.stash_put(id(req), payload, n_pg)
            _tl_mark(req, "spill")
            # the actual page count: a victim evicted right after its
            # boundary growth already holds the next, still empty, page
            req._offload = {"len": int(self.lengths[s]), "pages": n_pg}
        req._resume = True
        req.slot = None
        _tl_mark(req, "preempted")
        self._waiting.insert(0, req)
        _flight.record(
            "engine.preempt", rid=str(req.rid),
            policy=self.preempt_policy, slot=s,
            tokens=len(req.output), pages=len(self._seq_pages[s]))
        flagged = req._handoff_export
        self._release(s)
        if flagged:
            # a preempted export candidate stays one: re-arm the flag
            # _release consumed, so the re-admission still hands off
            req._handoff_export = True
            self._handoff_pending += 1
        self.preemptions += 1
        m = self.metrics
        if m is not None:
            m.on_preempt(self.preempt_policy)
        return True

    def _restore_into(self, slot, req: Request):
        """Swap-in: scatter an offloaded request's KV pages into fresh
        pages. No prefill; the pending next_token survived on the
        Request."""
        o = req._offload
        self._seq_pages[slot] = []
        pages = self._alloc_pages(slot, o["pages"])
        p = self.host_tier.stash_take(id(req))
        self._scatter_host_kv(pages, p["k"], p["v"], p["ks"], p["vs"])
        self.lengths[slot] = o["len"]
        req._offload = None
        req._resume = False
        req.slot = slot
        req._admit_order = self._order
        self._order += 1
        self._attach(slot, req)
        self._stage_tokbuf(slot, req)

    def _scatter_host_kv(self, pages, k, v, ks, vs):
        """Scatter host page KV (L, KVH, n, page, D; CPU tensors or numpy)
        into device `pages`, in place: the swap-in path of preemption
        restore and handoff import (`_scatter_pages`)."""
        self._scatter_pages(pages, *(None if a is None else
                                     self._h2d(torch.as_tensor(a))
                                     for a in (k, v, ks, vs)))

    def _pages_h2d(self, parts):
        """Per-page host tensors (L, KVH, page, D), pinned on the card as
        the tier lands them, as ONE device tensor (L, KVH, n, page, D):
        one asynchronous copy a page into a fresh device buffer, with no
        host copy on the way (None when the pages have no such part)."""
        if parts[0] is None:
            return None
        first = torch.as_tensor(parts[0])
        dev = torch.empty((len(parts),) + tuple(first.shape),
                          dtype=first.dtype, device=self.device)
        for i, a in enumerate(parts):
            dev[i].copy_(torch.as_tensor(a), non_blocking=True)
        return dev.permute(1, 2, 0, 3, 4)

    def _scatter_pages(self, pages, k, v, ks, vs):
        """Scatter device page KV (L, KVH, n, page, D) into `pages`, in
        place: the one write of every swap-in (preemption restore, tier
        restore, handoff import). A payload of another encoding than the
        pool's is converted here: int8 pages with scales dequantized
        into a float pool, float pages quantized into an int8 one
        (`dequantize_kv` / `quantize_kv`, the arithmetic of the tier's
        `_dequantize_host` / `_quantize_host`), float pages cast to the
        pool's dtype."""
        pg = self._h2d(np.asarray(pages, np.int64))
        if ks is not None:
            ks, vs = ks.to(torch.float32), vs.to(torch.float32)
            if not self.cache_quant:
                k, v = dequantize_kv(k, ks), dequantize_kv(v, vs)
        elif self.cache_quant:
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
        self.k_pool[:, :, pg] = k.to(self.k_pool.dtype)
        self.v_pool[:, :, pg] = v.to(self.v_pool.dtype)
        if self.cache_quant:
            self.k_scale[:, :, pg] = ks
            self.v_scale[:, :, pg] = vs

    def _drop_offload(self, req):
        """Forget a waiting request's stashed KV (cancel path)."""
        if req._offload is not None:
            self.host_tier.stash_discard(id(req))
        req._offload = None

    def _seed_first_token(self, slot, req, row):
        """Pick the first generated token from the prefill's last-row
        logits `row` (numpy (V,)) on the host."""
        tok = req.pick(row) if req.temperature > 0.0 else int(np.argmax(row))
        req.next_token = tok
        req.output.append(tok)
        req.note_logprob(tok, row)
        self._note_emit(req, 1)
        if req.done:  # e.g. max_new_tokens == 1
            self.finished.append(req)
            self._note_finish(req)
            self._release(slot)
        elif self.tok_buf is not None:
            # the seed is the token position `lengths` consumes next
            self.tok_buf[slot, int(self.lengths[slot])] = tok

    # -- disaggregated prefill/decode handoff ------------------------------
    def _clear_handoff_flag(self, req):
        """Consume a request's export flag, keeping the pending count
        honest. Safe on unflagged requests."""
        if req._handoff_export:
            req._handoff_export = False
            self._handoff_pending = max(0, self._handoff_pending - 1)

    def _harvest_handoffs(self, carry=None):
        """Export and finish every live slot flagged for handoff whose
        prompt is prefilled and seeded and which the unconsumed ticket
        `carry` does not hold. Runs at the top of each launch, before
        decode planning, so the export reads KV, `lengths` and output
        that agree. The ragged engine seeds a slot at the finish of its
        last prefill wave, and the wave launched meanwhile skipped it
        (its next_token was still None). The bucketed engine seeds at
        admission: a pipelined launch leaves a flagged slot out of its
        step (`_bucket_launch`), and a slot that a carried step still
        holds waits for the next launch."""
        if self._handoff_pending <= 0:
            return
        for s in sorted(self._live):
            req = self._slots[s]
            if req is None or not req._handoff_export:
                continue
            if req.next_token is None or self._prefilling(req):
                continue  # prefill (or its seeding read) still pending
            if carry is not None and carry.reqs.get(s) is req:
                continue  # its step in flight is not consumed yet
            self._export_handoff(s, req)
        # mirror now: if that was the last live slot the engine idles,
        # and no later on_step would carry the export to /metrics
        m = self.metrics
        if m is not None:
            m.on_handoff(self)

    def _export_handoff(self, s, req):
        """Ship slot `s`'s KV pages out as a KVHandoff and finish the
        request here (the decode engine owns the rest of its life). The
        pages are gathered at the fixed pages_per_seq width (the tail
        reads the trash page, sliced off after) in the tier's encoding
        (`_tier_pages`) and copied to the host in stream order; the tier's
        copy thread waits for the copy. On any failure the slot is left
        as it was and the request decodes locally."""
        t0 = time.perf_counter()
        self._clear_handoff_flag(req)
        n_pg = len(self._seq_pages[s])
        pg = np.full((self.pages_per_seq,), self.num_pages - 1, np.int64)
        pg[:n_pg] = self._seq_pages[s]
        try:
            host, ready = self._snapshot(self._tier_pages(self._h2d(pg)))
            p = self.host_tier.export_pages(*host, ready=ready,
                                            rids=[str(req.rid)])
        except Exception as e:  # noqa: BLE001 — the request decodes locally
            self.handoff_failures += 1
            _flight.record("handoff.fail", rid=str(req.rid),
                           trace_id=getattr(req, "_trace_id", None),
                           where="export", error=repr(e))
            return
        _tl_mark(req, "handoff_export")
        tl = getattr(req, "_timeline", None)

        def cut(a):
            return None if a is None else a[:, :, :n_pg]
        h = KVHandoff(
            rid=req.rid, prompt=req.prompt, output=req.output,
            next_token=int(req.next_token), length=int(self.lengths[s]),
            pages=n_pg, k=cut(p["k"]), v=cut(p["v"]), ks=cut(p["ks"]),
            vs=cut(p["vs"]), quantized=p["ks"] is not None,
            trace_id=getattr(req, "_trace_id", None),
            logprobs=req.logprobs, cached_tokens=req.cached_tokens,
            timeline=None if tl is None else tl.to_dict())
        req._handoff_done = h
        self.handoff_exports += 1
        self.handoff_bytes += h.nbytes
        self._handoff_times.append(time.perf_counter() - t0)
        _flight.record("handoff.export", rid=str(req.rid),
                       trace_id=h.trace_id, pages=n_pg, bytes=h.nbytes,
                       tokens=h.length)
        # finished without _note_finish: the decode engine completes the
        # request; this engine's ledger records it as a handoff
        self.finished.append(req)
        self._release(s)  # indexes the prefix first: the source keeps it
        req.slot = None

    def _import_handoff(self, slot, req):
        """Decode-side scatter of a KVHandoff (the port's, or the JAX
        package's numpy one) into fresh pages through `_scatter_host_kv`,
        which adapts its encoding to this pool. Returns True on
        success; on any failure the fresh pages go back to the pool and
        the caller falls back to the recompute-resume prefill (prompt +
        output[:-1]), which replays token-identically."""
        h = req._kv_import
        t0 = time.perf_counter()
        self._seq_pages[slot] = []
        try:
            # the fault point comes before the alloc: a raise leaks nothing
            self._fire("handoff_import", rids=[str(req.rid)])
            pages = self._alloc_pages(slot, h.pages)
            try:
                self._scatter_host_kv(pages, h.k, h.v, h.ks, h.vs)
            except BaseException:
                self.pool.decref(pages)
                self._seq_pages[slot] = []
                self.page_table[slot, :] = self.num_pages - 1
                raise
        except Exception as e:  # noqa: BLE001 — recompute instead
            self.handoff_failures += 1
            _flight.record("handoff.fail", rid=str(req.rid),
                           trace_id=h.trace_id, where="import",
                           error=repr(e))
            req._kv_import = None
            req._resume = True
            return False
        self.lengths[slot] = h.length
        _tl_mark(req, "handoff_import")
        req._kv_import = None
        req._resume = False
        req.slot = slot
        req._admit_order = self._order
        self._order += 1
        self._attach(slot, req)
        self._stage_tokbuf(slot, req)
        self._index_slot(slot, req)
        self.handoff_imports += 1
        self.handoff_bytes += h.nbytes
        self._handoff_times.append(time.perf_counter() - t0)
        _flight.record("handoff.import", rid=str(req.rid),
                       trace_id=h.trace_id, pages=h.pages, bytes=h.nbytes,
                       tokens=h.length)
        return True

    # -- step loop --------------------------------------------------------
    def step(self):
        """One synchronous step (launch + consume); returns #slots run."""
        self._sweep_cancelled()
        self._harvest_handoffs()
        self._admit()
        if self.spec_decode > 1:
            return self._spec_step()
        t = self.step_launch(_admitted=True)
        return 0 if t is None else self.step_finish(t)

    def _note_launch_gap(self, depth):
        """Host-gap and pipeline-depth telemetry, taken as a step is
        about to dispatch: the wall time since the previous dispatch
        returned is how long the device had no step queued behind the
        running one."""
        now = time.perf_counter()
        m = self.metrics
        if self._t_launch_end is not None:
            self.last_host_gap_s = now - self._t_launch_end
            if m is not None:
                m.observe_host_gap(self.last_host_gap_s)
        self.pipeline_depth = depth
        if m is not None:
            m.set_pipeline_depth(depth)

    def step_launch(self, carry=None, _admitted=False):
        """Admission, page growth and ONE device dispatch — a
        `unified_step` wave (RaggedTicket) or, bucketed, a `decode_step`
        (StepTicket) — with no device read: the returned ticket's record
        is still in flight (None when nothing runs). `carry` is the
        previous, unconsumed ticket: continuing slots take their input
        token from its device record. Raises PipelineStall instead of
        preempting while carrying."""
        if self.ragged:
            return self._ragged_launch(carry=carry, _admitted=_admitted)
        return self._bucket_launch(carry=carry, _admitted=_admitted)

    def step_finish(self, ticket, inflight=None):
        """Consume a launched step. `inflight` is the ticket launched
        after it (pipelined pump): a slot finishing here ran one step
        past its end there, so that entry is zombied and its length
        rolled back."""
        if self.ragged:
            return self._ragged_finish(ticket, inflight=inflight)
        return self._bucket_finish(ticket, inflight=inflight)

    def _bucket_launch(self, carry=None, _admitted=False):
        """Page growth (preempting while the pool is dry) and ONE
        `decode_step` over every slot. A carried slot that exhausts
        max_new_tokens in the in-flight step is not launched (its finish
        is host-predictable); an eos finish is not, so such a slot runs
        one discarded zombie step and `step_finish` rolls its length
        back."""
        if not _admitted:
            self._sweep_cancelled()
            self._harvest_handoffs(carry)
            self._admit()
        for s in sorted(self._live):
            cur = int(self.lengths[s])
            if cur % self.page_size == 0 and cur > 0 and \
                    len(self._seq_pages[s]) * self.page_size <= cur:
                self._grow_one(s, carry, "page growth")
        if not self._live:
            self._t_launch_end = None
            return None
        B = self.max_seqs
        tokens = np.zeros((B,), np.int32)
        carry_mask = np.zeros((B,), np.int32)
        tab = self._sampling_tables()
        launch, reqs = [], {}
        for s in sorted(self._live):
            req = self._slots[s]
            if carry is not None and req._handoff_export:
                continue  # exported at the next launch, not decoded here
            carried = carry is not None and carry.reqs.get(s) is req
            left = req.max_new_tokens - len(req.output) \
                - (1 if carried else 0)
            if left <= 0:
                continue  # the in-flight step emits its last token
            launch.append(s)
            reqs[s] = req
            if carried:
                carry_mask[s] = 1
            else:
                tokens[s] = req.next_token
            self._set_sampling(tab, s, req, left)
        if not launch:
            return None  # every occupied slot is finishing in flight
        active = np.zeros((B,), np.int32)
        active[launch] = 1
        self.lengths[launch] += 1
        # fault point: one hit a device step, with the launched request
        # ids so a rid-scoped rule can model a poison request
        if self.faults is not None:
            self._fire("step_launch",
                       rids=[str(reqs[s].rid) for s in launch])
        self._note_launch_gap(1 if carry is not None else 0)
        self.logit_rows += B            # one row per slot: none to skip
        d = self._stage({"page_table": self.page_table,
                         "lengths": self.lengths, "tokens": tokens,
                         "active": active, "carry_mask": carry_mask, **tab})
        sample = self._device_sampling(d)
        c_tok = carry.next_tok if carry is not None else \
            torch.zeros((B,), dtype=torch.int64, device=self.device)
        n_cols = int(self.lengths[launch].sum())
        self._cost_hint(len(launch), len(launch), n_cols, n_cols)
        with _record_span("serving.decode_step"):
            _, rec = decode_step(
                self.params, self.k_pool, self.v_pool, d["page_table"],
                d["lengths"], d["tokens"], d["active"] != 0, self.config,
                self.page_size, k_scale=self.k_scale, v_scale=self.v_scale,
                sample=sample, carry_tok=c_tok,
                carry_mask=d["carry_mask"] != 0, **self._tp)
        host, event = self._d2h(rec)
        self._t_launch_end = time.perf_counter()
        self.device_steps += 1
        return StepTicket(launch, reqs, rec[0], host, event)

    def _bucket_finish(self, ticket, inflight=None):
        """ONE read of the step's record (a few values per slot), then
        the host bookkeeping in slot order."""
        if self.faults is not None:
            self._fire("step_finish",
                       rids=[str(r.rid) for r in ticket.reqs.values()
                             if r is not None])
        nxt, done, lp = self._fetch_results(ticket)
        for s in ticket.slots:
            req = ticket.reqs.get(s)
            if req is None or self._slots[s] is not req:
                continue  # zombie: slot released/reused since launch
            self._emit(s, req, int(nxt[s]), bool(done[s]), float(lp[s]),
                       inflight)
        self._note_step(len(ticket.slots))
        return len(ticket.slots)

    def _emit(self, s, req, tok, done, lp, inflight):
        """Apply one decode row of a record to slot s's request: append
        the token (and its logprob); on a finish, release the slot,
        zombieing its entry in the ticket launched after it (`inflight`)
        and rolling back the length that step took."""
        req.output.append(tok)
        req.next_token = tok
        if req.want_logprobs:
            req.logprobs.append(lp)
        self._note_emit(req, 1)
        if done:
            self.finished.append(req)
            self._note_finish(req)
            if inflight is not None and inflight.reqs.get(s) is req:
                inflight.reqs[s] = None
                self.lengths[s] -= 1
            self._release(s)

    def _sampling_tables(self):
        """Per-slot host sampling tables of one step, at their off
        values: greedy, no top_k/top_p, no key, no eos, one token left."""
        B = self.max_seqs
        return {"temp": np.zeros((B,), np.float32),
                "top_k": np.zeros((B,), np.int32),
                "top_p": np.ones((B,), np.float32),
                "key": np.zeros((B, 2), np.uint32),
                "eos": np.full((B,), -1, np.int32),
                "remaining": np.ones((B,), np.int32)}

    @staticmethod
    def _set_sampling(tab, s, req, left):
        """Slot s samples for `req` this step, with `left` tokens of its
        budget left including this one."""
        tab["temp"][s] = req.temperature
        tab["top_k"][s] = req.top_k
        tab["top_p"][s] = req.top_p
        if req._base_key is not None:
            tab["key"][s] = req._base_key
        if req.eos_id is not None:
            tab["eos"][s] = int(req.eos_id)
        tab["remaining"][s] = left

    @staticmethod
    def _device_sampling(d):
        """The step's `sample` dict from the staged int32 views of the
        sampling tables (eos and remaining only where staged: a spec
        step stops requests on the host)."""
        out = {"temp": d["temp"].view(torch.float32), "top_k": d["top_k"],
               "top_p": d["top_p"].view(torch.float32),
               "key": d["key"].long() & _M32}
        for name in ("eos", "remaining"):
            if name in d:
                out[name] = d[name]
        return out

    def _ragged_launch(self, carry=None, _admitted=False):
        """Plan one wave — decode rows first, then prefill feeds into the
        remaining rows — and dispatch it. State (lengths, prefill
        cursors) advances at launch so a pipelined launch N+1 plans
        against consistent state. A slot whose prefill completed in the
        in-flight wave is unseeded (next_token None) and sits out one
        wave; its first token is picked on the host at finish."""
        if not _admitted:
            self._sweep_cancelled()
            self._harvest_handoffs(carry)
            self._admit()
        for s in sorted(self._live):
            if self._prefilling(self._slots[s]):
                continue
            cur = int(self.lengths[s])
            if cur % self.page_size == 0 and cur > 0 and \
                    len(self._seq_pages[s]) * self.page_size <= cur:
                self._grow_one(s, carry, "page growth")
        if not self._live:
            self._t_launch_end = None
            return None
        # plan decode rows (no state mutation yet: preemption in the
        # feed-growth pass below may still evict a planned slot)
        decode_plan = []
        for s in sorted(self._live):
            req = self._slots[s]
            if self._prefilling(req) or req.next_token is None:
                continue
            carried = carry is not None and carry.reqs.get(s) is req
            left = req.max_new_tokens - len(req.output) \
                - (1 if carried else 0)
            if left <= 0:
                continue  # the in-flight step emits its last token
            decode_plan.append((s, req, carried, left))
        room = self.ragged_buf - len(decode_plan)
        prefill_plan = []
        for s in sorted(self._live):
            req = self._slots[s]
            if not self._prefilling(req):
                continue
            n = min(len(req._pf_feed) - req._pf_cursor, room)
            if n <= 0:
                continue  # buffer full this wave; the slot feeds next wave
            need = -(-(int(self.lengths[s]) + n) // self.page_size)
            while len(self._seq_pages[s]) < need:
                self._grow_one(s, carry, "prefill growth")
            prefill_plan.append((s, req, n))
            room -= n
        decode_plan = [p for p in decode_plan if self._slots[p[0]] is p[1]]
        prefill_plan = [p for p in prefill_plan
                        if self._slots[p[0]] is p[1]]
        if not decode_plan and not prefill_plan:
            return None
        T = self.ragged_buf
        E = self.need_buf if self.lean else T    # epilogue rows
        tokens = np.zeros((T,), np.int32)
        tok_slot = np.zeros((T,), np.int32)
        tok_pos = np.full((T,), -1, np.int32)
        carry_mask = np.zeros((T,), np.int32)
        carry_gather = np.zeros((T,), np.int32)
        tab = self._sampling_tables()
        flat, reqs = {}, {}
        row = 0
        for s, req, carried, left in decode_plan:
            tok_slot[row] = s
            tok_pos[row] = int(self.lengths[s])
            if self.tok_buf is None:
                if carried:
                    carry_mask[row] = 1
                    carry_gather[row] = carry.flat[s]
                else:
                    tokens[row] = req.next_token
            self._set_sampling(tab, s, req, left)
            self.lengths[s] += 1
            flat[s] = row
            reqs[s] = req
            row += 1
        seeds, seed_flat = [], []
        for s, req, n in prefill_plan:
            feed, cur = req._pf_feed, req._pf_cursor
            base = int(self.lengths[s])
            if self.tok_buf is None:
                tokens[row:row + n] = feed[cur:cur + n]
            tok_slot[row:row + n] = s
            tok_pos[row:row + n] = base + np.arange(n, dtype=np.int32)
            req._pf_cursor += n
            _tl_count(req, "prefill")
            self.lengths[s] += n
            self.prefill_tokens += n
            if req._pf_cursor >= len(feed):
                # feed complete: index the slot's full pages now, so a
                # live decoding slot's prefix serves the next admission
                self._index_slot(s, req)
                if req._pf_sample:
                    # last chunk: its final row seeds the first token
                    seeds.append((s, req))
                    seed_flat.append(row + n - 1)
            row += n
        self.ragged_tokens += row
        n_decode = len(decode_plan)
        parts = {"page_table": self.page_table, "tokens": tokens,
                 "tok_slot": tok_slot, "tok_pos": tok_pos,
                 "carry_mask": carry_mask, "carry_gather": carry_gather,
                 **tab}
        if self.lean:
            # decode rows sit at buffer rows 0..n_decode-1 (so flat[s]
            # doubles as the need index), seed rows follow, -1 pads
            need = np.full((self.need_buf,), -1, np.int32)
            need[:n_decode] = np.arange(n_decode, dtype=np.int32)
            need[n_decode:n_decode + len(seed_flat)] = seed_flat
            parts["need_rows"] = need
            self.logit_rows += self.need_buf
            self.logit_rows_skipped += T - self.need_buf
        else:
            self.logit_rows += T
        bw = np.zeros((E,), np.int32)
        bw[:n_decode] = 1
        parts["buf_write"] = bw
        if self.faults is not None:
            self._fire("step_launch",
                       rids=[str(p[1].rid) for p in decode_plan] +
                            [str(p[1].rid) for p in prefill_plan])
        self._note_launch_gap(1 if carry is not None else 0)
        on = tok_pos >= 0
        self._cost_hint(row, n_decode + len(seeds),
                        int((tok_pos[on] + 1).sum()),
                        int(self.lengths[np.unique(tok_slot[on])].sum()))
        d = self._stage(parts)
        sample = self._device_sampling(d)
        if self.tok_buf is not None:
            # the ring's in-step gather/scatter is the carry
            kw = {"tok_buf": self.tok_buf, "buf_write": d["buf_write"] != 0}
        else:
            c_tok = carry.next_tok if carry is not None else \
                torch.zeros((E,), dtype=torch.int64, device=self.device)
            kw = {"carry_tok": c_tok, "carry_gather": d["carry_gather"],
                  "carry_mask": d["carry_mask"] != 0}
        with _record_span("serving.unified_step"):
            logits, rec = unified_step(
                self.params, self.k_pool, self.v_pool, d["page_table"],
                d["tokens"], d["tok_slot"], d["tok_pos"], self.config,
                self.page_size, k_scale=self.k_scale, v_scale=self.v_scale,
                sample=sample, need_rows=d.get("need_rows"), **kw)
        seed_rows = None
        if seeds:
            # lean: seed rows were gathered into need rows n_decode..
            seed_rows = logits[n_decode:n_decode + len(seeds)] \
                if self.lean else torch.stack([logits[i] for i in seed_flat])
            seed_rows = seed_rows.to(torch.float32)
        host, event = self._d2h((rec[0], rec[1], rec[2], seed_rows))
        self._t_launch_end = time.perf_counter()
        self.device_steps += 1
        return RaggedTicket(reqs, flat, rec[0], seeds,
                            sorted([p[0] for p in decode_plan] +
                                   [p[0] for p in prefill_plan]),
                            host, event)

    def _ragged_finish(self, ticket, inflight=None):
        """ONE read of the wave's record, then host bookkeeping: seeds
        first, then decode rows in slot order with the zombie /
        eos-rollback contract."""
        if self.faults is not None:
            self._fire("step_finish",
                       rids=[str(r.rid) for r in ticket.reqs.values()
                             if r is not None] +
                            [str(r.rid) for _, r in ticket.seeds])
        nxt, done, lp, seed_rows = self._fetch_results(ticket)
        if seed_rows is not None:
            for (s, req), rowv in zip(ticket.seeds, seed_rows):
                if self._slots[s] is not req:
                    continue  # zombie: slot released/reused since launch
                self._seed_first_token(s, req, rowv)
        for s in sorted(ticket.flat):
            req = ticket.reqs.get(s)
            if req is None or self._slots[s] is not req:
                continue  # zombie: slot released/reused since launch
            i = ticket.flat[s]
            self._emit(s, req, int(nxt[i]), bool(done[i]), float(lp[i]),
                       inflight)
        self._note_step(len(ticket.slots))
        return len(ticket.slots)

    # -- speculative decoding and chunked prefill ---------------------------
    def _spec_row_dist(self, logits, idx, req):
        """ONE filtered sampling distribution row (`_spec_dist_rows`,
        computed where the logits live) for the rejection sampler's
        divergence or final draw, renormalized in float64 so
        np.random.choice's sum-to-1 check passes on a float32 softmax
        row. Accepted drafts never call this: their accept tests read
        the step record's candidate probabilities."""
        dev = logits.device
        row = _spec_dist_rows(
            logits[int(idx)][None],
            torch.full((1,), req.temperature, dtype=torch.float32,
                       device=dev),
            torch.full((1,), req.top_k, dtype=torch.int32, device=dev),
            torch.full((1,), req.top_p, dtype=torch.float32, device=dev))
        p = self._read((row,))[0][0].astype(np.float64)
        return p / p.sum()

    def _spec_step(self):
        """One speculative verify step: each greedy slot (every slot
        with `spec_sample`) drafts up to G-1 tokens by prompt lookup, a
        mid-prefill slot feeds its next G prompt tokens, ONE forward
        verifies every chunk (`verify_step`, or `unified_step` rows on
        the ragged engine), and each slot emits its accepted prefix plus
        one model token. Greedy output equals plain decode's: at the
        first divergence the model token is the one plain decode picks.
        Synchronous: one read of the record per step."""
        G = self.spec_decode
        B = self.max_seqs
        active_slots = sorted(self._live)
        if not active_slots:
            self._t_launch_end = None
            return 0
        tokens = np.zeros((B, G), np.int32)
        n_tok = np.ones((B,), np.int32)
        for s in active_slots:
            req = self._slots[s]
            if self._prefilling(req):
                # chunked prefill: the chunk is the next G prompt tokens
                feed, cur = req._pf_feed, req._pf_cursor
                n = min(G, len(feed) - cur)
                tokens[s, :n] = feed[cur:cur + n]
                n_tok[s] = n
                self.prefill_tokens += n
                continue
            tokens[s, 0] = req.next_token
            room = self.max_seq_len - int(self.lengths[s]) - 1
            budget = min(G - 1, room, req.max_new_tokens - len(req.output))
            if budget > 0 and (req.temperature == 0.0 or self.spec_sample):
                # the context ends with the pending next token, which the
                # n-gram keys off
                draft = prompt_lookup_draft(req.prompt + req.output, budget,
                                            self.spec_ngram)
                tokens[s, 1:1 + len(draft)] = draft
                n_tok[s] = 1 + len(draft)
                self.spec_drafted += len(draft)
        # page growth: every real chunk position needs its page now
        for s in active_slots:
            if self._slots[s] is None:
                continue   # evicted by a preemption for an earlier slot
            need = -(-(int(self.lengths[s]) + int(n_tok[s]))
                     // self.page_size)
            while len(self._seq_pages[s]) < need:
                self._grow_one(s, None, "verify growth")
        active_slots = sorted(self._live)
        if not active_slots:
            return 0
        active = np.zeros((B,), np.int32)
        active[active_slots] = 1
        tab = self._sampling_tables()
        for s in active_slots:
            req = self._slots[s]
            if not self._prefilling(req):   # a chunk feed samples nothing
                self._set_sampling(tab, s, req, 1)
        del tab["eos"], tab["remaining"]    # stops are decided here
        # sampled slots with drafts: rejection sampling needs their
        # filtered distributions (candidate probabilities when lean, the
        # vocabulary rows otherwise); greedy slots read the (B, G) grid
        need_rows = [s for s in active_slots
                     if self._slots[s].temperature > 0.0
                     and int(n_tok[s]) > 1
                     and not self._prefilling(self._slots[s])]
        seed_slots = [s for s in active_slots
                      if self._prefilling(self._slots[s])
                      and self._slots[s]._pf_cursor + int(n_tok[s])
                      >= len(self._slots[s]._pf_feed)
                      and self._slots[s]._pf_sample]
        # the same fault point as a plain launch: one hit a device step
        if self.faults is not None:
            self._fire("step_launch",
                       rids=[str(self._slots[s].rid)
                             for s in active_slots])
        self._note_launch_gap(0)
        self._cost_hint(
            sum(int(n_tok[s]) for s in active_slots),
            sum(int(n_tok[s]) for s in active_slots
                if not self._prefilling(self._slots[s])) + len(seed_slots),
            sum(int(n_tok[s]) * int(self.lengths[s])
                + int(n_tok[s]) * (int(n_tok[s]) + 1) // 2
                for s in active_slots),
            sum(int(self.lengths[s]) + int(n_tok[s]) for s in active_slots))
        if self.ragged:
            grid, lp_grid, rows_by_slot, cand_by_slot, flat_logits, \
                row_of, seed_rows = self._spec_ragged(
                    tokens, n_tok, active_slots, tab, need_rows,
                    seed_slots)
        else:
            grid, lp_grid, rows_by_slot, cand_by_slot, flat_logits, \
                row_of, seed_rows = self._spec_bucketed(
                    tokens, n_tok, active, tab, need_rows, seed_slots)
        for s in active_slots:
            req = self._slots[s]
            n = int(n_tok[s])
            if self._prefilling(req):
                # a chunk fed; once the prompt is complete its last
                # position's logits seed generation
                req._pf_cursor += n
                _tl_count(req, "prefill")
                self.lengths[s] += n
                if req._pf_cursor >= len(req._pf_feed) and req._pf_sample:
                    self._seed_first_token(s, req, seed_rows[s])
                continue
            rows = rows_by_slot.get(s)
            if req.temperature > 0.0 and n > 1:
                # speculative sampling: rows are filtered lazily (a
                # rejection at g touches g + 1 rows)
                if s in cand_by_slot:
                    outs, a = speculative_sample(
                        lambda g: self._spec_row_dist(
                            flat_logits, row_of[s] + g, req),
                        tokens[s, 1:n], req.rng,
                        cand_probs=cand_by_slot[s])
                else:
                    outs, a = speculative_sample(
                        lambda g: filtered_probs_np(
                            rows[g], req.temperature, req.top_k,
                            req.top_p),
                        tokens[s, 1:n], req.rng)
            elif req.temperature > 0.0:
                # un-drafted sampled slot: the device drew the token with
                # the (seed, position) key plain decode uses
                outs, a = [int(grid[s, 0])], 0
            else:
                outs = [int(t) for t in grid[s, :n]]
                # accept drafts while they match the model's own choices
                a = 0
                while a < n - 1 and tokens[s, a + 1] == outs[a]:
                    a += 1
                outs = outs[:a + 1]
            self.spec_accepted += a
            emitted = 0
            for j, tok in enumerate(outs):
                req.output.append(tok)
                req.next_token = tok
                if req.want_logprobs:
                    if rows is not None:
                        req.note_logprob(tok, rows[j])
                    elif s in cand_by_slot:
                        # lean sampled slot: read this emission's row
                        req.note_logprob(tok, self._read(
                            (flat_logits[row_of[s] + j].float(),))[0])
                    else:
                        # greedy: emission j IS grid token j, whose
                        # logprob came with the record
                        req.logprobs.append(float(lp_grid[s, j]))
                emitted += 1
                if req.done:
                    break
            # the cache keeps chunk tokens 0..emitted-1: the pending
            # token and the drafts consumed to produce the emissions
            self.lengths[s] += emitted
            self._note_emit(req, emitted)
            if req.done:
                self.finished.append(req)
                self._note_finish(req)
                self._release(s)
        self._note_step(len(active_slots))
        return len(active_slots)

    def _spec_launched(self, active_slots):
        """Between a verify step's dispatch and its read: the launch
        clock, the device step count, and the step_finish fault point
        (the read is the spec step's finish)."""
        self._t_launch_end = time.perf_counter()
        self.device_steps += 1
        if self.faults is not None:
            self._fire("step_finish",
                       rids=[str(self._slots[s].rid)
                             for s in active_slots])

    def _spec_ragged(self, tokens, n_tok, active_slots, tab, need_rows,
                     seed_slots):
        """The ragged engine's verify: each slot's chunk takes n_tok[s]
        consecutive rows of one `unified_step` buffer; row base[s] + g
        draws with fold lengths + g + 1, the bucketed grid's key.
        Returns what the acceptance loop reads."""
        G = self.spec_decode
        base, row = {}, 0
        for s in active_slots:
            base[s] = row
            row += int(n_tok[s])
        self.ragged_tokens += row
        T = self.ragged_buf
        ftok = np.zeros((T,), np.int32)
        fslot = np.zeros((T,), np.int32)
        fpos = np.full((T,), -1, np.int32)
        for s in active_slots:
            n, b = int(n_tok[s]), base[s]
            ftok[b:b + n] = tokens[s, :n]
            fslot[b:b + n] = s
            fpos[b:b + n] = int(self.lengths[s]) + np.arange(n,
                                                             dtype=np.int32)
        parts = {"page_table": self.page_table, "tokens": ftok,
                 "tok_slot": fslot, "tok_pos": fpos, **tab}
        if self.lean:
            # every chunk row feeds the record: the need rows are the
            # identity over the packed rows, and each row's candidate is
            # the draft that follows it
            need = np.full((self.need_buf,), -1, np.int32)
            need[:row] = np.arange(row, dtype=np.int32)
            cand = np.zeros((self.need_buf,), np.int32)
            for s in active_slots:
                n = int(n_tok[s])
                if n > 1:
                    cand[base[s]:base[s] + n - 1] = tokens[s, 1:n]
            parts["need_rows"] = need
            parts["cand"] = cand
            self.logit_rows += self.need_buf
            self.logit_rows_skipped += T - self.need_buf
        else:
            self.logit_rows += T
        d = self._stage(parts)
        with _record_span("serving.unified_step"):
            logits, rec = unified_step(
                self.params, self.k_pool, self.v_pool, d["page_table"],
                d["tokens"], d["tok_slot"], d["tok_pos"], self.config,
                self.page_size, k_scale=self.k_scale, v_scale=self.v_scale,
                sample=self._device_sampling(d),
                need_rows=d.get("need_rows"), cand_tok=d.get("cand"))
        self._spec_launched(active_slots)
        need_idx = [i for s in need_rows
                    for i in range(base[s], base[s] + int(n_tok[s]))] \
            if need_rows and not self.lean else None
        seed_idx = [base[s] + int(n_tok[s]) - 1 for s in seed_slots]
        tok_f, lp_f, row_f, cand_f, seed_vals = self._read(
            (rec[0], rec[2],
             logits[need_idx].float() if need_idx is not None else None,
             rec[3] if self.lean else None,
             logits[seed_idx].float() if seed_slots else None))
        grid = np.zeros((self.max_seqs, G), np.int64)
        lp_grid = np.zeros((self.max_seqs, G), np.float32)
        for s in active_slots:
            n = int(n_tok[s])
            grid[s, :n] = tok_f[base[s]:base[s] + n]
            lp_grid[s, :n] = lp_f[base[s]:base[s] + n]
        rows_by_slot, cand_by_slot = {}, {}
        if row_f is not None:
            off = 0
            for s in need_rows:
                n = int(n_tok[s])
                rows_by_slot[s] = row_f[off:off + n]
                off += n
        if cand_f is not None:
            for s in need_rows:
                cand_by_slot[s] = cand_f[base[s]:base[s] + int(n_tok[s]) - 1]
        seed_rows = {} if seed_vals is None else dict(zip(seed_slots,
                                                          seed_vals))
        return (grid, lp_grid, rows_by_slot, cand_by_slot, logits, base,
                seed_rows)

    def _spec_bucketed(self, tokens, n_tok, active, tab, need_rows,
                       seed_slots):
        """The bucketed engine's verify: ONE `verify_step` over the
        (B, G) grid. Returns what the acceptance loop reads."""
        G = self.spec_decode
        parts = {"page_table": self.page_table, "lengths": self.lengths,
                 "tokens": tokens, "n_tok": n_tok, "active": active, **tab}
        lean = self.lean and bool(need_rows)
        if lean:
            # sampled slots read (B, G) candidate probabilities instead
            # of (n, V) vocabulary rows
            cand = np.zeros((self.max_seqs, G), np.int32)
            for s in need_rows:
                n = int(n_tok[s])
                cand[s, :n - 1] = tokens[s, 1:n]
            parts["cand"] = cand
        self.logit_rows += self.max_seqs * G
        d = self._stage(parts)
        with _record_span("serving.verify_step"):
            logits, rec = verify_step(
                self.params, self.k_pool, self.v_pool, d["page_table"],
                d["lengths"], d["tokens"], d["n_tok"], d["active"] != 0,
                self.config, self.page_size, k_scale=self.k_scale,
                v_scale=self.v_scale, sample=self._device_sampling(d),
                cand_tok=d.get("cand"), **self._tp)
        self._spec_launched([s for s in range(self.max_seqs) if active[s]])
        dev = logits.device
        grid, lp_grid, row_vals, cand_vals, seed_vals = self._read(
            (rec[0], rec[1],
             logits[torch.tensor(need_rows, device=dev)].float()
             if need_rows and not lean else None,
             rec[2] if lean else None,
             logits[torch.tensor(seed_slots, device=dev),
                    torch.tensor([int(n_tok[s]) - 1 for s in seed_slots],
                                 device=dev)].float()
             if seed_slots else None))
        rows_by_slot = {} if row_vals is None else \
            {s: row_vals[i][:int(n_tok[s])] for i, s in enumerate(need_rows)}
        cand_by_slot = {} if cand_vals is None else \
            {s: cand_vals[s, :int(n_tok[s]) - 1] for s in need_rows}
        seed_rows = {} if seed_vals is None else dict(zip(seed_slots,
                                                          seed_vals))
        flat = logits.reshape(-1, logits.shape[-1])
        return (grid, lp_grid, rows_by_slot, cand_by_slot, flat,
                {s: s * G for s in range(self.max_seqs)}, seed_rows)

    def _release(self, slot):
        req = self._slots[slot]
        if req is not None:
            self._clear_handoff_flag(req)
            # a finished, cancelled, exported or preempted slot's KV is
            # valid up to `lengths`: index its full pages so later
            # admissions sharing the prefix skip their prefill
            self._index_slot(slot, req)
        # decref tail-first: the deepest blocks park least recently used,
        # so eviction reclaims children before the prefixes they need
        self.pool.decref(reversed(self._seq_pages[slot]))
        self._seq_pages[slot] = []
        self.lengths[slot] = 0
        # stale entries would keep aliasing pages the pool hands out again
        self.page_table[slot, :] = self.num_pages - 1
        self._slots[slot] = None
        self._live.discard(slot)

    # -- prefix KV cache (serving/kvcache.py + serving/kvtier.py) -----------
    def _snapshot(self, tensors):
        """Host copies of device tensors (None passes through), taken in
        stream order: (copies, event). On the card the copies land in
        pinned memory asynchronously and are complete once the event
        has fired; on the CPU they are clones (a pool slice is a view,
        which a later step would overwrite in place) and the event is
        None."""
        if self.device.type == "cpu":
            return tuple(None if x is None else x.clone()
                         for x in tensors), None
        return self._d2h(tensors)

    def _cache_acquire(self, feed, req=None):
        """Longest-prefix match for an admission candidate, its pages
        ref-counted at once so nothing later in this admission can evict
        them; where the device match ends, the host tier's index takes
        over and its hits are restored into fresh device pages. Returns
        (pages, cached_tokens)."""
        pc = self.prefix_cache
        if pc is None:
            return [], 0
        pages, cached = pc.match(feed)
        if pages:
            self.pool.incref(pages)
        if self.host_tier.enabled:
            try:
                pages, cached = self._tier_restore(feed, pages, cached,
                                                   req)
            except BaseException:
                # the caller never sees the device-matched refs: give
                # them back now
                if pages:
                    self.pool.decref(pages)
                raise
        return pages, cached

    def _tier_restore(self, feed, pages, cached, req):
        """Continue the prefix walk into the host tier and scatter its
        hits into fresh pages (`_pages_h2d`, `_scatter_pages`), indexing
        them in the device cache so this request, and every later one,
        maps them as ordinary cached pages. Restored pages arrive
        refcount-1 from alloc, as the device match's incref left its
        own, so `_cache_unacquire` treats both alike."""
        tier = self.host_tier
        blocks = tier.match(feed, cached)
        room = min(self.pages_per_seq - len(pages), self.pool.available())
        n = min(len(blocks), max(room, 0))
        if n == 0:
            tier.note_lookup(0)
            return pages, cached
        blocks = blocks[:n]
        # the fault point comes before the alloc: a raise leaks nothing
        # (the caller gives the device-matched refs back)
        self._fire("tier_restore",
                   rids=None if req is None else [str(req.rid)])
        # alloc may evict, and so spill, OTHER parked pages; this
        # candidate's device-matched prefix is already increfed, so the
        # restore cannot take its own chain
        new_pages = self.pool.alloc(n)
        try:
            # an int8 tier over a float pool is dequantized on the device
            self._scatter_pages(new_pages, *(
                self._pages_h2d([b[name] for b in blocks])
                for name in ("k", "v", "ks", "vs")))
        except BaseException:
            # never mapped or indexed: give the fresh pages back
            self.pool.decref(new_pages)
            raise
        all_pages = pages + new_pages
        new_cached = cached + n * self.page_size
        self.prefix_cache.insert(feed, all_pages, new_cached)
        tier.note_lookup(n)
        if req is not None:
            _tl_mark(req, "restore")
        _flight.record(
            "kvtier.hit", rid=None if req is None else str(req.rid),
            trace_id=None if req is None
            else getattr(req, "_trace_id", None),
            pages=n, tokens=n * self.page_size, device_cached=cached)
        return all_pages, new_cached

    def _tier_pages(self, idx):
        """The pools' pages at `idx` (a page id or an index tensor) in
        the tier's encoding, as (k, v, ks, vs) device tensors: an int8
        pool's pages and scales as they are; a float pool's quantized
        here, on the device, when the tier stores int8 (`quantize_kv`,
        the arithmetic of the tier's `_quantize_host`, so only int8 and
        scales cross to the host and the copy thread has no arithmetic
        left); else its pages verbatim with no scales."""
        k, v = self.k_pool[:, :, idx], self.v_pool[:, :, idx]
        if self.cache_quant:
            return k, v, self.k_scale[:, :, idx], self.v_scale[:, :, idx]
        if self.host_tier.quantize:
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
            return k, v, ks, vs
        return k, v, None, None

    def _spill_page(self, page, parent, block, depth):
        """The prefix cache's eviction hook: demote the page's KV to the
        host tier. The pools are updated in place and allocation hands
        the page out as soon as this returns, so the page is copied to
        the host HERE, on the engine's stream (`_snapshot`), ahead of
        any later write; the tier's copy thread waits for that copy."""
        host, ready = self._snapshot(self._tier_pages(page))
        self.host_tier.spill_async(parent, block, depth, *host, ready=ready)

    def _cache_unacquire(self, req):
        """Admission did not take the candidate after all: drop its
        acquired prefix (refcount-0 pages park in the cache's LRU)."""
        match = req._kv_match
        if match and match[0]:
            self.pool.decref(match[0])
        req._kv_match = None

    def _map_prefix(self, slot, match):
        """Map acquired shared prefix pages into the slot's page-table
        row and set its length to the cached token count: the device
        sees only the suffix."""
        pages, cached = match
        self._seq_pages[slot] = list(pages)
        for i, pg in enumerate(pages):
            self.page_table[slot, i] = pg
        self.lengths[slot] = cached

    def _index_slot(self, slot, req):
        """Index the slot's full pages under the chained block hash of
        the tokens they hold (cache position i holds the KV of token
        (prompt + output)[i])."""
        pc = self.prefix_cache
        if pc is None or self._index_suspend:
            return
        n = int(self.lengths[slot])
        toks = (list(req.prompt) + [int(t) for t in req.output])[:n]
        pc.insert(toks, self._seq_pages[slot], n)

    def _note_prefix_admit(self, req, match):
        """Admission-time cache accounting: only admitted requests
        count, not a queued candidate probed again each step."""
        pc = self.prefix_cache
        if pc is None:
            return
        cached = match[1]
        req.cached_tokens = cached
        pc.lookups += 1
        if cached > 0:
            pc.hits += 1
            pc.tokens_reused += cached
            _flight.record("kvcache.hit", rid=str(req.rid),
                           trace_id=getattr(req, "_trace_id", None),
                           cached_tokens=cached, pages=len(match[0]))
        m = self.metrics
        if m is not None:
            m.on_prefix_lookup(cached)

    def _note_prefix_evict(self, page):
        m = self.metrics
        if m is not None:
            m.on_prefix_evict()

    def _prefill_suffix_into(self, slot, req, match):
        """The bucketed engine's prefill of a prefix hit: the matched
        pages are mapped in shared and only the remaining tokens run,
        as ONE `verify_step` chunk of the suffix's power-of-two bucket
        whose rows attend to the cached pages through the slot's page
        table; the other slots are inactive (n_tok 0). A partial last
        page of the prompt is part of the suffix. The lean epilogue
        computes the one row that seeds the first token."""
        pages, cached = match
        feed = self._feed_ids(req)
        suffix = feed[cached:]
        n = len(suffix)
        self.prefill_tokens += n
        _tl_count(req, "prefill")
        self._map_prefix(slot, match)
        total = -(-len(feed) // self.page_size)
        if total > len(pages):
            self._alloc_pages(slot, total - len(pages))
        B = self.max_seqs
        G = self._bucket_for(n)
        tokens = np.zeros((B, G), np.int32)
        tokens[slot, :n] = suffix
        n_tok = np.zeros((B,), np.int32)
        n_tok[slot] = n
        active = np.zeros((B,), np.int32)
        active[slot] = 1
        parts = {"page_table": self.page_table, "lengths": self.lengths,
                 "tokens": tokens, "n_tok": n_tok, "active": active}
        self._fire("suffix_prefill", rids=[str(req.rid)])
        if self.lean:
            parts["need"] = np.array([slot * G + n - 1], np.int32)
            self.logit_rows += 1
            self.logit_rows_skipped += B * G - 1
        else:
            self.logit_rows += B * G
        d = self._stage(parts)
        self._cost_hint(n, 0 if req._resume else 1,
                        n * cached + n * (n + 1) // 2, cached + n)
        with _record_span("serving.prefill"):
            logits = verify_step(
                self.params, self.k_pool, self.v_pool, d["page_table"],
                d["lengths"], d["tokens"], d["n_tok"], d["active"] != 0,
                self.config, self.page_size, k_scale=self.k_scale,
                v_scale=self.v_scale, need_rows=d.get("need"),
                **self._tp)
        self.lengths[slot] = cached + n
        req.slot = slot
        req._admit_order = self._order
        self._order += 1
        self._attach(slot, req)
        self._note_prefix_admit(req, match)
        self._index_slot(slot, req)
        if req._resume:
            req._resume = False  # its next_token survived the preemption
        else:
            row = logits[0] if self.lean else logits[slot, n - 1]
            self._seed_first_token(slot, req,
                                   self._read((row.to(torch.float32),))[0])

    def run(self, max_steps=10000):
        steps = 0
        while (self._live or self._waiting) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    def run_pipelined(self, max_steps=10000):
        """The depth-1 double-buffered loop: launch step N+1 before
        consuming step N, so host bookkeeping overlaps the queued device
        work. Token-identical to `run()`, greedy and seeded sampling
        both, because sampling happens inside the step keyed by
        (seed, position). A spec engine runs `run()`: drafting needs the
        host-current context."""
        if self.spec_decode > 1:
            return self.run(max_steps=max_steps)
        pending = None
        steps = 0
        while steps < max_steps and (self._live or self._waiting
                                     or pending is not None):
            try:
                ticket = self.step_launch(carry=pending)
            except PipelineStall:
                self.step_finish(pending)
                pending = None
                ticket = self.step_launch()
            if pending is not None:
                self.step_finish(pending, inflight=ticket)
            pending = ticket
            steps += 1
        if pending is not None:
            self.step_finish(pending)
        return self.finished
