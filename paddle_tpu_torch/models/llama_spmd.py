"""Stacked Llama parameters and the pretrain step, on one device or on a
mesh of ranks (counterpart of `paddle_tpu/models/llama_spmd.py`).

A parameter tree is a plain dict: `embed` (V, H), `final_norm` (H,),
`lm_head` (H, V) and `layers`, a dict of (L, ...) stacks — the layout
`unified_step` loops over and `forward` trains. The optimizer state has
the same nesting with {"m", "v", "master"} (fp32) at every leaf.

The train step: causal flash attention on the Hopper kernels of
`ops/flash_attention.py` or, for packed documents (a third batch
element, doc_ids), the FlashMask kernels of `ops/flashmask_attention.py`;
activation checkpointing around each layer (full, or `remat="dots"`:
the matmul outputs saved), the loss through the full logits or the
fused linear+CE head (`fused_ce`, `ops/fused.py`), gradient accumulation
weighted by valid-token counts, global-norm clipping and AdamW with
fp32 master weights.

On a rank mesh (`parallel/mesh.py`; ranks are processes on
torch.distributed) the same step runs hybrid-parallel, each rank on its
shard of the tree (`param_specs`, `place_params`, `gather_params`):
tensor parallelism over `tp` (Megatron: column-split q/k/v, gate and up,
row-split o and down, a vocabulary-parallel embedding and head with
the cross entropy's max, sum of exponentials and target logit reduced
over the axis), data parallelism over the batch axes of `batch_spec`,
sequence parallelism over `sp_axis` (ring or Ulysses attention, each
rank's RoPE rows at its positions) and pipeline parallelism over `pp`
(GPipe through `forward`, or 1F1B and interleaved 1F1B through the
hand-seeded schedules of `parallel/pp.py`). Where GSPMD inserts
collectives in the JAX package, the ranks make explicit calls of
`distributed/collective.py`."""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import DEFAULT_DEVICE, resolve_device
from ..distributed import collective as C
from ..ops.flash_attention import flash_attention_bhsd
from ..ops.flashmask_attention import flashmask_attention_bhsd
from ..ops.fused import fused_linear_cross_entropy
from ..ops.fused import rms_norm as _rms
from ..ops.fused import swiglu
from ..ops.rope import apply_rotary_emb, rope_cos_sin
from ..parallel import mesh as MESH
from ..parallel import pp as PP
from ..parallel import tp as TP
from ..parallel.mesh import P, RankMesh
from ..parallel.ring import ring_attention_local
from ..parallel.ulysses import ulysses_attention_local
from .llama import LlamaConfig

__all__ = ["init_params", "params_from_jax", "param_specs", "place_params",
           "gather_params", "doc_end_indices",
           "decoder_layer", "forward",
           "loss_fn", "loss_sum_fn", "loss_and_grads", "init_opt_state",
           "adamw_update", "make_train_step"]


def init_params(config: LlamaConfig, seed=0, dtype=torch.float32,
                device=DEFAULT_DEVICE, mesh=None):
    """Random weights in the stacked layout, drawn from a seeded
    `torch.Generator` on `device` (normal, std `initializer_range`;
    norms ones). The numbers differ from the JAX package's
    `init_params` for the same seed; parity tests load the JAX
    package's weights through `params_from_jax` instead.

    With a rank `mesh`, each leaf is cut to this rank's shard as soon as
    it is drawn: the numbers of `place_params(init_params(...), config,
    mesh)`, without the whole tree ever on the device (at 8B in bf16
    the largest leaf is 3.8 GB of the 16 GB)."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    H, F_, V, L = c.hidden_size, c.intermediate_size, c.vocab_size, \
        c.num_hidden_layers
    KV = c.num_key_value_heads * (H // c.num_attention_heads)
    std = c.initializer_range
    specs = None
    if mesh is not None:
        specs = param_specs(c, mesh, pp=_stages(mesh, None, None)[0])

    def cut(t, path):
        if specs is None:
            return t
        spec = specs
        for k in path:
            spec = spec[k]
        return _shard(t, spec, mesh)

    def w(shape, *path):
        # drawn straight in `dtype`: a full-width bf16 model never
        # holds an fp32 copy of its largest stack
        return cut(torch.empty(shape, dtype=dtype, device=dev).normal_(
            0.0, std, generator=gen), path)

    def ones(shape, *path):
        return cut(torch.ones(shape, dtype=dtype, device=dev), path)

    return {
        "embed": w((V, H), "embed"),
        "final_norm": ones((H,), "final_norm"),
        "lm_head": w((H, V), "lm_head"),
        "layers": {
            "ln1": ones((L, H), "layers", "ln1"),
            "wq": w((L, H, H), "layers", "wq"),
            "wk": w((L, H, KV), "layers", "wk"),
            "wv": w((L, H, KV), "layers", "wv"),
            "wo": w((L, H, H), "layers", "wo"),
            "ln2": ones((L, H), "layers", "ln2"),
            "w_gate": w((L, H, F_), "layers", "w_gate"),
            "w_up": w((L, H, F_), "layers", "w_up"),
            "w_down": w((L, F_, H), "layers", "w_down"),
        },
    }


def _to_tensor(a, dev, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own (ml_dtypes supplies it) and
        # torch.from_numpy refuses it: move the raw bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C"))  # a writable copy
    return t.to(device=dev, dtype=dtype if dtype is not None else t.dtype)


def params_from_jax(np_tree, device, dtype=None):
    """A tree of the JAX package, given as numpy arrays
    (`jax.tree.map(np.asarray, tree)`), as the port's: the same nested
    dict of tensors on `device`, cast to `dtype` when given. It takes
    the parameter tree and, as well, the optimizer state of
    `init_opt_state` ({"m", "v", "master"} at every leaf), so a JAX
    training run can be continued here."""
    dev = resolve_device(device)
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, dev, dtype) for k, v in np_tree.items()}
    return _to_tensor(np_tree, dev, dtype)


# ---------------------------------------------------------------- forward
def doc_end_indices(doc_ids):
    """(B, S) contiguous per-token document ids -> (B, 1, S, 1) int32
    FlashMask startend_row_indices: for key column j, the first row that
    must NOT attend to it (its document's end), a reverse running
    minimum of the per-position end candidates."""
    b, s = doc_ids.shape
    idx = torch.arange(s, device=doc_ids.device)
    is_last = torch.cat([doc_ids[:, 1:] != doc_ids[:, :-1],
                         torch.ones((b, 1), dtype=torch.bool,
                                    device=doc_ids.device)], dim=1)
    cand = torch.where(is_last, idx + 1, s + 1)
    end = torch.cummin(cand.flip(1), dim=1).values.flip(1)
    return end.to(torch.int32)[:, None, :, None]


def decoder_layer(lp, h, rope, config: LlamaConfig, par=None):
    """One decoder layer. lp: the layer's weights (one slice of each
    stack); h: (B, S, H); rope: (cos, sin), each (S, head_dim), or (cos,
    sin, sri) with sri the (B, 1, S, 1) FlashMask indices of packed
    documents.

    par: this rank's place on a mesh (`_Plan`), or None on one device.
    Under tensor parallelism lp holds the rank's columns of wq, wk, wv,
    w_gate and w_up and rows of wo and w_down (a contiguous block of
    query heads and the matching block of KV heads): the normed input
    enters through `copy_to_group` and the two output products leave
    through `reduce_from_group`. Under sequence parallelism h is the
    rank's block of the sequence and attention runs over the sp group
    (ring or Ulysses)."""
    c = config
    cos, sin = rope[0], rope[1]
    sri = rope[2] if len(rope) > 2 else None
    hd = c.hidden_size // c.num_attention_heads
    b, s, _ = h.shape
    tp = par.tp if par is not None else None
    sp = par.sp if par is not None else None
    nh, nkv = lp["wq"].shape[-1] // hd, lp["wk"].shape[-1] // hd

    x = _rms(h, lp["ln1"], c.rms_norm_eps)
    if tp is not None:
        x = C.copy_to_group(x, tp)
    q = (x @ lp["wq"]).reshape(b, s, nh, hd).transpose(1, 2)
    k = (x @ lp["wk"]).reshape(b, s, nkv, hd).transpose(1, 2)
    v = (x @ lp["wv"]).reshape(b, s, nkv, hd).transpose(1, 2)
    q, k = apply_rotary_emb(q, k, cos[None, None], sin[None, None])
    rep = nh // nkv
    ulysses = sp is not None and par.sp_impl == "ulysses"
    if rep > 1 and not ulysses:
        # jnp.repeat(k, rep, axis=1): KV head j serves query heads
        # j*rep .. j*rep+rep-1 (Tensor.repeat would tile them instead);
        # Ulysses moves K/V at KV width and repeats after its re-shard
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if sp is not None:
        attn = ulysses_attention_local if ulysses else ring_attention_local
        o = attn(q, k, v, sp, causal=True)
    elif sri is None:
        o = flash_attention_bhsd(q, k, v, causal=True)
    else:
        # packed documents: causal within each, blocked across them; the
        # kernels read the one (B, 1, S, 1) mask for every head in place
        o = flashmask_attention_bhsd(q, k, v, sri, causal=True)
    o = o.transpose(1, 2).reshape(b, s, nh * hd) @ lp["wo"]
    if tp is not None:
        o = C.reduce_from_group(o, tp)
    h = h + o

    x = _rms(h, lp["ln2"], c.rms_norm_eps)
    if tp is None:
        return h + swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
    x = C.copy_to_group(x, tp)
    return h + C.reduce_from_group(
        swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"]), tp)


# the plain 2-D matmuls a layer runs (its projections, and the 3-D by
# 2-D products torch folds into them)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """`remat="dots"`: keep the outputs of the plain 2-D matmuls and
    recompute everything else, as `dots_with_no_batch_dims_saveable`
    does in JAX. The attention kernels' outputs are not the
    dispatcher's to see, so their forward runs again, as under full
    remat (JAX's policy saves no Pallas output either)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_dots)


def _layer_fn(config, remat, par):
    """layer(lp, h, rope) under the remat policy: each layer under
    `torch.utils.checkpoint` (non-reentrant), as `jax.checkpoint` wraps
    it, or with `remat="dots"` its matmul outputs saved."""
    def layer(lp, h, rope):
        if remat == "dots":
            return checkpoint(decoder_layer, lp, h, rope, config, par,
                              use_reentrant=False, context_fn=_dots_contexts)
        if remat:
            return checkpoint(decoder_layer, lp, h, rope, config, par,
                              use_reentrant=False)
        return decoder_layer(lp, h, rope, config, par)
    return layer


def _rope(config, ids, doc_ids, par):
    """(cos, sin[, sri]) for this rank's tokens: under sequence
    parallelism the rows of its block of positions."""
    s = ids.shape[1]
    n, r = (par.sp_size, par.sp_rank) if par is not None else (1, 0)
    cos, sin = rope_cos_sin(s * n, config.hidden_size
                            // config.num_attention_heads,
                            config.rope_theta, torch.float32,
                            device=ids.device)
    cos, sin = cos[r * s:(r + 1) * s], sin[r * s:(r + 1) * s]
    return (cos, sin) if doc_ids is None else (cos, sin,
                                               doc_end_indices(doc_ids))


def _embed(ids, embed, par):
    """The token lookup; under tensor parallelism over this rank's rows
    of the vocabulary, the other rows zero, summed over the axis."""
    if par is None or par.tp is None:
        return F.embedding(ids, embed)
    return TP.vocab_parallel_embedding(ids, embed, par.tp)


def forward(params, input_ids, config: LlamaConfig, remat=True,
            doc_ids=None, return_hidden=False):
    """-> logits (B, S, V) in the params' dtype, on one device. A Python
    loop over the stacked layers takes the place of `lax.scan`; with
    `remat`, each layer runs under `torch.utils.checkpoint`
    (non-reentrant), as `jax.checkpoint` wraps it: its activations are
    recomputed in the backward pass. `remat="dots"` saves the outputs of
    the layer's matmuls and recomputes the rest (selective
    checkpointing).

    doc_ids: optional (B, S) contiguous document ids of packed
    sequences: attention stays causal within a document and is blocked
    across documents by the FlashMask kernels (no dense mask); the mask
    indices are computed once and handed to every layer.

    return_hidden: return the final-normed hidden states (B, S, H)
    without the lm_head product, for the fused linear+CE loss.

    On a rank mesh the train step runs this rank's part through the
    same code (`make_train_step`)."""
    return _forward(params, input_ids, config, remat, doc_ids,
                    return_hidden)


def _forward(params, input_ids, config, remat=True, doc_ids=None,
             return_hidden=False, par=None):
    """`forward` on this rank's tokens and shard of the tree; with a
    pipeline axis, the layers run as GPipe (`pipeline_apply`, n_micro
    microbatches) and the output comes back on every stage."""
    c = config
    rope = _rope(c, input_ids, doc_ids, par)
    h = _embed(input_ids, params["embed"], par)
    layer = _layer_fn(c, remat, par)
    if par is not None and par.pp is not None:
        h = PP.pipeline_apply(params["layers"], h, layer, par.mesh, "pp",
                              par.n_micro, rope)
    else:
        # one unbind per stack: its backward stacks the layers' gradients
        # in one go, where indexing would add L full-size zero tensors
        h = PP.stage_forward(params["layers"], h, layer, rope)
    h = _rms(h, params["final_norm"], c.rms_norm_eps)
    return h if return_hidden else h @ params["lm_head"]


def _masked_nll(logits, labels):
    """-> (nll_sum, valid_count), both fp32: summed next-token NLL over
    labels >= 0 (labels < 0 are the ignore sentinel)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logp, -1, labels.clamp_min(0).long()[..., None])
    valid = (labels >= 0).float()
    return -(picked[..., 0] * valid).sum(), valid.sum()


# vocabulary columns a chunk of the fused linear+CE head takes: the live
# (N, chunk) fp32 logits of an 8192-token row are 268 MB, against 4.2 GB
# for all 128,256 columns
FUSED_CE_CHUNK = 8192


def _fused_masked_nll(h, lm_head, labels, chunk=FUSED_CE_CHUNK, tp=None):
    """(nll_sum, valid_count) through `fused_linear_cross_entropy`: the
    (B, S, V) logits are never held. The same numbers as
    `_masked_nll(h @ lm_head, labels)`, with fp32 logits. tp: the group
    that splits lm_head's vocabulary columns (each chunk then covers
    this rank's columns, the max, the sum of exponentials and the target
    logit reduced over the group)."""
    b, s, hidden = h.shape
    lab = labels.reshape(b * s).long()
    valid = lab >= 0
    per_tok = fused_linear_cross_entropy(
        h.reshape(b * s, hidden), lm_head, torch.where(valid, lab, 0),
        chunk_size=chunk, reduction="none", group=tp)
    return torch.where(valid, per_tok, 0.0).sum(), valid.float().sum()


def _resolve_fused_ce(fused_ce):
    """None: the PT_FUSED_CE environment variable ("1" turns it on), as
    in the JAX package."""
    if fused_ce is None:
        return os.environ.get("PT_FUSED_CE", "0") == "1"
    return bool(fused_ce)


def _tp_masked_nll(h, lm_head, labels, par):
    """(nll_sum, valid_count) with the vocabulary split over the tp
    axis: this rank's logits (h @ its columns of lm_head, fp32), the
    row max and the sum of exponentials reduced over the axis, the
    target logit taken from the rank that owns it. The same numbers as
    `_masked_nll` of the full logits, replicated over the axis."""
    h = C.copy_to_group(h, par.tp)
    nll = TP.vocab_parallel_nll((h @ lm_head).float(), labels.clamp_min(0),
                                par.tp)
    valid = (labels >= 0).float()
    return (nll * valid).sum(), valid.sum()


def _head_nll(h, head, labels, config, fused_ce, par):
    """(nll_sum, valid_count) of the final-normed hidden states h."""
    tp = par.tp if par is not None else None
    if fused_ce:
        return _fused_masked_nll(h, head["lm_head"], labels, tp=tp)
    if tp is not None:
        return _tp_masked_nll(h, head["lm_head"], labels, par)
    return _masked_nll(h @ head["lm_head"], labels)


def loss_sum_fn(params, batch, config, remat=True, fused_ce=False):
    """(nll_sum, valid_count) of batch = (input_ids, labels) or
    (input_ids, labels, doc_ids) for packed documents: the
    gradient-accumulation path sums these, so microbatches are weighted
    by their valid-token counts. fused_ce=True takes the loss through
    the fused linear+CE head: the logits are never held."""
    return _loss_sum(params, batch, config, remat, fused_ce)


def _loss_sum(params, batch, config, remat=True, fused_ce=False, par=None):
    input_ids, labels = batch[0], batch[1]
    doc_ids = batch[2] if len(batch) > 2 else None
    h = _forward(params, input_ids, config, remat, doc_ids,
                 return_hidden=True, par=par)
    return _head_nll(h, params, labels, config, fused_ce, par)


def loss_fn(params, batch, config, remat=True, fused_ce=False):
    """Mean NLL over the labels >= 0 of batch = (input_ids, labels[,
    doc_ids])."""
    s, n = loss_sum_fn(params, batch, config, remat, fused_ce)
    return s / n.clamp_min(1.0)


# ---------------------------------------------------------------- training
def _leaves(tree):
    """Tensors of a nested dict, in sorted-key order (as jax.tree
    flattens a dict)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def _leaf_states(params, state):
    """The optimizer state's {"m", "v", "master"} dict of every leaf of
    `params`, in `_leaves` order."""
    if isinstance(params, dict):
        return [s for k in sorted(params)
                for s in _leaf_states(params[k], state[k])]
    return [state]


def loss_and_grads(params, batch, config, n_micro=None, remat=True,
                   fused_ce=False, mesh=None, batch_spec=P("dp"),
                   sp_axis=None, schedule=None, vpp=2, sp_impl="ring"):
    """(loss, grads) of the mean NLL, as the train step computes them
    before clipping: grads is a tree like `params`, in the params' dtype
    for the one-shot step and in fp32 with `n_micro` > 1, where the
    batch is cut into n_micro equal microbatches whose summed NLL and
    valid counts are accumulated (fp32) and divided at the end, so the
    result equals the one-shot step even with uneven ignore labels.
    Every batch element (doc_ids too) is cut the same way. `params` is
    not modified and need not require grad.

    With a rank mesh (and its options, as `make_train_step` takes them)
    params is this rank's shard (placed as the step expects), batch the
    global batch, and the result the global loss and this rank's
    gradients, summed over the data axes."""
    if mesh is not None:
        plan = _Plan(config, mesh, batch_spec, n_micro, remat, sp_axis,
                     schedule, fused_ce, vpp, sp_impl)
        return plan.loss_and_grads(params, batch)
    flat = _leaves(params)
    # detached aliases share the storage, so the caller's tensors keep
    # requires_grad False and are never part of a graph
    leaves = [p.detach().requires_grad_() for p in flat]
    tree = _rebuild(params, iter(leaves))
    with torch.enable_grad():
        if n_micro and n_micro > 1:
            B = batch[0].shape[0]
            if B % n_micro:
                raise ValueError(f"batch {B} not divisible by "
                                 f"n_micro={n_micro}")
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
            tot_s = tot_n = 0.0
            for micro in zip(*(x.chunk(n_micro) for x in batch)):
                s, n = loss_sum_fn(tree, micro, config, remat, fused_ce)
                for acc, g in zip(grads, torch.autograd.grad(s, leaves)):
                    acc.add_(g)
                tot_s = tot_s + s.detach()
                tot_n = tot_n + n
            denom = tot_n.clamp_min(1.0)
            loss = tot_s / denom
            for g in grads:
                g.div_(denom)
        else:
            loss = loss_fn(tree, batch, config, remat, fused_ce)
            grads = list(torch.autograd.grad(loss, leaves))
    return loss.detach(), _rebuild(params, iter(grads))


def init_opt_state(params):
    """{"m": 0, "v": 0, "master": fp32 copy} at every leaf, all fp32.
    master is a copy even for fp32 params: the step updates both in
    place."""
    if isinstance(params, dict):
        return {k: init_opt_state(v) for k, v in params.items()}
    return {"m": torch.zeros_like(params, dtype=torch.float32),
            "v": torch.zeros_like(params, dtype=torch.float32),
            "master": params.to(torch.float32, copy=True)}


def adamw_update(params, grads, state, lr, step, b1=0.9, b2=0.95, eps=1e-8,
                 wd=0.1, grad_scale=None):
    """AdamW with fp32 moments and master weights, IN PLACE: m, v and
    master of `state` and then every leaf of `params` (cast from master)
    are overwritten, leaf by leaf, so the update's temporaries are the
    size of one leaf. Weight decay applies to every leaf, norms and
    embedding included. Returns (params, state), the same objects.
    grad_scale: a factor (the clip's) each gradient takes as it is cast
    to fp32, leaf by leaf.

    The bias corrections use t = step + 1 in fp32, as the JAX package
    does, computed on the host so that every device uses the same
    values."""
    t = np.float32(int(step)) + np.float32(1.0)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
    with torch.no_grad():
        for leaf in zip(_leaves(params), _leaves(grads),
                        _leaf_states(params, state)):
            # elementwise, so a large leaf goes in slices: the fp32
            # temporaries stay the size of one slice
            p, g, st = leaf
            for p, g, m, v, master in zip(
                    _slices(p), g.reshape(-1).split(SLICE), _slices(st["m"]),
                    _slices(st["v"]), _slices(st["master"])):
                g = g.float() if grad_scale is None else \
                    g.float() * grad_scale
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                # lr * mhat / (sqrt(vhat) + eps)
                upd = (m / bc1).mul_(lr).div_((v / bc2).sqrt_().add_(eps))
                master.mul_(1 - lr * wd).sub_(upd)
                p.copy_(master)
    return params, state


# elements a slice of a large leaf takes through the optimizer and the
# norm (64 Mi: 256 MB of fp32 temporaries)
SLICE = 1 << 26


def _slices(t):
    """Views of contiguous `t` (written in place), flat, in slices of
    SLICE elements."""
    return t.view(-1).split(SLICE)


def _sumsq(g):
    """The fp32 sum of squares of g, slice by slice."""
    return sum((x.float() ** 2).sum() for x in g.reshape(-1).split(SLICE))


# ------------------------------------------------------------ the rank mesh
def param_specs(config, mesh, pp=False, fsdp_axis=None):
    """PartitionSpecs of the tree: Megatron tensor parallelism on the
    weight axes, the stacked layer axis over 'pp' when pipelining (as the
    JAX package's `param_specs`)."""
    tp = "tp" if "tp" in mesh.shape else None
    ppax = "pp" if (pp and "pp" in mesh.shape) else None
    return {
        "embed": P(tp, None),
        "final_norm": P(),
        "lm_head": P(None, tp),
        "layers": {
            "ln1": P(ppax, None),
            "wq": P(ppax, None, tp),
            "wk": P(ppax, None, tp),
            "wv": P(ppax, None, tp),
            "wo": P(ppax, tp, None),
            "ln2": P(ppax, None),
            "w_gate": P(ppax, None, tp),
            "w_up": P(ppax, None, tp),
            "w_down": P(ppax, tp, None),
        },
    }


_spec_axes, _block, _shard = MESH.spec_axes, MESH.block, MESH.shard


def _map_specs(fn, tree, specs):
    """fn(leaf, spec) over a parameter tree, or an optimizer state tree
    ({"m", "v", "master"} at each leaf)."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, dict):
        return {k: fn(v, specs) for k, v in tree.items()}
    return fn(tree, specs)


def _stages(mesh, pp, vpp):
    """(pp ranks, chunks a rank) of the layer stack's placement: vpp
    chunks under the interleaved schedule, else one block."""
    if pp is None:
        pp = mesh.shape.get("pp", 1) > 1
    S = mesh.shape.get("pp", 1) if pp else 1
    return pp, S, (vpp if vpp and S > 1 else 1)


def _interleave_layers(a, n_stages, vpp):
    """A stacked (L, ...) leaf in the interleaved schedule's placement
    order: rank r's contiguous block of L / n_stages layers is its
    chunks r, r + S, ..., r + (vpp - 1) S, in that order."""
    grouped = PP.group_virtual_stages({"a": a}, n_stages, vpp)["a"]
    return grouped.reshape(a.shape)


def _deinterleave_layers(a, n_stages, vpp):
    """Inverse of `_interleave_layers`."""
    grouped = a.reshape(n_stages, vpp, -1, *a.shape[1:])
    return PP.ungroup_virtual_stages({"a": grouped}, n_stages, vpp)["a"]


def place_params(params, config, mesh, pp=None, vpp=None):
    """This rank's shard of every leaf of `params` (full tensors, the
    same on every rank), by `param_specs`: a copy, so the full tree can
    be dropped. Also takes an optimizer state tree. pp defaults to the
    mesh having a pp axis of more than one rank.

    vpp: for schedule="interleave", the chunks a stage runs (the step's
    `vpp`): each rank then holds its chunks of the layer stack, virtual
    stages r, r + S, ..., in that order (Megatron's placement), so the
    step runs them without moving layers between ranks. The step
    expects this placement under that schedule and the contiguous one
    (vpp None) under the others."""
    pp, S, v = _stages(mesh, pp, vpp)

    def shard(a, spec):
        if v > 1 and tuple(spec)[:1] == ("pp",):
            a = _interleave_layers(a, S, v)
        return _shard(a, spec, mesh)
    return _map_specs(shard, params, param_specs(config, mesh, pp=pp))


_gather = MESH.gather


def gather_params(params, config, mesh, pp=None, vpp=None):
    """The full tree from every rank's shard (collective: every rank
    calls it, and every rank gets the whole tree). Inverse of
    `place_params` with the same pp and vpp."""
    pp, S, v = _stages(mesh, pp, vpp)

    def gather(a, spec):
        a = _gather(a, spec, mesh)
        if v > 1 and tuple(spec)[:1] == ("pp",):
            a = _deinterleave_layers(a, S, v)
        return a
    return _map_specs(gather, params, param_specs(config, mesh, pp=pp))


_SCHEDULES = ("gpipe", "1f1b", "interleave")


def _fleet_schedule(vpp):
    """(schedule, vpp) for schedule=None: the initialised fleet
    strategy's (`fleet.pipeline_schedule`; its virtual_pp_degree under
    the interleaved schedule), else GPipe."""
    from ..distributed.fleet import fleet as _fleet
    if not _fleet._is_initialized:
        return "gpipe", vpp
    schedule = _fleet.pipeline_schedule()
    if schedule == "interleave":
        fleet_vpp = _fleet.virtual_pp_degree()
        if fleet_vpp <= 1:
            # never pick a virtual degree the user did not configure
            raise ValueError(
                "schedule_mode 'interleave' needs hybrid_configs "
                f"pp_configs virtual_pp_degree >= 2 (got {fleet_vpp}); "
                "set it, or pass vpp= explicitly with "
                "schedule='interleave'")
        vpp = fleet_vpp
    return schedule, vpp


class _Plan:
    """One rank's layout of the hybrid-parallel step: the mesh's groups,
    the batch's data axes, the checks the layout needs. Layers, the
    embedding and the loss read it as `par`: the tp, sp and pp groups
    (None where the axis is absent or of one rank), the sp scheme and
    this rank's block of the sequence, GPipe's microbatches."""

    def __init__(self, config, mesh, batch_spec, n_micro, remat, sp_axis,
                 schedule, fused_ce, vpp, sp_impl):
        if not isinstance(mesh, RankMesh):
            raise ValueError(
                "a mesh of more than one device must be a rank mesh "
                "(paddle_tpu_torch.parallel.create_mesh after "
                "init_parallel_env)")
        c = config
        self.config, self.mesh, self.n_micro = c, mesh, n_micro
        self.remat, self.fused_ce, self.vpp = remat, fused_ce, vpp
        self.sp_axis = sp_axis
        if schedule is None:
            schedule, vpp = _fleet_schedule(vpp)
            self.vpp = vpp
        if schedule not in _SCHEDULES:
            raise ValueError(f"schedule {schedule!r}: one of {_SCHEDULES}")
        self.schedule = schedule
        if sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"sp_impl {sp_impl!r}: 'ring' or 'ulysses'")
        size = mesh.shape.get
        group = lambda ax: mesh.group(ax) if size(ax, 1) > 1 else None  # noqa: E731
        self.tp, self.pp = group("tp"), group("pp")
        n_tp, n_pp = size("tp", 1), size("pp", 1)
        L = c.num_hidden_layers
        for what, n, m in (
                ("query heads", c.num_attention_heads, n_tp),
                ("KV heads", c.num_key_value_heads, n_tp),
                ("the vocabulary", c.vocab_size, n_tp),
                ("the FFN width", c.intermediate_size, n_tp),
                ("the layers", L, n_pp * (vpp if schedule == "interleave"
                                          and n_pp > 1 else 1))):
            if n % m:
                raise ValueError(f"{what} ({n}) do not divide over the mesh "
                                 f"({m}: tp={n_tp}, pp={n_pp})")
        # the batch's dims: dim 0 by batch_spec, dim 1 by sp_axis too
        spec = ([_spec_axes(e) for e in tuple(batch_spec)] + [(), ()])[:2]
        if sp_axis is not None:
            if sp_axis not in mesh.shape:
                raise ValueError(f"sp_axis {sp_axis!r} is not an axis of "
                                 f"the mesh {mesh.axis_names}")
            if sp_axis in spec[0]:
                raise ValueError(f"sp_axis {sp_axis!r} shards the sequence "
                                 "(dim 1), not the batch")
            if sp_axis not in spec[1]:
                spec[1] = spec[1] + (sp_axis,)
        for ax in spec[0] + spec[1]:
            if ax not in mesh.shape:
                raise ValueError(f"batch_spec axis {ax!r} is not an axis of "
                                 f"the mesh {mesh.axis_names}")
            if ax in ("tp", "pp"):
                raise ValueError(f"batch_spec shards the batch over {ax!r}, "
                                 "a model axis")
        self.batch_dims = spec
        self.data_groups = [mesh.group(ax) for ax in spec[0] + spec[1]
                            if size(ax, 1) > 1]
        self.sp = mesh.group(sp_axis) if sp_axis is not None else None
        self.sp_impl = sp_impl
        self.sp_size = self.sp.nranks if self.sp is not None else 1
        self.sp_rank = self.sp.rank if self.sp is not None else 0
        use_pp = self.pp is not None
        self.pipelined = use_pp and schedule in ("1f1b", "interleave")
        self.specs = param_specs(c, mesh, pp=use_pp)

    # -------------------------------------------------------------- batch
    def local(self, batch):
        """This rank's block of each (B, S) batch element."""
        out = []
        for x in batch:
            for dim, axes in enumerate(self.batch_dims):
                idx, n = _block(self.mesh, axes)
                if n > 1:
                    if x.shape[dim] % n:
                        raise ValueError(
                            f"batch dim {dim} ({x.shape[dim]}) does not "
                            f"divide over {axes}={n}")
                    x = x.chunk(n, dim)[idx]
            out.append(x)
        return tuple(out)

    def _refuse(self, batch):
        """The JAX package's refusals, with its exception and words, at
        the point of its step where it raises them."""
        docs, sp = len(batch) > 2, self.sp_axis is not None
        if self.pipelined:
            if docs:
                raise NotImplementedError(
                    "packed-document flashmask + 1F1B pipeline is not "
                    "supported yet (see forward()'s doc_ids + pp note)")
            if sp:
                raise NotImplementedError(
                    "sequence parallelism inside the 1F1B/interleave "
                    "pipeline is not supported (see forward()'s sp + pp "
                    "note)")
            return
        use_pp = self.pp is not None
        if docs and use_pp:
            raise NotImplementedError(
                "packed-document flashmask + pipeline parallelism: the "
                "per-row mask cannot ride the replicated pipeline extra "
                "yet — use doc_ids without pp, or pp without doc_ids")
        if docs and sp:
            raise NotImplementedError(
                "packed-document flashmask + sequence parallelism is "
                "not supported: neither the ring nor the ulysses "
                "context-parallel attention carries a document mask — "
                "drop sp_axis or doc_ids")
        if sp and use_pp:
            raise NotImplementedError(
                "sequence parallelism inside the pp pipeline is not "
                "supported: the attention's shard_map cannot nest inside "
                "the pipeline's — shard sequence on a pp=1 mesh, or drop "
                "sp_axis")

    # ----------------------------------------------------------- gradients
    def loss_and_grads(self, params, batch):
        """(global loss, this rank's gradients summed over the data
        axes) for the global `batch`."""
        self._refuse(batch)
        # every rank holds the global batch: the global count of valid
        # labels, the denominator of the loss, needs no communication
        n_total = (batch[1] >= 0).sum().float()
        local = self.local(batch)
        flat = _leaves(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        tree = _rebuild(params, iter(leaves))
        c, par = self.config, self
        with torch.enable_grad():
            if self.pipelined:
                s_part, grads = self._grads_pipelined(tree, local, n_total)
                denom = None
            elif self.n_micro and self.n_micro > 1 and self.pp is None:
                B = local[0].shape[0]
                if B % self.n_micro:
                    raise ValueError(f"this rank's batch {B} is not "
                                     f"divisible by n_micro={self.n_micro}")
                grads = [torch.zeros_like(p, dtype=torch.float32)
                         for p in flat]
                s_part = 0.0
                for micro in zip(*(x.chunk(self.n_micro) for x in local)):
                    s, _ = _loss_sum(tree, micro, c, self.remat,
                                     self.fused_ce, par)
                    for acc, g in zip(grads,
                                      torch.autograd.grad(s, leaves)):
                        acc.add_(g)
                    s_part = s_part + s.detach()
                denom = n_total.clamp_min(1.0)
                for g in grads:
                    g.div_(denom)
            else:
                s, _ = _loss_sum(tree, local, c, self.remat, self.fused_ce,
                                 par)
                denom = n_total.clamp_min(1.0)
                grads = list(torch.autograd.grad(s / denom, leaves))
                s_part = s.detach()
        s_part = torch.as_tensor(s_part, dtype=torch.float32,
                                 device=flat[0].device).clone()
        for g in self.data_groups:
            C.all_reduce_coalesced(grads, g)
            C.all_reduce(s_part, group=g)
        loss = s_part if denom is None else s_part / denom
        return loss, _rebuild(params, iter(grads))

    def _grads_pipelined(self, tree, batch, n_total):
        """(this rank's part of the loss, grads) through the hand-seeded
        1F1B or interleaved pipeline: the embedding lookup and its
        gradient run on every stage outside the pipeline, the final norm,
        lm_head and loss on the last stage (`head_fn`)."""
        c, par, mesh = self.config, self, self.mesh
        ids, labels = batch[0], batch[1]
        rope = _rope(c, ids, None, par)
        h0 = _embed(ids, tree["embed"], par)
        layer = _layer_fn(c, self.remat, par)
        fused_ce = self.fused_ce

        def head_fn(hp, h, tgt):
            hh = _rms(h, hp["final_norm"], c.rms_norm_eps)
            return _head_nll(hh, hp, tgt, c, fused_ce, par)

        head_p = {"final_norm": tree["final_norm"],
                  "lm_head": tree["lm_head"]}
        if self.schedule == "interleave":
            # the rank's layers are its chunks, in order (place_params
            # with vpp): (vpp, layers a chunk, ...) views of the stack
            chunks = {k: v.detach().reshape(self.vpp, -1, *v.shape[1:])
                      for k, v in tree["layers"].items()}
            loss, gstage, ghead, dx = PP.pipeline_train_interleaved(
                chunks, h0.detach(), labels, layer, head_fn, head_p, mesh,
                "pp", self.n_micro, self.vpp, rope, total_weight=n_total)
            g_layers = {k: g.reshape(-1, *g.shape[2:])
                        for k, g in gstage.items()}
        else:
            loss, g_layers, ghead, dx = PP.pipeline_train_1f1b(
                tree["layers"], h0.detach(), labels, layer, head_fn,
                head_p, mesh, "pp", self.n_micro, rope,
                total_weight=n_total)
        (g_embed,) = torch.autograd.grad(h0, [tree["embed"]],
                                         dx.to(h0.dtype))
        grads = {"embed": g_embed, "final_norm": ghead["final_norm"],
                 "lm_head": ghead["lm_head"], "layers": g_layers}
        return loss.detach(), _leaves(grads)

    # -------------------------------------------------------------- clip
    def grad_norm(self, grads):
        """The global gradient norm: each leaf's sum of squares counted
        once over the model axes it is replicated on (its shard 0 only),
        summed over the tp and pp groups."""
        model = [(ax, g) for ax, g in (("tp", self.tp), ("pp", self.pp))
                 if g is not None]
        sq = None
        for g, spec in zip(_leaves(grads), _leaves(self.specs)):
            axes = {a for e in spec for a in _spec_axes(e)}
            if any(ax not in axes and self.mesh.coord(ax) != 0
                   for ax, _ in model):
                continue
            part = _sumsq(g)
            sq = part if sq is None else sq + part
        if sq is None:
            sq = torch.zeros((), dtype=torch.float32,
                             device=_leaves(grads)[0].device)
        for _, grp in model:
            C.all_reduce(sq, group=grp)
        return torch.sqrt(sq)


def _is_single(mesh):
    return mesh is None or (not isinstance(mesh, RankMesh)
                            and np.size(mesh.devices) == 1)


def make_train_step(config, mesh=None, batch_spec=P("dp"), n_micro=None,
                    remat=True, clip_norm=1.0, lr=3e-4, sp_axis=None,
                    schedule=None, fused_ce=None, vpp=2, sp_impl="ring",
                    device=DEFAULT_DEVICE):
    """Build the train step

        step(params, opt_state, step, batch) -> (params, opt_state, loss)

    batch = (input_ids, labels) or (input_ids, labels, doc_ids) for
    packed documents, (B, S) integer tensors or arrays (moved to
    `device`); labels < 0 are ignored; loss is a 0-dim fp32 tensor on
    the device. params and opt_state must live on `device` and are
    updated IN PLACE: the JAX step donates both buffers, and the tensors
    returned are the ones passed in.

    remat: checkpoint each layer (True), save only its matmul outputs
    ("dots") or not (False). fused_ce: the loss through the fused
    linear+CE head (True), through the full logits (False), or as the
    PT_FUSED_CE environment variable says (None). n_micro > 1: gradient
    accumulation over that many microbatches (with a pp axis: the
    pipeline's microbatches). clip_norm: global gradient-norm clip
    (None: off); the clip scale is fp32, so clipped bf16 gradients
    become fp32 as in the JAX step. AdamW as in `adamw_update`, at `lr`.

    mesh: None (or a mesh of one device) for one device, else a rank
    mesh (`parallel.create_mesh`): then every rank calls the step with
    the global batch and its own shard of params and opt_state
    (`place_params`), takes its block of the batch by `batch_spec` (and
    of the sequence by `sp_axis`), and gets the global loss. sp_axis
    with sp_impl "ring" or "ulysses"; schedule (with a pp axis):
    "gpipe", "1f1b" or "interleave" with `vpp` chunks a stage, or None
    (the strategy's `fleet.pipeline_schedule()` once `fleet.init` ran,
    else "gpipe")
    (params and opt_state then placed with `place_params(..., vpp=vpp)`:
    each rank holds its chunks).
    Where the JAX step refuses a combination (doc_ids with pp or sp, sp
    with pp) this step raises the same NotImplementedError; a layout
    the ranks cannot split (tp not dividing the heads, the vocabulary
    or the FFN; pp (x vpp) not dividing the layers) raises ValueError.
    Under tp, fused_ce=True runs each chunk of the fused head over this
    rank's vocabulary columns: the logits are never gathered."""
    dev = resolve_device(device)
    fused_ce = _resolve_fused_ce(fused_ce)
    if _is_single(mesh):
        if sp_axis is not None:
            raise ValueError("sp_axis needs a rank mesh with that axis")
        plan = None
    else:
        plan = _Plan(config, mesh, batch_spec, n_micro, remat, sp_axis,
                     schedule, fused_ce, vpp, sp_impl)

    def step_fn(params, opt_state, step, batch):
        for t in _leaves(params) + _leaves(opt_state):
            if t.device != dev:
                raise ValueError(
                    f"params or optimizer state live on {t.device}, the "
                    f"step on {dev}: build them there (init_params(device=)"
                    " / params_from_jax(device=))")
        batch = tuple(torch.as_tensor(
            x if torch.is_tensor(x) else np.asarray(x), device=dev)
            for x in batch)
        if plan is None:
            loss, grads = loss_and_grads(params, batch, config, n_micro,
                                         remat, fused_ce)
        else:
            loss, grads = plan.loss_and_grads(params, batch)
        scale = None
        if clip_norm is not None:
            gn = (plan.grad_norm(grads) if plan is not None else
                  torch.sqrt(sum(_sumsq(g) for g in _leaves(grads))))
            scale = clip_norm / torch.clamp_min(gn, clip_norm)
        adamw_update(params, grads, opt_state, lr, step, grad_scale=scale)
        return params, opt_state, loss

    return step_fn
