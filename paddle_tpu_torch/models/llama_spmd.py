"""Stacked Llama parameters and the single-device pretrain step
(counterpart of `paddle_tpu/models/llama_spmd.py`).

A parameter tree is a plain dict: `embed` (V, H), `final_norm` (H,),
`lm_head` (H, V) and `layers`, a dict of (L, ...) stacks — the layout
`unified_step` loops over and `forward` trains. The optimizer state has
the same nesting with {"m", "v", "master"} (fp32) at every leaf.

The train step runs on one device: causal flash attention on the
Hopper kernels of `ops/flash_attention.py` or, for packed documents (a
third batch element, doc_ids), the FlashMask kernels of
`ops/flashmask_attention.py`; activation checkpointing around each
layer (full, or `remat="dots"`: the matmul outputs saved), the loss
through the full logits or the fused linear+CE head (`fused_ce`,
`ops/fused.py`), gradient accumulation weighted by valid-token counts,
global-norm clipping and AdamW with fp32 master weights. Meshes of more
than one device, sequence parallelism and pipeline schedules raise
NotImplementedError naming their ROADMAP item."""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import DEFAULT_DEVICE, resolve_device
from ..ops.flash_attention import flash_attention_bhsd
from ..ops.flashmask_attention import flashmask_attention_bhsd
from ..ops.fused import fused_linear_cross_entropy
from ..ops.fused import rms_norm as _rms
from ..ops.fused import swiglu
from ..ops.rope import apply_rotary_emb, rope_cos_sin
from .llama import LlamaConfig
from .llama_serving import _not_ported

__all__ = ["init_params", "params_from_jax", "doc_end_indices",
           "decoder_layer", "forward",
           "loss_fn", "loss_sum_fn", "loss_and_grads", "init_opt_state",
           "adamw_update", "make_train_step"]


def init_params(config: LlamaConfig, seed=0, dtype=torch.float32,
                device=DEFAULT_DEVICE):
    """Random weights in the stacked layout, drawn from a seeded
    `torch.Generator` on `device` (normal, std `initializer_range`;
    norms ones). The numbers differ from the JAX package's
    `init_params` for the same seed; parity tests load the JAX
    package's weights through `params_from_jax` instead."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    H, F_, V, L = c.hidden_size, c.intermediate_size, c.vocab_size, \
        c.num_hidden_layers
    KV = c.num_key_value_heads * (H // c.num_attention_heads)
    std = c.initializer_range

    def w(*shape):
        # drawn straight in `dtype`: a full-width bf16 model never
        # holds an fp32 copy of its largest stack
        return torch.empty(shape, dtype=dtype, device=dev).normal_(
            0.0, std, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return {
        "embed": w(V, H),
        "final_norm": ones(H),
        "lm_head": w(H, V),
        "layers": {
            "ln1": ones(L, H),
            "wq": w(L, H, H),
            "wk": w(L, H, KV),
            "wv": w(L, H, KV),
            "wo": w(L, H, H),
            "ln2": ones(L, H),
            "w_gate": w(L, H, F_),
            "w_up": w(L, H, F_),
            "w_down": w(L, F_, H),
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


def decoder_layer(lp, h, rope, config: LlamaConfig):
    """One decoder layer. lp: the layer's weights (one slice of each
    stack); h: (B, S, H); rope: (cos, sin), each (S, head_dim), or (cos,
    sin, sri) with sri the (B, 1, S, 1) FlashMask indices of packed
    documents."""
    c = config
    cos, sin = rope[0], rope[1]
    sri = rope[2] if len(rope) > 2 else None
    nh, nkv = c.num_attention_heads, c.num_key_value_heads
    hd = c.hidden_size // nh
    b, s, H = h.shape

    x = _rms(h, lp["ln1"], c.rms_norm_eps)
    q = (x @ lp["wq"]).reshape(b, s, nh, hd).transpose(1, 2)
    k = (x @ lp["wk"]).reshape(b, s, nkv, hd).transpose(1, 2)
    v = (x @ lp["wv"]).reshape(b, s, nkv, hd).transpose(1, 2)
    q, k = apply_rotary_emb(q, k, cos[None, None], sin[None, None])
    rep = nh // nkv
    if rep > 1:
        # jnp.repeat(k, rep, axis=1): KV head j serves query heads
        # j*rep .. j*rep+rep-1 (Tensor.repeat would tile them instead)
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if sri is None:
        o = flash_attention_bhsd(q, k, v, causal=True)
    else:
        # packed documents: causal within each, blocked across them; the
        # kernels read the one (B, 1, S, 1) mask for every head in place
        o = flashmask_attention_bhsd(q, k, v, sri, causal=True)
    h = h + o.transpose(1, 2).reshape(b, s, H) @ lp["wo"]

    x = _rms(h, lp["ln2"], c.rms_norm_eps)
    return h + swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])


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


def forward(params, input_ids, config: LlamaConfig, remat=True,
            doc_ids=None, return_hidden=False):
    """-> logits (B, S, V) in the params' dtype. A Python loop over the
    stacked layers takes the place of `lax.scan`; with `remat`, each
    layer runs under `torch.utils.checkpoint` (non-reentrant), as
    `jax.checkpoint` wraps it: its activations are recomputed in the
    backward pass. `remat="dots"` saves the outputs of the layer's
    matmuls and recomputes the rest (selective checkpointing).

    doc_ids: optional (B, S) contiguous document ids of packed
    sequences: attention stays causal within a document and is blocked
    across documents by the FlashMask kernels (no dense mask); the mask
    indices are computed once and handed to every layer.

    return_hidden: return the final-normed hidden states (B, S, H)
    without the lm_head product, for the fused linear+CE loss."""
    c = config
    s = input_ids.shape[1]
    cos, sin = rope_cos_sin(s, c.hidden_size // c.num_attention_heads,
                            c.rope_theta, torch.float32,
                            device=input_ids.device)
    rope = (cos, sin) if doc_ids is None else (cos, sin,
                                               doc_end_indices(doc_ids))
    h = F.embedding(input_ids, params["embed"])
    names = sorted(params["layers"])
    # one unbind per stack: its backward stacks the layers' gradients
    # in one go, where indexing would add L full-size zero tensors
    stacks = [torch.unbind(params["layers"][n]) for n in names]
    for slices in zip(*stacks):
        lp = dict(zip(names, slices))
        if remat == "dots":
            h = checkpoint(decoder_layer, lp, h, rope, c,
                           use_reentrant=False, context_fn=_dots_contexts)
        elif remat:
            h = checkpoint(decoder_layer, lp, h, rope, c,
                           use_reentrant=False)
        else:
            h = decoder_layer(lp, h, rope, c)
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


def _fused_masked_nll(h, lm_head, labels, chunk=FUSED_CE_CHUNK):
    """(nll_sum, valid_count) through `fused_linear_cross_entropy`: the
    (B, S, V) logits are never held. The same numbers as
    `_masked_nll(h @ lm_head, labels)`, with fp32 logits."""
    b, s, hidden = h.shape
    lab = labels.reshape(b * s).long()
    valid = lab >= 0
    per_tok = fused_linear_cross_entropy(
        h.reshape(b * s, hidden), lm_head, torch.where(valid, lab, 0),
        chunk_size=chunk, reduction="none")
    return torch.where(valid, per_tok, 0.0).sum(), valid.float().sum()


def _resolve_fused_ce(fused_ce):
    """None: the PT_FUSED_CE environment variable ("1" turns it on), as
    in the JAX package."""
    if fused_ce is None:
        return os.environ.get("PT_FUSED_CE", "0") == "1"
    return bool(fused_ce)


def loss_sum_fn(params, batch, config, remat=True, fused_ce=False):
    """(nll_sum, valid_count) of batch = (input_ids, labels) or
    (input_ids, labels, doc_ids) for packed documents: the
    gradient-accumulation path sums these, so microbatches are weighted
    by their valid-token counts. fused_ce=True takes the loss through
    the fused linear+CE head: the logits are never held."""
    input_ids, labels = batch[0], batch[1]
    doc_ids = batch[2] if len(batch) > 2 else None
    if fused_ce:
        h = forward(params, input_ids, config, remat, doc_ids,
                    return_hidden=True)
        return _fused_masked_nll(h, params["lm_head"], labels)
    return _masked_nll(forward(params, input_ids, config, remat, doc_ids),
                       labels)


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
                   fused_ce=False):
    """(loss, grads) of the mean NLL, as the train step computes them
    before clipping: grads is a tree like `params`, in the params' dtype
    for the one-shot step and in fp32 with `n_micro` > 1, where the
    batch is cut into n_micro equal microbatches whose summed NLL and
    valid counts are accumulated (fp32) and divided at the end, so the
    result equals the one-shot step's even with uneven ignore labels.
    Every batch element (doc_ids too) is cut the same way. `params` is
    not modified and need not require grad."""
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
                 wd=0.1):
    """AdamW with fp32 moments and master weights, IN PLACE: m, v and
    master of `state` and then every leaf of `params` (cast from master)
    are overwritten, leaf by leaf, so the update's temporaries are the
    size of one leaf. Weight decay applies to every leaf, norms and
    embedding included. Returns (params, state), the same objects.

    The bias corrections use t = step + 1 in fp32, as the JAX package
    does, computed on the host so that every device uses the same
    values."""
    t = np.float32(int(step)) + np.float32(1.0)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
    with torch.no_grad():
        for p, g, s in zip(_leaves(params), _leaves(grads),
                           _leaf_states(params, state)):
            g = g.float()
            s["m"].mul_(b1).add_(g, alpha=1 - b1)
            s["v"].mul_(b2).addcmul_(g, g, value=1 - b2)
            # lr * mhat / (sqrt(vhat) + eps)
            upd = (s["m"] / bc1).mul_(lr).div_(
                (s["v"] / bc2).sqrt_().add_(eps))
            s["master"].mul_(1 - lr * wd).sub_(upd)
            p.copy_(s["master"])
    return params, state


def make_train_step(config, mesh=None, n_micro=None, remat=True,
                    clip_norm=1.0, lr=3e-4, sp_axis=None, schedule=None,
                    fused_ce=None, device=DEFAULT_DEVICE):
    """Build the single-device train step

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
    accumulation over that many microbatches. clip_norm: global
    gradient-norm clip (None: off); the clip scale is fp32, so clipped
    bf16 gradients become fp32 as in the JAX step. AdamW as in
    `adamw_update`, at `lr`.

    `mesh` is accepted when it holds one device (a JAX `Mesh`, or any
    object whose `devices` is an array of devices). A larger mesh (with
    or without doc_ids), `sp_axis` and `schedule` raise
    NotImplementedError."""
    dev = resolve_device(device)
    for on, what, item in (
            (mesh is not None and np.size(mesh.devices) > 1,
             "a mesh of more than one device (doc_ids or not)", 12),
            (sp_axis is not None, "sequence parallelism (sp_axis=)", 12),
            (schedule is not None, "pipeline schedules (schedule=)", 12)):
        if on:
            raise _not_ported(what, item)
    fused_ce = _resolve_fused_ce(fused_ce)

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
        loss, grads = loss_and_grads(params, batch, config, n_micro, remat,
                                     fused_ce)
        if clip_norm is not None:
            flat = _leaves(grads)
            gn = torch.sqrt(sum((g.float() ** 2).sum() for g in flat))
            scale = clip_norm / torch.clamp_min(gn, clip_norm)
            grads = _rebuild(grads, (g.float() * scale for g in flat))
        adamw_update(params, grads, opt_state, lr, step)
        return params, opt_state, loss

    return step_fn
