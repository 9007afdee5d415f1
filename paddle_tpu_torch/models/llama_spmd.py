"""Stacked Llama parameters and the single-device pretrain step
(counterpart of `paddle_tpu/models/llama_spmd.py`).

A parameter tree is a plain dict: `embed` (V, H), `final_norm` (H,),
`lm_head` (H, V) and `layers`, a dict of (L, ...) stacks — the layout
`unified_step` loops over and `forward` trains. The optimizer state has
the same nesting with {"m", "v", "master"} (fp32) at every leaf.

The train step runs on one device: causal flash attention on the
Hopper kernels of `ops/flash_attention.py`, optional activation
checkpointing around each layer, gradient accumulation weighted by
valid-token counts, global-norm clipping and AdamW with fp32 master
weights. Meshes of more than one device, sequence parallelism, pipeline
schedules, packed documents (FlashMask), the fused linear+CE head and
`remat="dots"` raise NotImplementedError naming their ROADMAP item."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import DEFAULT_DEVICE, resolve_device
from ..ops.flash_attention import flash_attention_bhsd
from ..ops.fused import rms_norm as _rms
from ..ops.fused import swiglu
from ..ops.rope import apply_rotary_emb, rope_cos_sin
from .llama import LlamaConfig
from .llama_serving import _not_ported

__all__ = ["init_params", "params_from_jax", "decoder_layer", "forward",
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
def decoder_layer(lp, h, rope, config: LlamaConfig):
    """One decoder layer. lp: the layer's weights (one slice of each
    stack); h: (B, S, H); rope: (cos, sin), each (S, head_dim)."""
    c = config
    cos, sin = rope
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
    o = flash_attention_bhsd(q, k, v, causal=True)
    h = h + o.transpose(1, 2).reshape(b, s, H) @ lp["wo"]

    x = _rms(h, lp["ln2"], c.rms_norm_eps)
    return h + swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])


def _check_remat(remat):
    if remat == "dots":
        raise _not_ported('remat="dots" (save the matmul outputs)', "9c")


def forward(params, input_ids, config: LlamaConfig, remat=True):
    """-> logits (B, S, V) in the params' dtype. A Python loop over the
    stacked layers takes the place of `lax.scan`; with `remat`, each
    layer runs under `torch.utils.checkpoint` (non-reentrant), as
    `jax.checkpoint` wraps it: its activations are recomputed in the
    backward pass."""
    c = config
    _check_remat(remat)
    s = input_ids.shape[1]
    cos, sin = rope_cos_sin(s, c.hidden_size // c.num_attention_heads,
                            c.rope_theta, torch.float32,
                            device=input_ids.device)
    h = F.embedding(input_ids, params["embed"])
    names = sorted(params["layers"])
    # one unbind per stack: its backward stacks the layers' gradients
    # in one go, where indexing would add L full-size zero tensors
    stacks = [torch.unbind(params["layers"][n]) for n in names]
    for slices in zip(*stacks):
        lp = dict(zip(names, slices))
        if remat:
            h = checkpoint(decoder_layer, lp, h, (cos, sin), c,
                           use_reentrant=False)
        else:
            h = decoder_layer(lp, h, (cos, sin), c)
    h = _rms(h, params["final_norm"], c.rms_norm_eps)
    return h @ params["lm_head"]


def _masked_nll(logits, labels):
    """-> (nll_sum, valid_count), both fp32: summed next-token NLL over
    labels >= 0 (labels < 0 are the ignore sentinel)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = torch.gather(logp, -1, labels.clamp_min(0).long()[..., None])
    valid = (labels >= 0).float()
    return -(picked[..., 0] * valid).sum(), valid.sum()


def _check_batch(batch):
    if len(batch) > 2:
        raise _not_ported("packed-document training (doc_ids, a third "
                          "batch element, on the FlashMask kernels)", "9b")


def loss_sum_fn(params, batch, config, remat=True):
    """(nll_sum, valid_count) of batch = (input_ids, labels): the
    gradient-accumulation path sums these, so microbatches are weighted
    by their valid-token counts."""
    _check_batch(batch)
    input_ids, labels = batch[0], batch[1]
    return _masked_nll(forward(params, input_ids, config, remat), labels)


def loss_fn(params, batch, config, remat=True):
    """Mean NLL over the labels >= 0 of batch = (input_ids, labels)."""
    s, n = loss_sum_fn(params, batch, config, remat)
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


def loss_and_grads(params, batch, config, n_micro=None, remat=True):
    """(loss, grads) of the mean NLL, as the train step computes them
    before clipping: grads is a tree like `params`, in the params' dtype
    for the one-shot step and in fp32 with `n_micro` > 1, where the
    batch is cut into n_micro equal microbatches whose summed NLL and
    valid counts are accumulated (fp32) and divided at the end, so the
    result equals the one-shot step's even with uneven ignore labels.
    `params` is not modified and need not require grad."""
    _check_batch(batch)
    input_ids, labels = batch[0], batch[1]
    flat = _leaves(params)
    # detached aliases share the storage, so the caller's tensors keep
    # requires_grad False and are never part of a graph
    leaves = [p.detach().requires_grad_() for p in flat]
    tree = _rebuild(params, iter(leaves))
    with torch.enable_grad():
        if n_micro and n_micro > 1:
            B = input_ids.shape[0]
            if B % n_micro:
                raise ValueError(f"batch {B} not divisible by "
                                 f"n_micro={n_micro}")
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
            tot_s = tot_n = 0.0
            for ids, lab in zip(input_ids.chunk(n_micro),
                                labels.chunk(n_micro)):
                s, n = loss_sum_fn(tree, (ids, lab), config, remat)
                for acc, g in zip(grads, torch.autograd.grad(s, leaves)):
                    acc.add_(g)
                tot_s = tot_s + s.detach()
                tot_n = tot_n + n
            denom = tot_n.clamp_min(1.0)
            loss = tot_s / denom
            for g in grads:
                g.div_(denom)
        else:
            loss = loss_fn(tree, (input_ids, labels), config, remat)
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
                    fused_ce=False, device=DEFAULT_DEVICE):
    """Build the single-device train step

        step(params, opt_state, step, batch) -> (params, opt_state, loss)

    batch = (input_ids, labels), (B, S) integer tensors or arrays (moved
    to `device`); labels < 0 are ignored; loss is a 0-dim fp32 tensor on
    the device. params and opt_state must live on `device` and are
    updated IN PLACE: the JAX step donates both buffers, and the tensors
    returned are the ones passed in.

    remat: checkpoint each layer (True) or not (False). n_micro > 1:
    gradient accumulation over that many microbatches. clip_norm: global
    gradient-norm clip (None: off); the clip scale is fp32, so clipped
    bf16 gradients become fp32 as in the JAX step. AdamW as in
    `adamw_update`, at `lr`.

    `mesh` is accepted when it holds one device (a JAX `Mesh`, or any
    object whose `devices` is an array of devices). A larger mesh,
    `sp_axis`, `schedule`, `fused_ce=True` and `remat="dots"` raise
    NotImplementedError, as does a batch with doc_ids."""
    dev = resolve_device(device)
    for on, what, item in (
            (mesh is not None and np.size(mesh.devices) > 1,
             "a mesh of more than one device", 12),
            (sp_axis is not None, "sequence parallelism (sp_axis=)", 12),
            (schedule is not None, "pipeline schedules (schedule=)", 12),
            (bool(fused_ce), "the fused linear+CE head (fused_ce=True)",
             "9c")):
        if on:
            raise _not_ported(what, item)
    _check_remat(remat)

    def step_fn(params, opt_state, step, batch):
        _check_batch(batch)
        for t in _leaves(params) + _leaves(opt_state):
            if t.device != dev:
                raise ValueError(
                    f"params or optimizer state live on {t.device}, the "
                    f"step on {dev}: build them there (init_params(device=)"
                    " / params_from_jax(device=))")
        ids, labels = (torch.as_tensor(
            x if torch.is_tensor(x) else np.asarray(x), device=dev)
            for x in batch)
        loss, grads = loss_and_grads(params, (ids, labels), config, n_micro,
                                     remat)
        if clip_norm is not None:
            flat = _leaves(grads)
            gn = torch.sqrt(sum((g.float() ** 2).sum() for g in flat))
            scale = clip_norm / torch.clamp_min(gn, clip_norm)
            grads = _rebuild(grads, (g.float() * scale for g in flat))
        adamw_update(params, grads, opt_state, lr, step)
        return params, opt_state, loss

    return step_fn
