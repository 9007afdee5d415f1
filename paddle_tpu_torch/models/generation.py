"""Generation (counterpart of `paddle_tpu/models/generation.py`).

Host-side (numpy) sampling for the serving engine's host-picked first
token (`filtered_probs_np`, `sample_logits_np`: a seeded request draws
the same first token from the same logits row), and the eager decode of
the Layer-tree families: `_sample_logits` (on the reference's key
stream), `generate`, `_forward_with_cache` and `make_decode_step`."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["filtered_probs_np", "sample_logits_np", "generate",
           "make_decode_step"]


def filtered_probs_np(logits_row, temperature, top_k, top_p):
    """The sampling distribution a request actually draws from:
    temperature scaling, then top_k, then top_p filtering (the
    include-crossing-token convention). Requires temperature > 0."""
    logits = np.asarray(logits_row, np.float64) / temperature
    k = int(top_k)
    if k > 0:
        k = min(k, logits.shape[-1])
        kth = np.partition(logits, -k)[-k]
        logits = np.where(logits < kth, -np.inf, logits)
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    if top_p < 1.0:
        order = np.argsort(-probs)
        csum = np.cumsum(probs[order])
        cutoff = np.searchsorted(csum, top_p) + 1
        keep = order[:cutoff]
        mask = np.zeros_like(probs)
        mask[keep] = probs[keep]
        probs = mask / mask.sum()
    return probs


def sample_logits_np(logits_row, temperature, top_k, top_p, rng=None):
    """temperature=0 -> greedy; else top_k then top_p filtering and one
    draw from the request's own seeded RandomState."""
    if temperature <= 0.0:
        return int(np.argmax(logits_row))
    probs = filtered_probs_np(logits_row, temperature, top_k, top_p)
    rng = rng or np.random
    return int(rng.choice(len(probs), p=probs))


# ----------------------------------------------------- eager generation
def _categorical(key, logits):
    """`jax.random.categorical(key, logits, axis=-1)` for one (1, 2) key:
    the argmax of logits plus Gumbel noise drawn over the whole (..., V)
    shape from the key (`_prng.uniform_real`, bit-equal to JAX's uniform;
    the logs go through torch's, ROADMAP.md Queue 3's Gumbel entry)."""
    from .. import _prng
    u = _prng.uniform_real(key, tuple(logits.shape), torch.float32,
                           minval=float(torch.finfo(torch.float32).tiny),
                           maxval=1.0, device=logits.device)
    return torch.argmax(-torch.log(-torch.log(u)) + logits, dim=-1)


def _sample_logits(logits, temperature, top_k, top_p, key):
    """Greedy at temperature 0; else temperature, top_k, then top_p
    (the include-crossing-token convention) and one categorical draw
    under `key`, as the reference's `_sample_logits`."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -1e30, logits)
    if top_p < 1.0:
        sorted_idx = torch.argsort(-logits, dim=-1, stable=True)
        sorted_logits = torch.gather(logits, -1, sorted_idx)
        probs = torch.softmax(sorted_logits, dim=-1)
        cutoff = torch.cumsum(probs, dim=-1) - probs > top_p
        sorted_logits = torch.where(cutoff, -1e30, sorted_logits)
        inv = torch.argsort(sorted_idx, dim=-1)
        logits = torch.gather(sorted_logits, -1, inv)
    return _categorical(key, logits)


def generate(model, input_ids, max_new_tokens=32, temperature=1.0, top_k=0,
             top_p=1.0, eos_token_id=None):
    """The reference's eager decode loop on a Layer model (Llama, Qwen2,
    GPT-2, ...). As there, no cache is handed from step to step
    (`_forward_with_cache`): the first step runs the prompt, and each
    later one only its new token at the next position, which attends to
    itself alone (ROADMAP.md, Queue 3 records this reference-side
    fault; the port keeps it so that the tokens are JAX's)."""
    from .._core.state import prng, torch_device
    from .._core.tensor import Tensor
    from ..autograd import no_grad
    ids = input_ids if isinstance(input_ids, Tensor) else Tensor(
        torch.as_tensor(np.asarray(input_ids), device=torch_device()))
    with no_grad():
        caches = None
        cur = ids
        offset = 0
        out_tokens = []
        finished = np.zeros(ids.shape[0], bool)
        for _ in range(max_new_tokens):
            logits, caches = _forward_with_cache(model, cur, offset, caches)
            last = logits._value[:, -1, :]
            tok = _sample_logits(last, temperature, top_k, top_p,
                                 prng.next_key())
            offset += cur.shape[1]
            cur = Tensor(tok[:, None])
            out_tokens.append(tok)
            if eos_token_id is not None:
                finished |= tok.cpu().numpy() == eos_token_id
                if finished.all():
                    break
        gen = torch.stack(out_tokens, dim=1).to(ids._value.dtype)
    return Tensor(torch.cat([ids._value, gen], dim=1))


def _forward_with_cache(model, ids, offset, caches):
    """The reference's adapter over the families' call signatures: the
    model at `position_offset` with `kv_caches=None` (the caches it is
    given are never filled), or, for a model without those arguments,
    on the ids alone. Returns (logits, caches) with caches unchanged."""
    n_layers = model.config.num_hidden_layers
    if caches is None:
        caches = [None] * n_layers
    try:
        logits = model(ids, position_offset=offset,
                       kv_caches=list(caches) if caches[0] is not None
                       else None)
        if isinstance(logits, tuple):
            logits = logits[1] if logits[0].ndim == 0 else logits[0]
        return logits, caches
    except TypeError:
        logits = model(ids)
        if isinstance(logits, tuple):
            logits = logits[0]
        return logits, caches


def make_decode_step(forward_fn, max_len):
    """A decode step for functional models: forward_fn(params, ids, cache,
    index) -> (logits_last, cache) over a preallocated (L, 2, B, H,
    max_len, D) cache. Returns step(params, tok, cache, index, key,
    temperature, top_k, top_p) -> (next token, cache). The reference
    jits it; the port runs eagerly."""
    def step(params, tok, cache, index, key, temperature, top_k, top_p):
        logits, cache = forward_fn(params, tok, cache, index)
        return _sample_logits(logits, temperature, top_k, top_p, key), cache
    return step
