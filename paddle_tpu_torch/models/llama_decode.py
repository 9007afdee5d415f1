"""Llama decode with a preallocated KV cache (counterpart of
`paddle_tpu/models/llama_decode.py`), on the stacked parameters of
`models/llama_spmd.py` (`init_params`, or `params_from_jax` of the JAX
package's tree).

The cache is one (L, 2, B, KVH, max_len, D) tensor, written in place at
positions [index, index + S) of each layer; attention is a plain fp32
einsum over the whole cache with keys past the current position masked,
as the reference computes it outside any Pallas kernel. The reference's
`lax.scan` over layers and tokens is a Python loop here; PyTorch runs
eagerly, so there is no compiled step. Its quirk is kept: a prefill of S
> 1 tokens takes the RoPE tables of positions 0..S-1 whatever `index`
is. Temperature sampling draws from the reference's key stream
(`_prng`: `jax.random.key(seed)` for the first token, then `split` a
step) through `generation._categorical`.
"""
from __future__ import annotations

import math

import torch

from .._device import DEFAULT_DEVICE, resolve_device
from ..ops.rope import apply_rotary_emb, rope_cos_sin
from .llama import LlamaConfig

__all__ = ["init_cache", "forward_with_cache", "make_generate"]


def init_cache(config: LlamaConfig, batch, max_len, dtype=torch.float32,
               device=DEFAULT_DEVICE):
    c = config
    hd = c.hidden_size // c.num_attention_heads
    return torch.zeros((c.num_hidden_layers, 2, batch, c.num_key_value_heads,
                        max_len, hd), dtype=dtype,
                       device=resolve_device(device))


def _rms(h, w, eps):
    hf = h.float()
    return (hf * torch.rsqrt((hf * hf).mean(-1, keepdim=True) + eps)
            * w).to(h.dtype)


def _layer_decode(lp, h, cache_layer, index, rope_full, config):
    """h: (B, S, H) (S the prompt's length at prefill, 1 at decode);
    cache_layer: (2, B, KVH, max_len, D), written in place at [index,
    index + S). Returns the layer's output."""
    c = config
    nh, nkv = c.num_attention_heads, c.num_key_value_heads
    hd = c.hidden_size // nh
    b, s, H = h.shape
    cos_f, sin_f = rope_full
    cos, sin = (t[index:index + s] if s == 1 else t[:s]
                for t in (cos_f, sin_f))

    x = _rms(h, lp["ln1"], c.rms_norm_eps)
    q = (x @ lp["wq"]).reshape(b, s, nh, hd).transpose(1, 2)
    k = (x @ lp["wk"]).reshape(b, s, nkv, hd).transpose(1, 2)
    v = (x @ lp["wv"]).reshape(b, s, nkv, hd).transpose(1, 2)
    q, k = apply_rotary_emb(q, k, cos, sin)

    cache_layer[0, :, :, index:index + s] = k.to(cache_layer.dtype)
    cache_layer[1, :, :, index:index + s] = v.to(cache_layer.dtype)
    new_k, new_v = cache_layer[0], cache_layer[1]

    max_len = new_k.shape[-2]
    rep = nh // nkv
    kk = new_k.repeat_interleave(rep, 1) if rep > 1 else new_k
    vv = new_v.repeat_interleave(rep, 1) if rep > 1 else new_v
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          kk.float()) * (1.0 / math.sqrt(hd))
    kpos = torch.arange(max_len, device=h.device)[None, :]
    qpos = index + torch.arange(s, device=h.device)[:, None]
    scores = torch.where((kpos <= qpos)[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", probs, vv.float())
    h = h + (o.transpose(1, 2).reshape(b, s, H).to(h.dtype) @ lp["wo"])

    x = _rms(h, lp["ln2"], c.rms_norm_eps)
    return h + (torch.nn.functional.silu(x @ lp["w_gate"])
                * (x @ lp["w_up"])) @ lp["w_down"]


@torch.no_grad()
def forward_with_cache(params, input_ids, cache, index, config: LlamaConfig):
    """-> (logits of the last position (B, V) fp32, cache): the tokens
    input_ids (B, S) written at [index, index + S) of the cache, which is
    updated in place and returned."""
    c = config
    max_len = cache.shape[-2]
    rope_full = rope_cos_sin(max_len, c.hidden_size // c.num_attention_heads,
                             c.rope_theta, torch.float32,
                             device=cache.device)
    h = params["embed"][input_ids.long()]
    layers = params["layers"]
    for i in range(cache.shape[0]):
        lp = {name: w[i] for name, w in layers.items()}
        h = _layer_decode(lp, h, cache[i], index, rope_full, c)
    h = _rms(h, params["final_norm"], c.rms_norm_eps)
    logits = h[:, -1, :] @ params["lm_head"]
    return logits.float(), cache


def make_generate(config: LlamaConfig, max_len, max_new_tokens,
                  temperature=0.0, top_k=0):
    """generate(params, prompt_ids (B, P), seed=0) -> (B, P +
    max_new_tokens): a prefill, then one token a step, greedy at
    temperature 0, else drawn as the reference draws (the first token
    with neither top_k nor a split key, as there)."""
    from .. import _prng
    from .generation import _categorical

    def generate(params, prompt_ids, seed=0):
        b, plen = prompt_ids.shape
        embed = params["embed"]
        cache = init_cache(config, b, max_len, embed.dtype, embed.device)
        logits, cache = forward_with_cache(params, prompt_ids, cache, 0,
                                           config)
        if temperature == 0.0:
            tok = torch.argmax(logits, dim=-1)
        else:
            tok = _categorical(_prng.key(seed), logits / temperature)
        toks, key, idx = [tok], _prng.key(seed + 1), plen
        for _ in range(max_new_tokens - 1):
            logits, cache = forward_with_cache(params, tok[:, None], cache,
                                               idx, config)
            if temperature > 0.0:
                key, sub = _prng.split(key)
                lg = logits / temperature
                if top_k:
                    kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
                    lg = torch.where(lg < kth, -1e30, lg)
                tok = _categorical(sub[None], lg)
            else:
                tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
            idx += 1
        out = torch.stack(toks, dim=1).to(prompt_ids.dtype)
        return torch.cat([prompt_ids, out], dim=1)

    return generate
