"""Llama-3 family (counterpart of `paddle_tpu/models/llama.py`): the
configuration, and the Paddle-shaped Layer tree `LlamaForCausalLM`
(`LlamaAttention`, `LlamaMLP`, `LlamaDecoderLayer`, `LlamaModel`) on the
port's Tensor, nn and ops: RoPE from `ops/rope.py`, the SwiGLU of
`ops/fused.py` and the flash-attention kernels through
`ops.flash_attention.flash_attention_bhsd`, with GQA's K/V heads
repeated before the kernel. The serving and training paths run the
stacked-parameter layout of `models/llama_spmd.py` instead.

Every weight carries its Megatron `dist_spec`. Placed on a mesh (the
parallel `Trainer` cuts each to the rank's block), the attention runs
the rank's heads and the MLP its FFN columns between `copy_to_group`
and `reduce_from_group`, the embedding looks up the rank's vocabulary
rows, and the lm_head gives the vocabulary-parallel loss
(`parallel/tp.py`).

The Layer tree's KV cache (`kv_caches=`, a (k, v) pair a layer of
(B, KVH, S_cache, D) keys and values put before the step's) runs a
one-token step without the causal mask: one query row after the cache
sees every key, which is what the reference's bottom-right mask gives
(its CPU path, `mha_reference`). A causal step of more rows over a
non-empty cache would need that mask, which the kernels do not align
(ROADMAP.md, Queue 3, causal alignment): it raises NotImplementedError.
`generate` is `models.generation.generate`, the reference's eager loop,
which hands no cache back (ROADMAP.md, Queue 3)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn
from .._core.tensor import apply
from ..nn import functional as F
from ..nn.initializer import Normal
from ..ops.flash_attention import flash_attention_bhsd
from ..ops.fused import swiglu
from ..ops.rope import apply_rotary_emb, rope_cos_sin
from ..distributed import collective as C
from ..parallel.mesh import P
from ..parallel.tp import split_group, vocab_parallel_nll


@dataclass(unsafe_hash=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    dtype: str = "float32"

    @classmethod
    def llama3_8b(cls):
        return cls(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                   num_hidden_layers=32, num_attention_heads=32,
                   num_key_value_heads=8, max_position_embeddings=8192,
                   rope_theta=500000.0)

    @classmethod
    def tiny(cls, vocab=256, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128,
             seq=128):
        return cls(vocab_size=vocab, hidden_size=hidden, intermediate_size=ffn,
                   num_hidden_layers=layers, num_attention_heads=heads,
                   num_key_value_heads=kv_heads, max_position_embeddings=seq)


def _tp_heads(wq, wk, nh, kvh, hd):
    """(tp group or None, this rank's query heads, its KV heads): the
    heads of the block of the q / k projections' columns it holds."""
    g = split_group(wq, 1, nh * hd)
    if g is None:
        return None, nh, kvh
    if nh % g.nranks or kvh % g.nranks:
        raise ValueError(f"the query heads ({nh}) and KV heads ({kvh}) do "
                         f"not divide over tp={g.nranks}")
    if split_group(wk, 1, kvh * hd) is not g:
        raise ValueError("q_proj and k_proj are split over different axes")
    return g, nh // g.nranks, kvh // g.nranks


def _no_kv_cache(what):
    raise NotImplementedError(
        f"paddle_tpu_torch: {what} of more than one query row over a "
        "non-empty KV cache needs causal attention over more keys than "
        "queries, aligned bottom-right as the reference's CPU path does; "
        "the flash kernels align the mask top-left (ROADMAP.md, Queue 3, "
        "causal alignment). Step one token at a time, or serve through "
        "models.llama_serving")


def _cached_causal(kv_cache, s, causal):
    """The causal flag a step of s query rows runs with after kv_cache:
    a one-token step sees every key (non-causal), a step over an empty
    or no cache keeps it, anything else raises."""
    if kv_cache is None or not causal:
        return causal
    if s == 1:
        return False
    if kv_cache[0].shape[2] > 0:
        _no_kv_cache("a causal step")
    return causal


class LlamaAttention(nn.Layer):
    def __init__(self, config: LlamaConfig, tp_axis="tp"):
        super().__init__()
        c = config
        self.num_heads = c.num_attention_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        init = Normal(0.0, c.initializer_range)
        h = c.hidden_size
        kv = self.num_kv_heads * self.head_dim
        attr = lambda: nn.ParamAttr(initializer=init)
        self.q_proj = nn.Linear(h, h, weight_attr=attr(), bias_attr=False)
        self.k_proj = nn.Linear(h, kv, weight_attr=attr(), bias_attr=False)
        self.v_proj = nn.Linear(h, kv, weight_attr=attr(), bias_attr=False)
        self.o_proj = nn.Linear(h, h, weight_attr=attr(), bias_attr=False)
        # megatron TP: qkv column-parallel, o row-parallel
        for p in (self.q_proj.weight, self.k_proj.weight, self.v_proj.weight):
            p.dist_spec = P(None, tp_axis)
        self.o_proj.weight.dist_spec = P(tp_axis, None)

    def forward(self, x, cos, sin, kv_cache=None, causal=True):
        b, s, h = x.shape
        nh, kvh, hd = self.num_heads, self.num_kv_heads, self.head_dim
        causal = _cached_causal(kv_cache, s, causal)
        # q/k/v biases (Qwen2), then the cache's keys and values
        biases = [] if self.q_proj.bias is None else [
            p.bias for p in (self.q_proj, self.k_proj, self.v_proj)]
        nb = len(biases)

        def fn(xr, wq, wk, wv, wo, *rest):
            q, k, v = xr @ wq, xr @ wk, xr @ wv
            if nb:
                q, k, v = q + rest[0], k + rest[1], v + rest[2]
            q = q.reshape(b, s, nh, hd)
            k = k.reshape(b, s, kvh, hd)
            v = v.reshape(b, s, kvh, hd)
            q, k = apply_rotary_emb(q.transpose(1, 2), k.transpose(1, 2),
                                    cos, sin)
            v = v.transpose(1, 2)
            if len(rest) > nb:
                k = torch.cat([rest[nb], k], dim=2)
                v = torch.cat([rest[nb + 1], v], dim=2)
            if nh > kvh:
                k = k.repeat_interleave(nh // kvh, 1)
                v = v.repeat_interleave(nh // kvh, 1)
            o = flash_attention_bhsd(q, k, v, causal=causal)
            return o.transpose(1, 2).reshape(b, s, nh * hd) @ wo

        g, nh, kvh = _tp_heads(self.q_proj.weight, self.k_proj.weight,
                               nh, kvh, hd)
        if g is not None:
            inner = fn

            def fn(xr, *rest):
                return C.reduce_from_group(
                    inner(C.copy_to_group(xr, g), *rest), g)
        return apply(fn, x, self.q_proj.weight, self.k_proj.weight,
                     self.v_proj.weight, self.o_proj.weight, *biases,
                     *(kv_cache if kv_cache is not None else ()))


class LlamaMLP(nn.Layer):
    def __init__(self, config: LlamaConfig, tp_axis="tp"):
        super().__init__()
        c = config
        init = Normal(0.0, c.initializer_range)
        attr = lambda: nn.ParamAttr(initializer=init)
        self.gate_proj = nn.Linear(c.hidden_size, c.intermediate_size,
                                   weight_attr=attr(), bias_attr=False)
        self.up_proj = nn.Linear(c.hidden_size, c.intermediate_size,
                                 weight_attr=attr(), bias_attr=False)
        self.down_proj = nn.Linear(c.intermediate_size, c.hidden_size,
                                   weight_attr=attr(), bias_attr=False)
        self.gate_proj.weight.dist_spec = P(None, tp_axis)
        self.up_proj.weight.dist_spec = P(None, tp_axis)
        self.down_proj.weight.dist_spec = P(tp_axis, None)

    def forward(self, x):
        g = split_group(self.gate_proj.weight, 1,
                        self.gate_proj._out_features)
        fn = swiglu if g is None else (
            lambda xr, wg, wu, wd: C.reduce_from_group(
                swiglu(C.copy_to_group(xr, g), wg, wu, wd), g))
        return apply(fn, x, self.gate_proj.weight, self.up_proj.weight,
                     self.down_proj.weight)


class LlamaDecoderLayer(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.input_layernorm = nn.RMSNorm(config.hidden_size,
                                          epsilon=config.rms_norm_eps)
        self.self_attn = LlamaAttention(config)
        self.post_attention_layernorm = nn.RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps)
        self.mlp = LlamaMLP(config)

    def forward(self, x, cos, sin, kv_cache=None, causal=True):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin, kv_cache,
                               causal)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        init = Normal(0.0, config.initializer_range)
        self.embed_tokens = nn.Embedding(
            config.vocab_size, config.hidden_size,
            weight_attr=nn.ParamAttr(initializer=init))
        self.embed_tokens.weight.dist_spec = P("tp", None)
        self.layers = nn.LayerList([LlamaDecoderLayer(config)
                                    for _ in range(config.num_hidden_layers)])
        self.norm = nn.RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps)
        self._rope_cache = {}

    def rope(self, seq_len, dtype=torch.float32, offset=0):
        """fp32 cos/sin tables of positions offset .. offset+seq_len-1,
        on the embedding's device."""
        dev = self.embed_tokens.weight._value.device
        key = (seq_len + offset, dtype, dev)
        if key not in self._rope_cache:
            self._rope_cache[key] = rope_cos_sin(
                seq_len + offset, self.config.hidden_size //
                self.config.num_attention_heads, self.config.rope_theta,
                dtype, device=dev)
        cos, sin = self._rope_cache[key]
        return cos[offset:], sin[offset:]

    def forward(self, input_ids, position_offset=0, kv_caches=None,
                causal=True):
        cos, sin = self.rope(input_ids.shape[1], offset=position_offset)
        x = self.embed_tokens(input_ids)
        for i, layer in enumerate(self.layers):
            cache = kv_caches[i] if kv_caches is not None else None
            x = layer(x, cos, sin, cache, causal)
        return self.norm(x)


class LlamaForCausalLM(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.llama = LlamaModel(config)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(
                config.hidden_size, config.vocab_size,
                weight_attr=nn.ParamAttr(
                    initializer=Normal(0.0, config.initializer_range)),
                bias_attr=False)
            self.lm_head.weight.dist_spec = P(None, "tp")
        else:
            self.lm_head = None

    def forward(self, input_ids, labels=None, position_offset=0,
                kv_caches=None):
        h = self.llama(input_ids, position_offset, kv_caches)
        g = None if self.lm_head is None else split_group(
            self.lm_head.weight, 1, self.config.vocab_size)
        if g is not None:
            return self._vocab_parallel_head(h, labels, g)
        if self.lm_head is not None:
            logits = self.lm_head(h)
        else:
            from ..tensor.linalg import matmul
            logits = matmul(h, self.llama.embed_tokens.weight,
                            transpose_y=True)
        if labels is not None:
            loss = F.cross_entropy(logits, labels, reduction="mean")
            return loss, logits
        return logits

    def _vocab_parallel_head(self, h, labels, g):
        """The lm_head split over tp on the vocabulary: this rank's
        logits columns. Under labels the loss is the vocabulary-parallel
        cross-entropy (mean over the labels other than -100), and the
        logits returned are this rank's columns (PaddleNLP's
        tensor_parallel_output): they are never gathered. Without labels
        the logits come back whole."""
        def local(hr, w):
            return C.copy_to_group(hr, g) @ w
        if labels is None:
            return apply(lambda hr, w: C.gather_from_group(local(hr, w), g,
                                                           -1),
                         h, self.lm_head.weight)

        def fn(hr, w, lab):
            logits = local(hr, w)
            lab = lab.long()
            valid = lab != -100
            nll = vocab_parallel_nll(logits.float(),
                                     torch.where(valid, lab, 0), g)
            loss = torch.where(valid, nll, 0.0).sum() / \
                valid.float().sum().clamp_min(1.0)
            return loss, logits
        return apply(fn, h, self.lm_head.weight, labels, multi=True)

    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=0, top_p=1.0, eos_token_id=None):
        from .generation import generate as _gen
        return _gen(self, input_ids, max_new_tokens, temperature, top_k,
                    top_p, eos_token_id)
