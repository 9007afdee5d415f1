"""GPT-2 style decoder with KV-cache generation (counterpart of
`paddle_tpu/models/gpt2.py`): learned positions, pre-LN blocks, GELU
(tanh), one fused QKV projection (`c_attn`) and the lm_head tied to
`wte`, on the port's Tensor, nn and `flash_attention_bhsd`.

`GPT2LMHeadModel.generate` is the reference's KV-cached eager decode,
quirks kept: the prefill embeds its positions from 1, not 0
(`position_offset=1`), and a one-token step runs without the causal mask
(`causal = s > 1`), one query row against the cache and itself, which on
the card is the flash forward at S_q = 1 over a long S_k (ROADMAP.md,
Queue 3 lists both).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import nn
from .._core.state import torch_device
from .._core.tensor import Tensor, apply
from ..nn import functional as F
from ..nn.initializer import Normal
from ..ops.flash_attention import flash_attention_bhsd

__all__ = ["GPT2Config", "GPT2Attention", "GPT2Block", "GPT2Model",
           "GPT2LMHeadModel"]


@dataclass
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    dropout: float = 0.1
    initializer_range: float = 0.02

    @classmethod
    def tiny(cls):
        return cls(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=128,
                   max_position_embeddings=128, dropout=0.0)


class GPT2Attention(nn.Layer):
    def __init__(self, c: GPT2Config):
        super().__init__()
        attr = nn.ParamAttr(initializer=Normal(0.0, c.initializer_range))
        self.n_head = c.num_attention_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.c_attn = nn.Linear(c.hidden_size, 3 * c.hidden_size,
                                weight_attr=attr)
        self.c_proj = nn.Linear(c.hidden_size, c.hidden_size, weight_attr=attr)
        self.dropout = c.dropout

    def forward(self, x, kv_cache=None, causal=True):
        """-> (out, (k, v)): the keys and values of the cache and this
        step, (B, H, S_cache + S, D), for the next step."""
        b, s, h = x.shape
        nh, hd = self.n_head, self.head_dim

        def fn(xr, w, bias, wo, bo, *cache):
            q, k, v = (xr @ w + bias).split(h, dim=-1)
            q, k, v = (t.reshape(b, s, nh, hd).transpose(1, 2)
                       for t in (q, k, v))
            if cache:
                k = torch.cat([cache[0], k], dim=2)
                v = torch.cat([cache[1], v], dim=2)
            o = flash_attention_bhsd(q, k, v, causal=causal)
            o = o.transpose(1, 2).reshape(b, s, h)
            return o @ wo + bo, k, v

        args = [x, self.c_attn.weight, self.c_attn.bias, self.c_proj.weight,
                self.c_proj.bias]
        if kv_cache is not None:
            args += list(kv_cache)
        out, k, v = apply(fn, *args, multi=True)
        return out, (k, v)


class GPT2Block(nn.Layer):
    def __init__(self, c: GPT2Config):
        super().__init__()
        attr = nn.ParamAttr(initializer=Normal(0.0, c.initializer_range))
        self.ln_1 = nn.LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps)
        self.attn = GPT2Attention(c)
        self.ln_2 = nn.LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps)
        self.mlp_fc = nn.Linear(c.hidden_size, c.intermediate_size,
                                weight_attr=attr)
        self.mlp_proj = nn.Linear(c.intermediate_size, c.hidden_size,
                                  weight_attr=attr)
        self.drop = nn.Dropout(c.dropout)

    def forward(self, x, kv_cache=None, causal=True):
        a, new_cache = self.attn(self.ln_1(x), kv_cache, causal)
        x = x + self.drop(a)
        m = self.mlp_proj(F.gelu(self.mlp_fc(self.ln_2(x)), approximate=True))
        return x + self.drop(m), new_cache


class GPT2Model(nn.Layer):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        c = config
        attr = nn.ParamAttr(initializer=Normal(0.0, c.initializer_range))
        self.wte = nn.Embedding(c.vocab_size, c.hidden_size, weight_attr=attr)
        self.wpe = nn.Embedding(c.max_position_embeddings, c.hidden_size,
                                weight_attr=attr)
        self.drop = nn.Dropout(c.dropout)
        self.h = nn.LayerList([GPT2Block(c) for _ in range(c.num_hidden_layers)])
        self.ln_f = nn.LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps)

    def forward(self, input_ids, position_offset=0, kv_caches=None):
        from ..tensor.creation import arange
        s = input_ids.shape[1]
        pos = arange(position_offset, position_offset + s, dtype="int64")
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        new_caches = []
        causal = s > 1
        for i, block in enumerate(self.h):
            cache = kv_caches[i] if kv_caches is not None else None
            x, nc = block(x, cache, causal=causal)
            new_caches.append(nc)
        return self.ln_f(x), new_caches


class GPT2LMHeadModel(nn.Layer):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        self.transformer = GPT2Model(config)

    def forward(self, input_ids, labels=None, position_offset=0,
                kv_caches=None):
        from ..tensor.linalg import matmul
        h, new_caches = self.transformer(input_ids, position_offset, kv_caches)
        logits = matmul(h, self.transformer.wte.weight, transpose_y=True)
        if labels is not None:
            loss = F.cross_entropy(logits, labels)
            return loss, logits
        if kv_caches is not None or position_offset:
            return logits, new_caches
        return logits

    def generate(self, input_ids, max_new_tokens=32, temperature=1.0, top_k=0,
                 top_p=1.0, eos_token_id=None):
        """KV-cached eager decode: one prefill, then one token a step over
        the caches each step hands the next."""
        from ..autograd import no_grad
        from .._core.state import prng
        from .generation import _sample_logits
        ids = input_ids if isinstance(input_ids, Tensor) else \
            Tensor(torch.as_tensor(np.asarray(input_ids),
                                   device=torch_device()))
        with no_grad():
            logits, caches = self.forward(ids, position_offset=1)  # prefill
            toks = []
            cur_len = ids.shape[1]
            last = logits._value[:, -1]
            for _ in range(max_new_tokens):
                tok = _sample_logits(last, temperature, top_k, top_p,
                                     prng.next_key())
                toks.append(tok)
                if eos_token_id is not None and \
                        bool((tok == eos_token_id).all()):
                    break
                logits, caches = self.forward(Tensor(tok[:, None]),
                                              position_offset=cur_len,
                                              kv_caches=caches)
                cur_len += 1
                last = logits._value[:, -1]
        gen = torch.stack(toks, dim=1).to(ids._value.dtype)
        return Tensor(torch.cat([ids._value, gen], dim=1))
