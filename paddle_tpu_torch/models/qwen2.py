"""Qwen2 family (counterpart of `paddle_tpu/models/qwen2.py`).

Architecturally Llama with q/k/v projection biases and, on the small
variants, the lm_head tied to the embedding: the port's Layer-tree Llama
(`models/llama.py`) with biases on its attention projections, keeping
its Megatron dist_specs (a bias is split over tp with its projection's
columns). The attention runs `flash_attention_bhsd` through
`LlamaAttention.forward`: at `qwen2_7b()` widths a head dim of 128 under
28 query and 4 KV heads (the K/V heads repeated before the kernel).
"""
from __future__ import annotations

from dataclasses import dataclass

from .. import nn
from ..nn.initializer import Normal
from ..parallel.mesh import P
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel)

__all__ = ["Qwen2Config", "Qwen2Attention", "Qwen2DecoderLayer",
           "Qwen2Model", "Qwen2ForCausalLM"]


@dataclass(unsafe_hash=True)
class Qwen2Config(LlamaConfig):
    attention_bias: bool = True
    tie_word_embeddings: bool = True

    @classmethod
    def qwen2_7b(cls):
        return cls(vocab_size=152064, hidden_size=3584,
                   intermediate_size=18944, num_hidden_layers=28,
                   num_attention_heads=28, num_key_value_heads=4,
                   max_position_embeddings=32768, rope_theta=1e6,
                   tie_word_embeddings=False)

    @classmethod
    def qwen2_0_5b(cls):
        return cls(vocab_size=151936, hidden_size=896, intermediate_size=4864,
                   num_hidden_layers=24, num_attention_heads=14,
                   num_key_value_heads=2, max_position_embeddings=32768,
                   rope_theta=1e6, tie_word_embeddings=True)


class Qwen2Attention(LlamaAttention):
    """`LlamaAttention` with zero-initialised q/k/v biases, which its
    forward adds after the projections."""

    def __init__(self, config, tp_axis="tp"):
        super().__init__(config, tp_axis)
        if getattr(config, "attention_bias", True):
            h = config.hidden_size
            kv = self.num_kv_heads * self.head_dim
            z = nn.initializer.Constant(0.0)
            for name, width in (("q_proj", h), ("k_proj", kv), ("v_proj", kv)):
                layer = getattr(self, name)
                layer.bias = layer.create_parameter(
                    [width], default_initializer=z, is_bias=True)
                layer.bias.dist_spec = P(tp_axis)


class Qwen2DecoderLayer(LlamaDecoderLayer):
    def __init__(self, config):
        nn.Layer.__init__(self)
        self.input_layernorm = nn.RMSNorm(config.hidden_size,
                                          epsilon=config.rms_norm_eps)
        self.self_attn = Qwen2Attention(config)
        self.post_attention_layernorm = nn.RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps)
        self.mlp = LlamaMLP(config)


class Qwen2Model(LlamaModel):
    def __init__(self, config):
        super().__init__(config)
        self.layers = nn.LayerList([Qwen2DecoderLayer(config)
                                    for _ in range(config.num_hidden_layers)])


class Qwen2ForCausalLM(LlamaForCausalLM):
    def __init__(self, config):
        nn.Layer.__init__(self)
        self.config = config
        self.llama = Qwen2Model(config)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(
                config.hidden_size, config.vocab_size,
                weight_attr=nn.ParamAttr(
                    initializer=Normal(0.0, config.initializer_range)),
                bias_attr=False)
            self.lm_head.weight.dist_spec = P(None, "tp")
        else:
            self.lm_head = None
