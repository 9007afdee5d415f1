"""MoE decoder LLM, the DeepSeekMoE / Qwen2-MoE shape (counterpart of
`paddle_tpu/models/moe_llm.py`): Llama blocks whose dense MLP is the
port's `MoELayer` (shared and routed SwiGLU experts, top-k gating and
the load-balance aux loss, over the ep axis when placed on a mesh), the
attention the port's `LlamaAttention` on `flash_attention_bhsd`. Under
labels the loss adds `aux_loss_weight` times the layers' summed aux
losses."""
from __future__ import annotations

from dataclasses import dataclass

from .. import nn
from ..nn import functional as F
from ..nn.initializer import Normal
from ..ops.rope import rope_cos_sin
from ..parallel.moe import MoELayer
from .llama import LlamaAttention, LlamaConfig

__all__ = ["MoEConfig", "MoEDecoderLayer", "MoEForCausalLM"]


@dataclass
class MoEConfig(LlamaConfig):
    num_experts: int = 8
    num_experts_per_tok: int = 2
    num_shared_experts: int = 1
    moe_intermediate_size: int = 0  # 0 -> intermediate_size
    aux_loss_weight: float = 0.01

    @classmethod
    def tiny_moe(cls):
        return cls(vocab_size=256, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=128,
                   num_experts=4, num_experts_per_tok=2, num_shared_experts=1)


class MoEDecoderLayer(nn.Layer):
    def __init__(self, config: MoEConfig):
        super().__init__()
        c = config
        self.input_layernorm = nn.RMSNorm(c.hidden_size, epsilon=c.rms_norm_eps)
        self.self_attn = LlamaAttention(c)
        self.post_attention_layernorm = nn.RMSNorm(c.hidden_size,
                                                   epsilon=c.rms_norm_eps)
        d_ff = c.moe_intermediate_size or c.intermediate_size
        self.mlp = MoELayer(c.hidden_size, d_ff, c.num_experts,
                            top_k=c.num_experts_per_tok,
                            num_shared_experts=c.num_shared_experts)

    def forward(self, x, cos, sin):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return h + self.mlp(self.post_attention_layernorm(h))


class MoEForCausalLM(nn.Layer):
    def __init__(self, config: MoEConfig):
        super().__init__()
        self.config = config
        c = config
        attr = nn.ParamAttr(initializer=Normal(0.0, c.initializer_range))
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size,
                                         weight_attr=attr)
        self.layers = nn.LayerList([MoEDecoderLayer(c)
                                    for _ in range(c.num_hidden_layers)])
        self.norm = nn.RMSNorm(c.hidden_size, epsilon=c.rms_norm_eps)
        self.lm_head = nn.Linear(c.hidden_size, c.vocab_size, weight_attr=attr,
                                 bias_attr=False)

    def forward(self, input_ids, labels=None):
        c = self.config
        s = input_ids.shape[1]
        cos, sin = rope_cos_sin(s, c.hidden_size // c.num_attention_heads,
                                c.rope_theta,
                                device=self.embed_tokens.weight._value.device)
        x = self.embed_tokens(input_ids)
        aux_total = None
        for layer in self.layers:
            x = layer(x, cos, sin)
            aux = layer.mlp.aux_loss
            aux_total = aux if aux_total is None else aux_total + aux
        logits = self.lm_head(self.norm(x))
        if labels is not None:
            loss = F.cross_entropy(logits, labels)
            if aux_total is not None:
                loss = loss + self.config.aux_loss_weight * aux_total
            return loss, logits
        return logits
