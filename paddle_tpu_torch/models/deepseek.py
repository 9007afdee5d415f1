"""DeepSeek-V2/V3-style model, MLA attention and a DeepSeekMoE FFN
(counterpart of `paddle_tpu/models/deepseek.py`).

  * MLA (multi-head latent attention): K and V come from a low-rank
    latent `c_kv = x W_dkv` (kv_lora_rank wide), normalised (an RMS norm
    at eps 1e-5 whatever the config's, as the reference computes it) and
    projected up per head, plus a decoupled RoPE branch of
    qk_rope_head_dim dims whose key is shared over the heads. q and k
    join their no-RoPE and RoPE parts, so the attention's head dim is
    qk_nope_head_dim + qk_rope_head_dim (192 at the default widths); V
    is zero-padded to that width for the kernel and sliced after, and
    the scale is 1/sqrt of it. On the card that is the flash kernels of
    rows 3-5 at D = 192 (`ops/flash_attention.py`).
  * The FFN: a dense SwiGLU for the first `first_k_dense_replace`
    layers, the port's `MoELayer` (shared and routed experts) after.
    The reference adds no aux loss to the loss; nor does the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import nn
from .._core.tensor import apply
from ..nn import functional as F
from ..nn.initializer import Normal
from ..ops.flash_attention import flash_attention_bhsd
from ..ops.rope import rope_cos_sin
from ..parallel.moe import MoELayer
from .llama import LlamaConfig, LlamaMLP

__all__ = ["DeepSeekConfig", "MLAttention", "DeepSeekDecoderLayer",
           "DeepSeekForCausalLM"]


@dataclass(unsafe_hash=True)
class DeepSeekConfig(LlamaConfig):
    kv_lora_rank: int = 512
    q_lora_rank: int = 0              # 0 = full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 8
    n_shared_experts: int = 1
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 0    # 0 = intermediate_size
    first_k_dense_replace: int = 1    # leading dense layers before MoE
    aux_loss_alpha: float = 0.001

    @classmethod
    def tiny_mla(cls, vocab=128, hidden=64, layers=2, heads=4):
        return cls(vocab_size=vocab, hidden_size=hidden,
                   intermediate_size=hidden * 2, num_hidden_layers=layers,
                   num_attention_heads=heads, num_key_value_heads=heads,
                   kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                   v_head_dim=16, n_routed_experts=4, n_shared_experts=1,
                   num_experts_per_tok=2, moe_intermediate_size=hidden,
                   max_position_embeddings=256)


def _rotate(t, cos, sin):
    """RoPE on the last dim (halves rotated), cos/sin broadcast."""
    half = t.shape[-1] // 2
    return t * cos + torch.cat([-t[..., half:], t[..., :half]], -1) * sin


class MLAttention(nn.Layer):
    """Multi-head latent attention. Shapes:

    q:      x -> (B, S, H (d_nope + d_rope))
    latent: x -> c_kv (B, S, r) and k_rope (B, S, d_rope), the part a
            serving cache would keep
    k, v:   c_kv -> per head k_nope (d_nope) and v (d_v); k = [k_nope;
            k_rope]
    """

    def __init__(self, config: DeepSeekConfig):
        super().__init__()
        c = config
        self.nh = c.num_attention_heads
        self.d_nope = c.qk_nope_head_dim
        self.d_rope = c.qk_rope_head_dim
        self.d_v = c.v_head_dim
        self.r = c.kv_lora_rank
        H = c.hidden_size
        init = nn.ParamAttr(initializer=Normal(0.0, c.initializer_range))
        qd = self.nh * (self.d_nope + self.d_rope)
        self.q_proj = nn.Linear(H, qd, weight_attr=init, bias_attr=False)
        # latent: compressed kv + the shared rope key
        self.kv_down = nn.Linear(H, self.r + self.d_rope, weight_attr=init,
                                 bias_attr=False)
        self.kv_norm = nn.RMSNorm(self.r, epsilon=c.rms_norm_eps)
        self.kv_up = nn.Linear(self.r, self.nh * (self.d_nope + self.d_v),
                               weight_attr=init, bias_attr=False)
        self.o_proj = nn.Linear(self.nh * self.d_v, H, weight_attr=init,
                                bias_attr=False)
        self.rope_theta = c.rope_theta

    def forward(self, x, cos, sin):
        b, s, H = x.shape
        nh, dn, dr, dv, r = self.nh, self.d_nope, self.d_rope, self.d_v, \
            self.r

        def fn(xr, wq, wdown, gnorm, wup, wo):
            q = (xr @ wq).reshape(b, s, nh, dn + dr)
            q_nope, q_rope = q[..., :dn], q[..., dn:]
            down = xr @ wdown                          # (B, S, r + dr)
            c_kv, k_rope = down[..., :r], down[..., r:]
            cf = c_kv.float()
            c_kv = (cf * torch.rsqrt((cf * cf).mean(-1, keepdim=True) + 1e-5)
                    * gnorm.float()).to(xr.dtype)
            kv = (c_kv @ wup).reshape(b, s, nh, dn + dv)
            k_nope, v = kv[..., :dn], kv[..., dn:]
            # decoupled rope: q per head, k shared across heads; the fp32
            # tables' product is cast back to the activations' dtype (the
            # reference keeps it fp32, so bf16 q and k become fp32 there;
            # ROADMAP.md Queue 3), so that bf16 runs the bf16 kernels
            q_rope = _rotate(q_rope, cos[None, :, None],
                             sin[None, :, None]).to(xr.dtype)
            k_rope = _rotate(k_rope, cos[None], sin[None]).to(xr.dtype)
            k_rope_h = k_rope[:, :, None].expand(b, s, nh, dr)
            qh = torch.cat([q_nope, q_rope], -1).transpose(1, 2)
            kh = torch.cat([k_nope, k_rope_h], -1).transpose(1, 2)
            vh = v.transpose(1, 2)
            # pad v's head dim to qk's for the kernel, slice after
            if dv < dn + dr:
                vh = torch.nn.functional.pad(vh, (0, dn + dr - dv))
            o = flash_attention_bhsd(qh, kh, vh, causal=True,
                                     sm_scale=1.0 / math.sqrt(dn + dr))
            o = o[..., :dv].transpose(1, 2).reshape(b, s, nh * dv)
            return o @ wo

        return apply(fn, x, self.q_proj.weight, self.kv_down.weight,
                     self.kv_norm.weight, self.kv_up.weight,
                     self.o_proj.weight)


class DeepSeekDecoderLayer(nn.Layer):
    def __init__(self, config: DeepSeekConfig, layer_idx: int):
        super().__init__()
        c = config
        self.input_layernorm = nn.RMSNorm(c.hidden_size,
                                          epsilon=c.rms_norm_eps)
        self.self_attn = MLAttention(c)
        self.post_attention_layernorm = nn.RMSNorm(c.hidden_size,
                                                   epsilon=c.rms_norm_eps)
        if layer_idx < c.first_k_dense_replace:
            self.mlp = LlamaMLP(c)
            self.is_moe = False
        else:
            inter = c.moe_intermediate_size or c.intermediate_size
            self.mlp = MoELayer(c.hidden_size, inter,
                                num_experts=c.n_routed_experts,
                                top_k=c.num_experts_per_tok,
                                num_shared_experts=c.n_shared_experts)
            self.is_moe = True

    def forward(self, x, cos, sin):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return h + self.mlp(self.post_attention_layernorm(h))


class DeepSeekForCausalLM(nn.Layer):
    def __init__(self, config: DeepSeekConfig):
        super().__init__()
        c = self.config = config
        init = nn.ParamAttr(initializer=Normal(0.0, c.initializer_range))
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size,
                                         weight_attr=init)
        self.layers = nn.LayerList([DeepSeekDecoderLayer(c, i)
                                    for i in range(c.num_hidden_layers)])
        self.norm = nn.RMSNorm(c.hidden_size, epsilon=c.rms_norm_eps)
        self.lm_head = nn.Linear(c.hidden_size, c.vocab_size,
                                 weight_attr=init, bias_attr=False)

    def forward(self, input_ids, labels=None):
        c = self.config
        s = input_ids.shape[1]
        cos, sin = rope_cos_sin(s, c.qk_rope_head_dim, base=c.rope_theta,
                                device=self.embed_tokens.weight._value.device)
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, cos, sin)
        logits = self.lm_head(self.norm(x))
        if labels is not None:
            loss = F.cross_entropy(logits, labels, reduction="mean")
            return loss, logits
        return logits
