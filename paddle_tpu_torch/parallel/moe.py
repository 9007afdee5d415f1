"""Expert parallelism / MoE (counterpart of `paddle_tpu/parallel/moe.py`;
reference: python/paddle/incubate/nn/layer/fused_moe and fleet's EP
groups).

GShard-style dense dispatch: top-k gating, capacity-bounded one-hot
dispatch and combine tensors, and the experts' SwiGLU as batched
matmuls. The capacity is `capacity_factor * T * k / E` over every token,
and a token's arrival rank in its expert's queue is counted slot-major
over every token (`expert_slot_positions`), so the assignments dropped
are the JAX package's.

Over an `ep` axis (the experts' weights placed by their `dist_spec`
P(ep_axis): each rank holds E / ep experts) every rank gates the whole
token set (the same on every rank), runs only its experts' capacity
rows, and the combine is summed over the axis (`reduce_from_group`).
The tokens and the routing probabilities enter the experts' part
through `copy_to_group`, so their gradients sum the ranks' parts; the
load-balance loss and the shared experts run outside it, whole on every
rank. No token moves between ranks: with the same tokens on every rank
the all-to-all of a token-sharded design would carry what each rank
already holds, and gating all of them keeps the drop order global
without a second exchange of arrival ranks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from .._core.tensor import apply
from ..distributed import collective as C
from ..nn.initializer import XavierUniform
from ..nn.layer.layers import Layer
from .mesh import P
from .tp import split_group

__all__ = ["expert_slot_positions", "top_k_gating", "moe_ffn_apply",
           "MoELayer"]


def expert_slot_positions(topk_idx, tot_expert):
    """(T, k) expert ids (negatives = dropped) -> (T, k) arrival rank of
    each assignment within its expert's queue, slot-major (slot 0 of
    every token first)."""
    T, k = topk_idx.shape
    flat = torch.where(topk_idx >= 0, topk_idx,
                       tot_expert).transpose(0, 1).reshape(-1)
    onehot = TF.one_hot(flat.long(), tot_expert + 1)
    rank = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
    return rank.reshape(k, T).transpose(0, 1)


def top_k_gating(logits, k, capacity, expert_axis_size=1, group=None):
    """logits (T, E) -> dispatch (T, E, C) 0/1, combine (T, E, C) fp32,
    aux_loss (Switch's load-balance loss). `group`: the ep group the
    combine's gradient is summed over (the combine then enters through
    `copy_to_group`; the aux loss does not)."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), -1)
    route = C.copy_to_group(probs, group) if group is not None else probs
    gate_vals, gate_idx = torch.topk(route, k, dim=-1)     # (T, k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    pos_tok = expert_slot_positions(gate_idx, E)            # (T, k)
    keep = (pos_tok < capacity) & (pos_tok >= 0)
    disp = (TF.one_hot(gate_idx, E).float()[..., None]
            * TF.one_hot(pos_tok.clamp(0, capacity - 1),
                         capacity).float()[..., None, :])   # (T, k, E, C)
    disp = disp * keep[..., None, None].float()
    dispatch = disp.sum(1)
    combine = (disp * gate_vals[..., None, None]).sum(1)
    me = probs.mean(0)
    ce = TF.one_hot(gate_idx[:, 0], E).float().mean(0)
    aux = E * (me * ce).sum()
    return dispatch, combine, aux


def moe_ffn_apply(x_tokens, gate_w, expert_ws, k=2, capacity_factor=1.25,
                  ep_axis="ep", mesh=None, activation=TF.silu, group=None,
                  return_dropped=False):
    """The MoE forward over raw tensors.

    x_tokens: (T, M); gate_w: (M, E); expert_ws: dict(w_gate (El, M, F),
    w_up (El, M, F) [optional], w_down (El, F, M)), the rank's El of the
    E experts: all of them, or the block of `group` (the ep group; E / El
    ranks) when they are split. Returns (T, M) and aux_loss; with
    return_dropped, also the number of assignments over capacity (a
    0-dim tensor)."""
    T, M = x_tokens.shape
    E = gate_w.shape[1]
    El = expert_ws["w_gate"].shape[0]
    if El != E and group is None:
        if mesh is None or ep_axis not in mesh.shape:
            raise ValueError(f"{El} of {E} experts held but no {ep_axis!r} "
                             "axis to sum them over")
        group = mesh.group(ep_axis)
    capacity = max(1, int(capacity_factor * T * k / E))
    logits = x_tokens.float() @ gate_w.float()
    dispatch, combine, aux = top_k_gating(logits, k, capacity, group=group)
    lo = group.rank * El if group is not None else 0
    xs = C.copy_to_group(x_tokens, group) if group is not None else x_tokens
    disp = dispatch[:, lo:lo + El].to(x_tokens.dtype)
    expert_in = torch.einsum("tec,tm->ecm", disp, xs)
    wg, wd, wu = (expert_ws["w_gate"], expert_ws["w_down"],
                  expert_ws.get("w_up"))
    h = torch.einsum("ecm,emf->ecf", expert_in, wg)
    h = activation(h) * torch.einsum("ecm,emf->ecf", expert_in, wu) \
        if wu is not None else activation(h)
    expert_out = torch.einsum("ecf,efm->ecm", h, wd)
    out = torch.einsum("tec,ecm->tm", combine[:, lo:lo + El].to(
        x_tokens.dtype), expert_out)
    if group is not None:
        out = C.reduce_from_group(out, group)
    if return_dropped:
        return out, aux, T * k - dispatch.detach().sum()
    return out, aux


class MoELayer(Layer):
    """Mixture-of-experts FFN (SwiGLU experts + optional shared experts:
    the DeepSeekMoE / Qwen2-MoE shape). After a forward, `aux_loss` is
    the load-balance loss and `dropped` the assignments over capacity."""

    def __init__(self, d_model, d_ff, num_experts, top_k=2,
                 capacity_factor=1.25, num_shared_experts=0, ep_axis="ep",
                 gate_attr=None, name=None):
        super().__init__()
        self.d_model = d_model
        self.d_ff = d_ff
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.ep_axis = ep_axis
        init = XavierUniform()
        self.gate_weight = self.create_parameter([d_model, num_experts],
                                                 attr=gate_attr,
                                                 default_initializer=init)
        self.w_gate = self.create_parameter([num_experts, d_model, d_ff],
                                            default_initializer=init)
        self.w_up = self.create_parameter([num_experts, d_model, d_ff],
                                          default_initializer=init)
        self.w_down = self.create_parameter([num_experts, d_ff, d_model],
                                            default_initializer=init)
        for p in (self.w_gate, self.w_up, self.w_down):
            p.dist_spec = P(ep_axis)
            p.is_distributed = True
        if num_shared_experts > 0:
            self.shared_gate = self.create_parameter(
                [d_model, d_ff * num_shared_experts], default_initializer=init)
            self.shared_up = self.create_parameter(
                [d_model, d_ff * num_shared_experts], default_initializer=init)
            self.shared_down = self.create_parameter(
                [d_ff * num_shared_experts, d_model], default_initializer=init)
        else:
            self.shared_gate = None
        self.aux_loss = None
        self.dropped = None

    def forward(self, x):
        group = split_group(self.w_gate, 0, self.num_experts)
        shape = x.shape

        def fn(xr, gw, wg, wu, wd, *shared):
            tokens = xr.reshape(-1, shape[-1])
            out, aux, dropped = moe_ffn_apply(
                tokens, gw, {"w_gate": wg, "w_up": wu, "w_down": wd},
                k=self.top_k, capacity_factor=self.capacity_factor,
                ep_axis=self.ep_axis, group=group, return_dropped=True)
            if shared:
                sg, su, sd = shared
                out = out + (TF.silu(tokens @ sg) * (tokens @ su)) @ sd
            return out.reshape(xr.shape), aux, dropped

        args = [x, self.gate_weight, self.w_gate, self.w_up, self.w_down]
        if self.shared_gate is not None:
            args += [self.shared_gate, self.shared_up, self.shared_down]
        out, aux, dropped = apply(fn, *args, multi=True)
        self.aux_loss = aux
        self.dropped = dropped
        return out
