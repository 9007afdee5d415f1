"""Gradient clipping (counterpart of `paddle_tpu/nn/clip.py`): the norms in
float32, each clipped gradient in its own dtype."""
from __future__ import annotations

import torch

from .._core.tensor import Tensor


def _sq_sum(g):
    return torch.sum(torch.square(g._value.float()))


def _placed_sum(params, parts):
    """Sum of per-parameter partial sums; for parameters placed on a
    rank mesh (blocks of split tensors) over the ranks, each tensor
    counted once."""
    from ..parallel.mesh import placement, sum_over_shards
    where = [placement(p) for p in params]
    meshes = {id(w[0]) for w in where if w is not None}
    if not meshes:
        return sum(parts[1:], parts[0])
    if len(meshes) > 1:
        raise ValueError("the parameters are placed on different meshes")
    mesh = next(w[0] for w in where if w is not None)
    return sum_over_shards(parts, [w[1] if w is not None else ()
                                   for w in where], mesh)


class ClipGradBase:
    def __call__(self, params_grads):
        with torch.no_grad():
            return self._dygraph_clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None or not getattr(p, "need_clip", True):
                out.append((p, g))
                continue
            out.append((p, Tensor(torch.clamp(g._value, self.min,
                                              self.max))))
        return out


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None or not getattr(p, "need_clip", True):
                out.append((p, g))
                continue
            norm = torch.sqrt(_sq_sum(g))
            scale = torch.clamp(self.clip_norm / torch.clamp_min(norm, 1e-12),
                                max=1.0)
            out.append((p, Tensor((g._value * scale).to(g.dtype))))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        kept = [(p, g) for p, g in params_grads
                if g is not None and getattr(p, "need_clip", True)]
        if not kept:
            return params_grads
        gnorm = torch.sqrt(_placed_sum([p for p, _ in kept],
                                       [_sq_sum(g) for _, g in kept]))
        scale = self.clip_norm / torch.clamp_min(gnorm, self.clip_norm)
        out = []
        for p, g in params_grads:
            if g is None or not getattr(p, "need_clip", True):
                out.append((p, g))
            else:
                out.append((p, Tensor((g._value * scale).to(g.dtype))))
        return out

    @staticmethod
    def functional(grads_tree, clip_norm, reduce=None):
        """Clip a dict (or list) of raw gradients by their global norm;
        returns (clipped, norm). On a rank mesh `reduce(per_leaf)` sums
        the leaves' sums of squares over the ranks that split each leaf
        (counting a replicated leaf once; `parallel.mesh.sum_over_shards`),
        so the norm is the whole tensors'."""
        leaves = list(grads_tree.values()) if isinstance(grads_tree, dict) \
            else list(grads_tree)
        parts = [torch.sum(torch.square(g.float())) for g in leaves]
        gnorm = torch.sqrt(reduce(parts) if reduce is not None
                           else sum(parts[1:], parts[0]))
        scale = clip_norm / torch.clamp_min(gnorm, clip_norm)
        clip = lambda g: (g * scale).to(g.dtype)
        if isinstance(grads_tree, dict):
            return {k: clip(g) for k, g in grads_tree.items()}, gnorm
        return [clip(g) for g in leaves], gnorm


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    params = parameters if isinstance(parameters, (list, tuple)) \
        else [parameters]
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return Tensor(torch.zeros((), dtype=torch.float32))
    with torch.no_grad():
        if norm_type == float("inf"):
            total = torch.max(torch.stack([torch.max(torch.abs(g._value))
                                           for g in grads]))
        else:
            total = torch.pow(sum(torch.sum(torch.pow(torch.abs(
                g._value.float()), norm_type)) for g in grads),
                1.0 / norm_type)
        coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
        for p in params:
            if p.grad is not None:
                p.grad = Tensor((p.grad._value * coef).to(p.grad.dtype))
    return Tensor(total)


def clip_grad_value_(parameters, clip_value):
    params = parameters if isinstance(parameters, (list, tuple)) \
        else [parameters]
    for p in params:
        if p.grad is not None:
            p.grad = Tensor(torch.clamp(p.grad._value, -clip_value,
                                        clip_value))
