"""Normalization functionals (counterpart of
`paddle_tpu/nn/functional/norm.py`): fp32 statistics, the output in the
input's dtype. Cross-replica batch norm (`sync_axis`) is not ported."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..._core.tensor import Tensor, apply

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "local_response_norm", "normalize", "rms_norm"]


def _opt_args(*ts):
    return [t for t in ts if t is not None]


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, sync_axis=None,
               name=None):
    """Functional BN; in training mode it updates the running stats in
    place."""
    if sync_axis is not None:
        raise NotImplementedError(
            "paddle_tpu_torch: batch_norm's sync_axis (SyncBatchNorm) is "
            "not ported yet (ROADMAP.md, Queue 1 item 13b)")
    channel_last = data_format[-1] == "C" and len(data_format) > 2
    if use_global_stats is None:
        use_global_stats = not training
    ch_axis = (x.ndim - 1) if channel_last else (1 if x.ndim > 1 else 0)
    red_axes = tuple(i for i in range(x.ndim) if i != ch_axis)
    bshape = [1] * x.ndim
    bshape[ch_axis] = -1
    has_w, has_b = weight is not None, bias is not None

    def affine(out, rest):
        rest = list(rest)
        if has_w:
            out = out * rest.pop(0).reshape(bshape)
        if has_b:
            out = out + rest.pop(0).reshape(bshape)
        return out

    if use_global_stats:
        def fn(a, rm, rv, *rest):
            inv = torch.rsqrt(rv.float() + epsilon)
            out = (a.float() - rm.reshape(bshape)) * inv.reshape(bshape)
            return affine(out, rest).to(a.dtype)
        return apply(fn, x, running_mean, running_var,
                     *_opt_args(weight, bias))

    def fn(a, *rest):
        af = a.float()
        mean = torch.mean(af, red_axes)
        var = torch.var(af, red_axes, correction=0)
        out = (af - mean.reshape(bshape)) * torch.rsqrt(
            var + epsilon).reshape(bshape)
        return affine(out, rest).to(a.dtype), mean, var

    out, mean_t, var_t = apply(fn, x, *_opt_args(weight, bias), multi=True)
    if isinstance(running_mean, Tensor):
        m = float(momentum)
        with torch.no_grad():
            rm = running_mean._value * m + mean_t._value.detach().to(
                running_mean.dtype) * (1 - m)
            rv = running_var._value * m + var_t._value.detach().to(
                running_var.dtype) * (1 - m)
        running_mean._replace(rm)
        running_var._replace(rv)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    ns = normalized_shape if isinstance(normalized_shape, (list, tuple)) \
        else [normalized_shape]
    naxes = tuple(range(-len(ns), 0))
    has_w, has_b = weight is not None, bias is not None

    def fn(a, *rest):
        rest = list(rest)
        af = a.float()
        mean = torch.mean(af, naxes, keepdim=True)
        var = torch.var(af, naxes, correction=0, keepdim=True)
        out = (af - mean) * torch.rsqrt(var + epsilon)
        if has_w:
            out = out * rest.pop(0).float()
        if has_b:
            out = out + rest.pop(0).float()
        return out.to(a.dtype)
    return apply(fn, x, *_opt_args(weight, bias))


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm: fp32 statistics, the output in x's dtype."""
    def fn(a, w=None):
        af = a.float()
        out = af * torch.rsqrt(torch.mean(af * af, -1, keepdim=True)
                               + epsilon)
        if w is not None:
            out = out * w.float()
        return out.to(a.dtype)
    return apply(fn, x, *_opt_args(weight))


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    channel_last = data_format[-1] == "C" and len(data_format) > 2
    ch_axis = (x.ndim - 1) if channel_last else 1
    red_axes = tuple(range(2, x.ndim)) if not channel_last else \
        tuple(range(1, x.ndim - 1))
    has_w, has_b = weight is not None, bias is not None
    s = [1] * x.ndim
    s[ch_axis] = -1

    def fn(a, *rest):
        rest = list(rest)
        af = a.float()
        mean = torch.mean(af, red_axes, keepdim=True)
        var = torch.var(af, red_axes, correction=0, keepdim=True)
        out = (af - mean) * torch.rsqrt(var + eps)
        if has_w:
            out = out * rest.pop(0).reshape(s)
        if has_b:
            out = out + rest.pop(0).reshape(s)
        return out.to(a.dtype)
    return apply(fn, x, *_opt_args(weight, bias))


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    channel_last = data_format[-1] == "C" and len(data_format) > 2
    has_w, has_b = weight is not None, bias is not None

    def fn(a, *rest):
        rest = list(rest)
        a_nchw = a.movedim(-1, 1) if channel_last else a
        n, c = a_nchw.shape[0], a_nchw.shape[1]
        g = int(num_groups)
        af = a_nchw.float().reshape(n, g, c // g, -1)
        mean = torch.mean(af, (2, 3), keepdim=True)
        var = torch.var(af, (2, 3), correction=0, keepdim=True)
        out = ((af - mean) * torch.rsqrt(var + epsilon)).reshape(
            a_nchw.shape)
        s = [1, c] + [1] * (a_nchw.dim() - 2)
        if has_w:
            out = out * rest.pop(0).reshape(s)
        if has_b:
            out = out + rest.pop(0).reshape(s)
        out = out.to(a.dtype)
        return out.movedim(1, -1) if channel_last else out
    return apply(fn, x, *_opt_args(weight, bias))


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    channel_last = data_format[-1] == "C" and len(data_format) > 2

    def fn(a):
        ch_axis = a.dim() - 1 if channel_last else 1
        sq = torch.square(a.float()).movedim(ch_axis, -1)
        half = size // 2
        padded = TF.pad(sq, (half, size - 1 - half))
        n = sq.shape[-1]
        summed = sum(padded[..., i:i + n] for i in range(size))
        denom = torch.pow(k + alpha * summed, beta)
        return (a.float() / denom.movedim(-1, ch_axis)).to(a.dtype)
    return apply(fn, x)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def fn(a):
        if p == 2:
            n = torch.sqrt(torch.sum(torch.square(a), axis, keepdim=True))
        else:
            n = torch.pow(torch.sum(torch.pow(torch.abs(a), p), axis,
                                    keepdim=True), 1.0 / p)
        return a / torch.clamp_min(n, epsilon)
    return apply(fn, x)
