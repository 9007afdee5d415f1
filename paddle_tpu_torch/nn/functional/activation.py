"""Activation functionals (counterpart of
`paddle_tpu/nn/functional/activation.py`), each a torch function on
Tensors."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import _prng
from ..._core import dtypes as _dt
from ..._core.state import prng
from ..._core.tensor import apply
from ...tensor.extras import inplace_apply

__all__ = [
    "relu", "relu_", "relu6", "elu", "elu_", "celu", "selu", "gelu", "silu",
    "hardtanh_", "leaky_relu_", "thresholded_relu_",
    "swish", "sigmoid", "hardsigmoid", "hardswish", "hardtanh", "hardshrink",
    "softshrink", "tanhshrink", "thresholded_relu", "leaky_relu", "prelu",
    "rrelu", "log_sigmoid", "maxout", "softmax", "softmax_", "log_softmax",
    "softplus", "softsign", "tanh", "tanh_", "mish", "glu", "gumbel_softmax",
    "sigmoid_focal_loss_act",
]


def _zero(a):
    return torch.zeros((), dtype=a.dtype, device=a.device)


def relu(x, name=None):
    return apply(torch.relu, x)


def relu6(x, name=None):
    return apply(lambda a: torch.clamp(a, 0.0, 6.0), x)


def elu(x, alpha=1.0, name=None):
    return apply(lambda a: TF.elu(a, alpha), x)


def celu(x, alpha=1.0, name=None):
    return apply(lambda a: TF.celu(a, alpha), x)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply(lambda a: scale * torch.where(a > 0, a,
                                               alpha * torch.expm1(a)), x)


def gelu(x, approximate=False, name=None):
    return apply(lambda a: TF.gelu(a, approximate="tanh" if approximate
                                   else "none"), x)


def silu(x, name=None):
    return apply(TF.silu, x)


def swish(x, name=None):
    return apply(TF.silu, x)


def sigmoid(x, name=None):
    return apply(torch.sigmoid, x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply(lambda a: torch.clamp(slope * a + offset, 0.0, 1.0), x)


def hardswish(x, name=None):
    return apply(lambda a: a * torch.clamp(a + 3.0, 0.0, 6.0) / 6.0, x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply(lambda a: torch.clamp(a, min, max), x)


def hardshrink(x, threshold=0.5, name=None):
    return apply(lambda a: torch.where(torch.abs(a) > threshold, a,
                                       _zero(a)), x)


def softshrink(x, threshold=0.5, name=None):
    return apply(lambda a: torch.where(
        a > threshold, a - threshold,
        torch.where(a < -threshold, a + threshold, _zero(a))), x)


def tanhshrink(x, name=None):
    return apply(lambda a: a - torch.tanh(a), x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply(lambda a: torch.where(a > threshold, a, torch.tensor(
        value, dtype=a.dtype, device=a.device)), x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply(lambda a: TF.leaky_relu(a, negative_slope), x)


def prelu(x, weight, data_format="NCHW", name=None):
    def fn(a, w):
        if w.numel() == 1:
            return torch.where(a > 0, a, w.reshape(()) * a)
        ch_axis = 1 if data_format[1] == "C" else a.dim() - 1
        shape = [1] * a.dim()
        shape[ch_axis] = w.numel()
        return torch.where(a > 0, a, w.reshape(shape) * a)
    return apply(fn, x, weight)


def rrelu(x, lower=0.125, upper=0.3333333, training=False, name=None):
    if training:
        key = prng.next_key()

        def fn(a):
            slope = _prng.uniform_real(key, tuple(a.shape), torch.float32,
                                       lower, upper, device=a.device)
            return torch.where(a >= 0, a, slope.to(a.dtype) * a)
        return apply(fn, x)
    mid = (lower + upper) / 2.0
    return apply(lambda a: torch.where(a >= 0, a, mid * a), x)


def log_sigmoid(x, name=None):
    return apply(TF.logsigmoid, x)


def maxout(x, groups, axis=1, name=None):
    def fn(a):
        ax = axis % a.dim()
        c = a.shape[ax]
        shape = a.shape[:ax] + (c // groups, groups) + a.shape[ax + 1:]
        return torch.amax(a.reshape(shape), ax + 1)
    return apply(fn, x)


def _maybe_cast(a, dtype):
    return a.to(_dt.convert_dtype(dtype)) if dtype is not None else a


def softmax(x, axis=-1, dtype=None, name=None):
    return apply(lambda a: torch.softmax(_maybe_cast(a, dtype), int(axis)), x)


def log_softmax(x, axis=-1, dtype=None, name=None):
    return apply(lambda a: torch.log_softmax(_maybe_cast(a, dtype),
                                             int(axis)), x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply(lambda a: torch.where(a * beta > threshold, a,
                                       torch.log1p(torch.exp(beta * a)) / beta),
                 x)


def softsign(x, name=None):
    return apply(TF.softsign, x)


def tanh(x, name=None):
    return apply(torch.tanh, x)


def mish(x, name=None):
    return apply(lambda a: a * torch.tanh(TF.softplus(a)), x)


def glu(x, axis=-1, name=None):
    def fn(a):
        a1, a2 = torch.chunk(a, 2, int(axis))
        return a1 * torch.sigmoid(a2)
    return apply(fn, x)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    key = prng.next_key()

    def fn(a):
        dtype = a.dtype if a.is_floating_point() else torch.float32
        u = _prng.uniform_real(key, tuple(a.shape), dtype,
                               torch.finfo(dtype).tiny, 1.0, device=a.device)
        y = torch.softmax((a - torch.log(-torch.log(u))) / temperature, axis)
        if hard:
            idx = torch.argmax(y, axis, keepdim=True)
            onehot = torch.zeros_like(y).scatter(axis, idx, 1.0)
            return onehot - y.detach() + y
        return y
    return apply(fn, x)


def sigmoid_focal_loss_act(x):
    return sigmoid(x)


def relu_(x, name=None):
    return inplace_apply(x, relu)


def elu_(x, alpha=1.0, name=None):
    return inplace_apply(x, lambda t: elu(t, alpha))


def softmax_(x, axis=-1, dtype=None, name=None):
    return inplace_apply(x, lambda t: softmax(t, axis, dtype))


def tanh_(x, name=None):
    return inplace_apply(x, tanh)


def hardtanh_(x, min=-1.0, max=1.0, name=None):
    return inplace_apply(x, lambda t: hardtanh(t, min, max))


def leaky_relu_(x, negative_slope=0.01, name=None):
    return inplace_apply(x, lambda t: leaky_relu(t, negative_slope))


def thresholded_relu_(x, threshold=1.0, value=0.0, name=None):
    return inplace_apply(x, lambda t: thresholded_relu(t, threshold, value))
