"""Elementwise and reduction math ops (counterpart of
`paddle_tpu/tensor/math.py`): each a Paddle-shaped wrapper over a torch
function, differentiated by torch autograd."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from .._core import dtypes as _dt
from .._core.tensor import Tensor, apply, unwrap

__all__ = []


def _export(name, fn):
    globals()[name] = fn
    __all__.append(name)


def _axis_arg(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(a, axis):
    """A tuple of the dims to reduce (all of them for None)."""
    ax = _axis_arg(axis)
    if ax is None:
        return tuple(range(a.dim()))
    return ax if isinstance(ax, tuple) else (ax,)


def _t(v, like):
    """A numpy array or list operand as a torch tensor beside `like`;
    Python scalars and tensors pass through."""
    if isinstance(v, (np.ndarray, list, tuple, np.generic)):
        return torch.as_tensor(np.asarray(v), device=like.device)
    return v


def _float(a):
    """Integers and bools widen to float64, as jnp's x64 promotion does
    for a float-valued op."""
    return a if a.is_floating_point() or a.is_complex() else a.double()


# ---------------------------------------------------------------- unary ops
_UNARY = {
    "abs": torch.abs, "acos": torch.acos, "acosh": torch.acosh,
    "asin": torch.asin, "asinh": torch.asinh, "atan": torch.atan,
    "atanh": torch.atanh, "ceil": torch.ceil, "conj": torch.conj_physical,
    "cos": torch.cos, "cosh": torch.cosh, "digamma": torch.digamma,
    "erf": torch.erf, "erfinv": torch.erfinv, "exp": torch.exp,
    "expm1": torch.expm1, "floor": torch.floor, "lgamma": torch.lgamma,
    "log": torch.log, "log10": torch.log10, "log1p": torch.log1p,
    "log2": torch.log2, "neg": torch.neg, "reciprocal": torch.reciprocal,
    "round": torch.round, "rsqrt": torch.rsqrt, "sigmoid": torch.sigmoid,
    "sign": torch.sign, "sgn": torch.sgn, "sin": torch.sin,
    "sinc": torch.sinc, "sinh": torch.sinh, "sqrt": torch.sqrt,
    "square": torch.square, "tan": torch.tan, "tanh": torch.tanh,
    "trunc": torch.trunc, "deg2rad": torch.deg2rad, "rad2deg": torch.rad2deg,
    "angle": torch.angle, "i0": torch.i0, "i0e": torch.special.i0e,
    "i1": torch.special.i1, "i1e": torch.special.i1e,
    "signbit": torch.signbit,
}
# ops of a float result that jnp widens integer inputs for
_FLOAT_RESULT = {"acos", "acosh", "asin", "asinh", "atan", "atanh", "cos",
                 "cosh", "digamma", "erf", "erfinv", "exp", "expm1",
                 "lgamma", "log", "log10", "log1p", "log2", "reciprocal",
                 "rsqrt", "sigmoid", "sin", "sinc", "sinh", "sqrt", "tan",
                 "tanh", "deg2rad", "rad2deg", "i0", "i0e", "i1", "i1e"}
for _n, _f in _UNARY.items():
    def _mk(f=_f, n=_n):
        if n in _FLOAT_RESULT:
            def op(x, name=None):
                return apply(lambda a: f(_float(a)), x)
        else:
            def op(x, name=None):
                return apply(f, x)
        op.__name__ = n
        return op
    _export(_n, _mk())


def frac(x, name=None):
    return apply(lambda a: a - torch.trunc(a), x)


def frexp(x, name=None):
    return apply(lambda a: tuple(torch.frexp(a)), x, multi=True)


def logit(x, eps=None, name=None):
    def fn(a):
        if eps is not None:
            a = torch.clamp(a, eps, 1.0 - eps)
        return torch.log(a / (1.0 - a))
    return apply(fn, x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply(lambda a: scale_b * torch.tanh(scale_a * a), x)


def multigammaln(x, p, name=None):
    return apply(lambda a: torch.special.multigammaln(a, int(p)), x)


def polygamma(x, n, name=None):
    return apply(lambda a: torch.special.polygamma(int(n), a), x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply(lambda a: torch.nan_to_num(a, nan, posinf, neginf), x)


for _n in ["frac", "logit", "stanh", "multigammaln", "polygamma",
           "nan_to_num", "frexp"]:
    __all__.append(_n)


# --------------------------------------------------------------- binary ops
def _true_divide(a, b):
    if isinstance(a, torch.Tensor) and not (a.is_floating_point() or
                                            a.is_complex()):
        b_int = not isinstance(b, float) and not (
            isinstance(b, torch.Tensor) and (b.is_floating_point() or
                                             b.is_complex()))
        if b_int:
            a = a.to(_dt.get_default_dtype())
    return torch.true_divide(a, b)


_BINARY = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": _true_divide, "floor_divide": torch.floor_divide,
    "mod": torch.remainder, "remainder": torch.remainder,
    "floor_mod": torch.remainder, "pow": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum, "fmax": torch.fmax,
    "fmin": torch.fmin, "atan2": torch.atan2, "logaddexp": torch.logaddexp,
    "hypot": torch.hypot, "copysign": torch.copysign,
    "nextafter": torch.nextafter, "ldexp": torch.ldexp, "gcd": torch.gcd,
    "lcm": torch.lcm, "heaviside": torch.heaviside, "kron": torch.kron,
}
# torch functions that take only tensors on both sides
_TENSOR_ONLY = {"maximum", "minimum", "fmax", "fmin", "atan2", "logaddexp",
                "hypot", "nextafter", "gcd", "lcm", "heaviside", "kron"}


def _binary(tfn, n):
    def op(x, y, name=None):
        def fn(a, b):
            if not isinstance(a, torch.Tensor):
                a, b = torch.as_tensor(a, device=b.device), b
            b = _t(b, a)
            if n in _TENSOR_ONLY and not isinstance(b, torch.Tensor):
                b = torch.tensor(b, device=a.device)
                if a.is_floating_point() or not b.is_floating_point():
                    b = b.to(a.dtype)       # a Python scalar is weak
            return tfn(a, b)
        return apply(fn, x, y)
    op.__name__ = n
    return op


for _n, _f in _BINARY.items():
    _export(_n, _binary(_f, _n))


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        inputs = [inputs]
    return apply(lambda *xs: builtins.sum(xs[1:], xs[0]), *inputs)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    s, b = unwrap(scale), unwrap(bias)

    def fn(a):
        st = torch.as_tensor(s, dtype=a.dtype, device=a.device)
        bt = torch.as_tensor(b, dtype=a.dtype, device=a.device)
        return a * st + bt if bias_after_scale else (a + bt) * st
    return apply(fn, x)


def clip(x, min=None, max=None, name=None):
    lo = unwrap(min) if min is not None else None
    hi = unwrap(max) if max is not None else None
    return apply(lambda a: torch.clamp(a, lo, hi), x)


def lerp(x, y, weight, name=None):
    if isinstance(weight, (int, float)):
        return apply(lambda a, b: a + weight * (b - a), x, y)
    return apply(lambda a, b, w: a + w * (b - a), x, y, weight)


def increment(x, value=1.0, name=None):
    out = apply(lambda a: a + torch.as_tensor(value, dtype=a.dtype,
                                              device=a.device), x)
    x._replace(out._value)
    return x


def multiplex(inputs, index, name=None):
    def fn(idx, *xs):
        stacked = torch.stack(xs, 0)
        sel = idx.reshape(-1).long()
        return stacked[sel, torch.arange(sel.shape[0], device=sel.device)]
    return apply(fn, index, *inputs)


def _reduce_all(tfn):
    """A reduction over `axis` (None: all dims) with keepdim."""
    def red(a, axis, keepdim, **kw):
        dims = _dims(a, axis)
        if not dims:
            return a
        return tfn(a, dim=dims, keepdim=keepdim, **kw)
    return red


_amax = _reduce_all(torch.amax)
_amin = _reduce_all(torch.amin)


def amax(x, axis=None, keepdim=False, name=None):
    return apply(lambda a: _amax(a, axis, keepdim), x)


def amin(x, axis=None, keepdim=False, name=None):
    return apply(lambda a: _amin(a, axis, keepdim), x)


max = amax
min = amin


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    d = _dt.convert_dtype(dtype) if dtype else None

    def fn(a):
        out_d = d
        if out_d is None and a.dtype == torch.bool:
            out_d = _dt.int64
        dims = _dims(a, axis)
        if not dims:
            return a.to(out_d) if out_d is not None else a
        return torch.sum(a, dim=dims, keepdim=keepdim, dtype=out_d)
    return apply(fn, x)


def mean(x, axis=None, keepdim=False, name=None):
    def fn(a):
        a = _float(a)
        dims = _dims(a, axis)
        return torch.mean(a, dim=dims, keepdim=keepdim) if dims else a
    return apply(fn, x)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    d = _dt.convert_dtype(dtype) if dtype else None

    def fn(a):
        if d is not None:
            a = a.to(d)
        for ax in sorted((x_ % builtins.max(a.dim(), 1)
                          for x_ in _dims(a, axis)), reverse=True):
            a = torch.prod(a, dim=ax, keepdim=keepdim)
        return a
    return apply(fn, x)


def nanmean(x, axis=None, keepdim=False, name=None):
    return apply(lambda a: torch.nanmean(_float(a), dim=_dims(a, axis),
                                         keepdim=keepdim), x)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    d = _dt.convert_dtype(dtype) if dtype else None
    return apply(lambda a: torch.nansum(a, dim=_dims(a, axis),
                                        keepdim=keepdim, dtype=d), x)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    def fn(a):
        out = torch.sum(a != 0, dim=_dims(a, axis), keepdim=keepdim)
        return out.to(_dt.int64)
    return apply(fn, x)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return apply(lambda a: torch.logsumexp(_float(a), dim=_dims(a, axis),
                                           keepdim=keepdim), x)


def all(x, axis=None, keepdim=False, name=None):
    return apply(lambda a: torch.all(a.bool(), dim=_dims(a, axis),
                                     keepdim=keepdim) if a.dim() else
                 a.bool(), x)


def any(x, axis=None, keepdim=False, name=None):
    return apply(lambda a: torch.any(a.bool(), dim=_dims(a, axis),
                                     keepdim=keepdim) if a.dim() else
                 a.bool(), x)


def cumsum(x, axis=None, dtype=None, name=None):
    d = _dt.convert_dtype(dtype) if dtype else None

    def fn(a):
        if axis is None:
            return torch.cumsum(a.reshape(-1), 0, dtype=d)
        return torch.cumsum(a, int(axis), dtype=d)
    return apply(fn, x)


def cumprod(x, dim=None, dtype=None, name=None):
    d = _dt.convert_dtype(dtype) if dtype else None
    return apply(lambda a: torch.cumprod(a, int(dim), dtype=d), x)


def cummax(x, axis=None, dtype="int64", name=None):
    def fn(a):
        arr = a.reshape(-1) if axis is None else a
        v, i = torch.cummax(arr, 0 if axis is None else int(axis))
        return v, i.to(_dt.convert_dtype(dtype))
    return apply(fn, x, multi=True)


def cummin(x, axis=None, dtype="int64", name=None):
    def fn(a):
        arr = a.reshape(-1) if axis is None else a
        v, i = torch.cummin(arr, 0 if axis is None else int(axis))
        return v, i.to(_dt.convert_dtype(dtype))
    return apply(fn, x, multi=True)


def logcumsumexp(x, axis=None, name=None):
    def fn(a):
        arr = a.reshape(-1) if axis is None else a
        return torch.logcumsumexp(arr, 0 if axis is None else int(axis))
    return apply(fn, x)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return apply(lambda a, p, q: torch.diff(a, n, axis, p, q), x, prepend,
                 append)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply(lambda yy, xx: torch.trapezoid(yy, xx, dim=axis), y, x)
    return apply(lambda yy: torch.trapezoid(yy, dx=dx or 1.0, dim=axis), y)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply(lambda yy, xx: torch.cumulative_trapezoid(
            yy, xx, dim=axis), y, x)
    return apply(lambda yy: torch.cumulative_trapezoid(
        yy, dx=dx or 1.0, dim=axis), y)


def isfinite(x, name=None):
    return apply(torch.isfinite, x)


def isinf(x, name=None):
    return apply(torch.isinf, x)


def isnan(x, name=None):
    return apply(torch.isnan, x)


def isneginf(x, name=None):
    return apply(torch.isneginf, x)


def isposinf(x, name=None):
    return apply(torch.isposinf, x)


def isreal(x, name=None):
    return apply(torch.isreal, x)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def inner(x, y, name=None):
    return apply(torch.inner, x, y)


def outer(x, y, name=None):
    return apply(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
                 x, y)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply(lambda i, a, b: beta * i + alpha * (a @ b), input, x, y)


def renorm(x, p, axis, max_norm, name=None):
    def fn(a):
        dims = tuple(i for i in range(a.dim()) if i != axis % a.dim())
        norms = torch.pow(torch.sum(torch.pow(torch.abs(a), p), dim=dims,
                                    keepdim=True), 1.0 / p)
        factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                             torch.ones_like(norms))
        return a * factor
    return apply(fn, x)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(lambda a: torch.diagonal(a, offset, axis1, axis2).sum(-1),
                 x)


def vander(x, n=None, increasing=False, name=None):
    return apply(lambda a: torch.vander(a, n, increasing), x)


def gammaln(x, name=None):
    return apply(lambda a: torch.lgamma(_float(a)), x)


def gammainc(x, y, name=None):
    return apply(torch.special.gammainc, x, y)


def gammaincc(x, y, name=None):
    return apply(torch.special.gammaincc, x, y)


for _n in ["add_n", "scale", "clip", "lerp", "increment", "multiplex", "amax",
           "amin", "max", "min", "sum", "mean", "prod", "nanmean", "nansum",
           "count_nonzero", "logsumexp", "all", "any", "cumsum", "cumprod",
           "cummax", "cummin", "logcumsumexp", "diff", "trapezoid",
           "cumulative_trapezoid", "isfinite", "isinf", "isnan", "isneginf",
           "isposinf", "isreal", "broadcast_shape", "inner", "outer",
           "addmm", "renorm", "trace", "vander", "gammaln", "gammainc",
           "gammaincc"]:
    __all__.append(_n)
