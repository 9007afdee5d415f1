"""Tensor creation ops (counterpart of `paddle_tpu/tensor/creation.py`).

New tensors go to `_core.state.torch_device()`: the card unless the
caller asked for the CPU with `set_device("cpu")`."""
from __future__ import annotations

import numpy as np
import torch

from .._core import dtypes as _dt
from .._core.state import prng, torch_device
from .._core.tensor import Parameter, Tensor, apply, unwrap
from .. import _prng

__all__ = [
    "to_tensor", "tensor", "zeros", "ones", "full", "empty", "zeros_like",
    "ones_like", "full_like", "empty_like", "arange", "linspace", "logspace",
    "eye", "tril", "triu", "tril_indices", "triu_indices", "meshgrid",
    "diag", "diagflat", "diag_embed", "diagonal", "assign", "clone",
    "complex", "real", "imag", "create_parameter", "one_hot", "polar",
    "cauchy_", "geometric_",
]


def _shape_list(shape):
    if isinstance(shape, Tensor):
        return [int(s) for s in shape.tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(unwrap(s)) for s in shape]


def _infer_dtype(data, dtype):
    if dtype is not None:
        return _dt.convert_dtype(dtype)
    a = np.asarray(data)
    if a.dtype == np.float64 and not isinstance(data, np.ndarray):
        # python floats follow the default dtype; float64 numpy arrays
        # keep their precision
        return _dt.get_default_dtype()
    if a.dtype.kind == "U":
        raise TypeError(f"to_tensor: cannot make a tensor of {a.dtype}")
    return _dt.convert_dtype(a.dtype)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    if isinstance(data, Tensor):
        out = data.astype(dtype) if dtype is not None else data.clone()
        out = Tensor(out._value.detach())
        out.stop_gradient = stop_gradient
        return out
    dev = torch_device()
    if isinstance(data, torch.Tensor):
        v = data.detach().to(dev)
        if dtype is not None:
            v = v.to(_dt.convert_dtype(dtype))
        return Tensor(v, stop_gradient=stop_gradient)
    d = _infer_dtype(data, dtype)
    arr = np.asarray(data)
    if d == torch.bfloat16 or arr.dtype.name == "bfloat16":
        v = torch.as_tensor(np.asarray(arr, dtype=np.float32)).to(d)
    else:
        v = torch.as_tensor(np.array(arr, copy=True)).to(d)
    return Tensor(v.to(dev), stop_gradient=stop_gradient)


tensor = to_tensor


def _dtype_or_default(dtype):
    return _dt.convert_dtype(dtype) if dtype else _dt.get_default_dtype()


def zeros(shape, dtype=None, name=None):
    return Tensor(torch.zeros(_shape_list(shape), dtype=_dtype_or_default(
        dtype), device=torch_device()))


def ones(shape, dtype=None, name=None):
    return Tensor(torch.ones(_shape_list(shape), dtype=_dtype_or_default(
        dtype), device=torch_device()))


def full(shape, fill_value, dtype=None, name=None):
    fill_value = unwrap(fill_value)
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    if dtype is None:
        if isinstance(fill_value, bool):
            d = _dt.bool_
        elif isinstance(fill_value, (int, np.integer)):
            d = _dt.int64
        elif isinstance(fill_value, float):
            d = _dt.get_default_dtype()
        else:
            d = _infer_dtype(fill_value, None)
    else:
        d = _dt.convert_dtype(dtype)
    return Tensor(torch.full(_shape_list(shape), fill_value, dtype=d,
                             device=torch_device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like_dtype(x, dtype):
    return _dt.convert_dtype(dtype) if dtype else unwrap(x).dtype


def zeros_like(x, dtype=None, name=None):
    return Tensor(torch.zeros_like(unwrap(x), dtype=_like_dtype(x, dtype)))


def ones_like(x, dtype=None, name=None):
    return Tensor(torch.ones_like(unwrap(x), dtype=_like_dtype(x, dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    fv = unwrap(fill_value)
    fv = fv.item() if isinstance(fv, torch.Tensor) else fv
    return Tensor(torch.full_like(unwrap(x), fv, dtype=_like_dtype(x, dtype)))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def _scalar(v):
    v = unwrap(v)
    return v.item() if isinstance(v, torch.Tensor) else v


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = _dt.get_default_dtype() if any(
            isinstance(v, float) for v in (start, end, step)) else _dt.int64
    d = _dt.convert_dtype(dtype)
    return Tensor(torch.from_numpy(np.arange(start, end, step)).to(d).to(
        torch_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return Tensor(torch.linspace(_scalar(start), _scalar(stop),
                                 int(_scalar(num)), dtype=_dtype_or_default(
                                     dtype), device=torch_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return Tensor(torch.logspace(_scalar(start), _scalar(stop),
                                 int(_scalar(num)), base=_scalar(base),
                                 dtype=_dtype_or_default(dtype),
                                 device=torch_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return Tensor(torch.eye(n, m, dtype=_dtype_or_default(dtype),
                            device=torch_device()))


def tril(x, diagonal=0, name=None):
    return apply(lambda a: torch.tril(a, int(diagonal)), x)


def triu(x, diagonal=0, name=None):
    return apply(lambda a: torch.triu(a, int(diagonal)), x)


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return Tensor(torch.tril_indices(row, col, offset, device=torch_device())
                  .to(_dt.convert_dtype(dtype)))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return Tensor(torch.triu_indices(row, col, offset, device=torch_device())
                  .to(_dt.convert_dtype(dtype)))


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(apply(lambda *xs: tuple(torch.meshgrid(*xs, indexing="ij")),
                      *args))


def diag(x, offset=0, padding_value=0, name=None):
    def fn(a):
        out = torch.diag(a, int(offset))
        if a.dim() == 1 and padding_value != 0:
            mask = torch.diag(torch.ones_like(a, dtype=torch.bool),
                              int(offset))
            out = torch.where(mask, out, torch.full_like(out, padding_value))
        return out
    return apply(fn, x)


def diagflat(x, offset=0, name=None):
    return apply(lambda a: torch.diagflat(a, int(offset)), x)


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    return apply(lambda a: torch.diag_embed(a, offset, dim1, dim2), input)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(lambda a: torch.diagonal(a, int(offset), int(axis1),
                                          int(axis2)), x)


def assign(x, output=None):
    v = to_tensor(x) if not isinstance(x, Tensor) else x.clone()
    if output is not None:
        output._replace(v._value)
        return output
    return v


def clone(x, name=None):
    return x.clone()


def complex(real, imag, name=None):
    return apply(torch.complex, real, imag)


def real(x, name=None):
    return apply(torch.real, x)


def imag(x, name=None):
    return apply(torch.imag, x)


def polar(abs, angle, name=None):
    return apply(torch.polar, abs, angle)


def one_hot(x, num_classes, name=None):
    return apply(lambda a: torch.nn.functional.one_hot(
        a.long(), int(num_classes)).to(_dt.get_default_dtype()), x)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..nn.initializer import Constant, XavierUniform
    init = default_initializer or (Constant(0.0) if is_bias
                                   else XavierUniform())
    value = init._generate(tuple(shape), _dt.convert_dtype(dtype))
    return Parameter(value, name=name)


def cauchy_(x, loc=0, scale=1, name=None):
    u = _prng.uniform_real(prng.next_key(), x.shape, torch.float32,
                           device=x._value.device)
    x._replace((loc + scale * torch.tan(np.pi * (u - 0.5))).to(x.dtype))
    return x


def geometric_(x, probs, name=None):
    u = _prng.uniform_real(prng.next_key(), x.shape, torch.float32, 1e-7,
                           1.0, device=x._value.device)
    x._replace(torch.ceil(torch.log(u) / np.log1p(-probs)).to(x.dtype))
    return x
