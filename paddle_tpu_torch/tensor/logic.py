"""Comparison and logical ops (counterpart of `paddle_tpu/tensor/logic.py`)."""
from __future__ import annotations

import torch

from .._core.tensor import Tensor, apply, unwrap

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "allclose", "isclose",
    "equal_all", "is_empty", "is_tensor", "isin",
]


def _operand(b, a):
    """y as a tensor beside x; a 0-d y takes x's dtype (a weak scalar)."""
    b = torch.as_tensor(b, device=a.device)
    return b.to(a.dtype) if b.dim() == 0 else b


def _cmp(tfn, n):
    def op(x, y, name=None):
        return apply(lambda a, b: tfn(a, _operand(b, a)), x, y)
    op.__name__ = n
    return op


equal = _cmp(torch.eq, "equal")
not_equal = _cmp(torch.ne, "not_equal")
greater_than = _cmp(torch.gt, "greater_than")
greater_equal = _cmp(torch.ge, "greater_equal")
less_than = _cmp(torch.lt, "less_than")
less_equal = _cmp(torch.le, "less_equal")


def _logical(tfn, n):
    def op(x, y=None, out=None, name=None):
        if y is None:
            return apply(tfn, x)
        return apply(lambda a, b: tfn(a, _operand(b, a)), x, y)
    op.__name__ = n
    return op


logical_and = _logical(torch.logical_and, "logical_and")
logical_or = _logical(torch.logical_or, "logical_or")
logical_xor = _logical(torch.logical_xor, "logical_xor")
bitwise_and = _logical(torch.bitwise_and, "bitwise_and")
bitwise_or = _logical(torch.bitwise_or, "bitwise_or")
bitwise_xor = _logical(torch.bitwise_xor, "bitwise_xor")


def logical_not(x, out=None, name=None):
    return apply(torch.logical_not, x)


def bitwise_not(x, out=None, name=None):
    return apply(torch.bitwise_not, x)


def bitwise_left_shift(x, y, is_arithmetic=True, out=None, name=None):
    return apply(lambda a, b: torch.bitwise_left_shift(a, _operand(b, a)),
                 x, y)


def bitwise_right_shift(x, y, is_arithmetic=True, out=None, name=None):
    def fn(a, b):
        b = _operand(b, a)
        if is_arithmetic:
            return torch.bitwise_right_shift(a, b)
        bits = a.element_size() * 8
        mask = (1 << (bits - b.long())) - 1
        return (torch.bitwise_right_shift(a, b).long() & mask).to(a.dtype)
    return apply(fn, x, y)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply(lambda a, b: torch.tensor(torch.allclose(
        a, _operand(b, a), float(unwrap(rtol)), float(unwrap(atol)),
        equal_nan), device=a.device), x, y)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply(lambda a, b: torch.isclose(
        a, _operand(b, a), float(unwrap(rtol)), float(unwrap(atol)),
        equal_nan), x, y)


def equal_all(x, y, name=None):
    return apply(lambda a, b: torch.tensor(
        a.shape == b.shape and bool(torch.equal(a, b)), device=a.device),
        x, y)


def is_empty(x, name=None):
    return Tensor(torch.tensor(x.size == 0, device=x._value.device))


def is_tensor(x):
    return isinstance(x, Tensor)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return apply(lambda a, t: torch.isin(a, t, invert=invert), x, test_x)
