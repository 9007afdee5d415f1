"""Tensor attribute queries (counterpart of `paddle_tpu/tensor/attribute.py`)."""
from __future__ import annotations

import torch

from .._core import dtypes as _dt
from .._core.tensor import Tensor

__all__ = ["shape", "is_complex", "is_floating_point", "is_integer", "rank",
           "real", "imag", "numel"]


def shape(input):
    return Tensor(torch.tensor(input.shape, dtype=torch.int32,
                               device=input._value.device))


def is_complex(x):
    return _dt.is_complex_dtype(x.dtype)


def is_floating_point(x):
    return _dt.is_floating_point_dtype(x.dtype)


def is_integer(x):
    return _dt.is_integer_dtype(x.dtype)


def rank(input):
    return Tensor(torch.tensor(input.ndim, device=input._value.device))


from .creation import real, imag  # noqa: E402,F401
from .stat import numel  # noqa: E402,F401
