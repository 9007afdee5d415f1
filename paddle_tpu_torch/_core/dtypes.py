"""Dtype system (counterpart of `paddle_tpu/_core/dtypes.py`).

Paddle's dtype names map to torch dtypes, which are the canonical dtype
objects here: `Tensor.dtype` is a `torch.dtype`, and `dtype_name` gives
the Paddle name ("float32", "bfloat16", ...) that tests compare by.
"""
from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

_STR2DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "bfloat16": bfloat16,
    "float32": float32, "float64": float64, "complex64": complex64,
    "complex128": complex128, "float8_e4m3fn": float8_e4m3fn,
    "float8_e5m2": float8_e5m2,
    # paddle legacy VarDesc-style names
    "BOOL": bool_, "UINT8": uint8, "INT8": int8, "INT16": int16,
    "INT32": int32, "INT64": int64, "FP16": float16, "BF16": bfloat16,
    "FP32": float32, "FP64": float64,
    # numpy spellings
    "bool_": bool_, "float": float32, "half": float16, "double": float64,
}
_DTYPE2STR = {v: k for k, v in reversed(list(_STR2DTYPE.items()))
              if k.islower() and k not in ("bool_", "float", "half", "double")}

FLOATING = {float16, bfloat16, float32, float64, float8_e4m3fn, float8_e5m2}
INTEGER = {uint8, int8, int16, int32, int64}
COMPLEX = {complex64, complex128}

_default_dtype = float32


def convert_dtype(dtype):
    """Any dtype-ish (str, numpy dtype or type, torch dtype) -> torch
    dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.split(".")[-1]
        if key in _STR2DTYPE:
            return _STR2DTYPE[key]
        dtype = np.dtype(key)
    name = np.dtype(dtype).name
    if name not in _STR2DTYPE:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _STR2DTYPE[name]


def set_default_dtype(d):
    global _default_dtype
    d = convert_dtype(d)
    if d not in (float16, bfloat16, float32, float64):
        raise TypeError(f"set_default_dtype only supports float dtypes, got {d}")
    _default_dtype = d


def get_default_dtype():
    return _default_dtype


def is_floating_point_dtype(d):
    return convert_dtype(d) in FLOATING


def is_integer_dtype(d):
    return convert_dtype(d) in INTEGER


def is_complex_dtype(d):
    return convert_dtype(d) in COMPLEX


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))


def promote_types(a, b):
    return torch.promote_types(convert_dtype(a), convert_dtype(b))


def dtype_name(d):
    """The Paddle name of a dtype: "float32", "bfloat16", "int64", ..."""
    return _DTYPE2STR[convert_dtype(d)]
