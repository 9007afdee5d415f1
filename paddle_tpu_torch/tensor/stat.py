"""Statistics ops (counterpart of `paddle_tpu/tensor/stat.py`)."""
from __future__ import annotations

import numpy as np
import torch

from .._core.tensor import apply
from .math import _dims, _float, mean  # noqa: F401

__all__ = ["mean", "std", "var", "median", "nanmedian", "quantile",
           "nanquantile", "numel"]


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply(lambda a: torch.std(_float(a), dim=_dims(a, axis),
                                     correction=1 if unbiased else 0,
                                     keepdim=keepdim), x)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply(lambda a: torch.var(_float(a), dim=_dims(a, axis),
                                     correction=1 if unbiased else 0,
                                     keepdim=keepdim), x)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    def fn(a):
        arr = a.reshape(-1) if axis is None else a
        ax = 0 if axis is None else int(axis)
        if mode == "avg":
            # the mean of the two middle values for an even count
            q = torch.quantile(_float(arr), 0.5, dim=ax, keepdim=keepdim)
            if axis is None and keepdim:
                q = q.reshape([1] * a.dim())
            return q.to(a.dtype) if a.is_floating_point() else q
        n = arr.shape[ax]
        sv, si = torch.sort(arr, dim=ax, stable=True)
        k = (n - 1) // 2
        v = sv.select(ax, k)
        i = si.select(ax, k)
        if keepdim and axis is not None:
            v, i = v.unsqueeze(ax), i.unsqueeze(ax)
        return v, i
    if mode == "avg":
        return apply(fn, x)
    return apply(fn, x, multi=True)


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    def fn(a):
        arr = a.reshape(-1) if axis is None else a
        ax = 0 if axis is None else int(axis)
        return torch.nanquantile(_float(arr), 0.5, dim=ax,
                                 keepdim=keepdim).to(a.dtype)
    return apply(fn, x)


def _quantile(tfn, x, q, axis, keepdim, interpolation):
    def fn(a):
        qq = torch.as_tensor(np.asarray(q, dtype=np.float64),
                             device=a.device)
        arr = a.double()
        if axis is None:
            out = tfn(arr.reshape(-1), qq, interpolation=interpolation)
            if keepdim:
                out = out.reshape(out.shape[:qq.dim()] + (1,) * a.dim())
        elif isinstance(axis, (list, tuple)):
            dims = [d % a.dim() for d in axis]
            rest = [d for d in range(a.dim()) if d not in dims]
            moved = arr.permute(rest + dims).reshape(
                [arr.shape[d] for d in rest] + [-1])
            out = tfn(moved, qq, dim=-1, interpolation=interpolation)
            if keepdim:
                shp = list(a.shape)
                for d in dims:
                    shp[d] = 1
                out = out.reshape(out.shape[:qq.dim()] + tuple(shp))
        else:
            out = tfn(arr, qq, dim=int(axis), keepdim=keepdim,
                      interpolation=interpolation)
        return out.to(a.dtype if a.is_floating_point() else torch.float32)
    return apply(fn, x)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim, interpolation)


def numel(x, name=None):
    return x.numel()
