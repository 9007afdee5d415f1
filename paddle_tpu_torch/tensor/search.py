"""Search and sort ops (counterpart of `paddle_tpu/tensor/search.py`)."""
from __future__ import annotations

import torch

from .._core import dtypes as _dt
from .._core.tensor import Tensor, apply, unwrap

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "unique",
    "unique_consecutive", "nonzero", "kthvalue", "mode", "masked_select",
    "index_sample", "where",
]


def _arg(tfn, x, axis, keepdim, dtype):
    d = _dt.convert_dtype(dtype)

    def fn(a):
        if axis is None:
            return tfn(a.reshape(-1)).to(d)
        return tfn(a, int(axis), keepdim=keepdim).to(d)
    return apply(fn, x)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return apply(lambda a: torch.sort(a, dim=int(axis),
                                      descending=descending, stable=True).indices, x)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return apply(lambda a: torch.sort(a, dim=int(axis),
                                      descending=descending, stable=True).values, x)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    kk = int(unwrap(k))
    ax = -1 if axis is None else int(axis)
    return apply(lambda a: tuple(torch.topk(a, kk, ax, largest, True)), x,
                 multi=True)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def fn(a):
        ax = int(axis) % a.dim()
        sv, si = torch.sort(a, dim=ax, stable=True)
        v, i = sv.select(ax, int(k) - 1), si.select(ax, int(k) - 1)
        if keepdim:
            v, i = v.unsqueeze(ax), i.unsqueeze(ax)
        return v, i
    return apply(fn, x, multi=True)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along `axis` (the smallest on ties) and
    the last index it occurs at."""
    def fn(a):
        ax = int(axis) % a.dim()
        moved = a.movedim(ax, -1)
        n = moved.shape[-1]
        sv = torch.sort(moved, dim=-1).values
        counts = (sv[..., :, None] == sv[..., None, :]).sum(-1)
        best = torch.argmax(counts, -1, keepdim=True)
        mv = torch.gather(sv, -1, best)[..., 0]
        pos = torch.arange(1, n + 1, device=a.device)
        idx = torch.argmax((moved == mv[..., None]) * pos, -1)
        if keepdim:
            return mv.unsqueeze(ax), idx.unsqueeze(ax)
        return mv, idx
    return apply(fn, x, multi=True)


def nonzero(x, as_tuple=False, name=None):
    nz = torch.nonzero(unwrap(x))
    if as_tuple:
        return tuple(Tensor(nz[:, i]) for i in range(nz.shape[1]))
    return Tensor(nz)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    a = unwrap(x)
    d = _dt.convert_dtype(dtype)
    vals, inv, counts = torch.unique(a, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    if not (return_index or return_inverse or return_counts):
        return Tensor(vals)
    outs = [Tensor(vals)]
    if return_index:
        flat_inv = inv.reshape(-1)
        n = flat_inv.shape[0]
        first = torch.full((vals.shape[0] if axis is not None else
                            vals.numel(),), n, dtype=torch.int64,
                           device=a.device)
        first = first.scatter_reduce(0, flat_inv, torch.arange(
            n, device=a.device), "amin")
        outs.append(Tensor(first.to(d)))
    if return_inverse:
        outs.append(Tensor(inv.to(d)))
    if return_counts:
        outs.append(Tensor(counts.to(d)))
    return tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    a = unwrap(x)
    d = _dt.convert_dtype(dtype)
    if axis is None:
        a = a.reshape(-1)
    out, inv, counts = torch.unique_consecutive(
        a, return_inverse=True, return_counts=True, dim=axis)
    outs = [Tensor(out)]
    if return_inverse:
        outs.append(Tensor(inv.to(d)))
    if return_counts:
        outs.append(Tensor(counts.to(d)))
    return outs[0] if len(outs) == 1 else tuple(outs)


# re-exported from manipulation for paddle namespace parity
from .manipulation import masked_select, where  # noqa: E402,F401
from .manipulation import index_sample  # noqa: E402,F401
