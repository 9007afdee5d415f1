"""Shape and layout ops (counterpart of `paddle_tpu/tensor/manipulation.py`),
each a torch function under Paddle's signature."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from .._core import dtypes as _dt
from .._core.tensor import Tensor, apply, unwrap

__all__ = [
    "reshape", "reshape_", "flatten", "squeeze", "unsqueeze", "concat",
    "stack", "split", "tensor_split", "vsplit", "hsplit", "dsplit", "chunk",
    "tile", "expand", "expand_as", "broadcast_to", "broadcast_tensors",
    "gather", "gather_nd", "scatter", "scatter_", "scatter_nd",
    "scatter_nd_add", "index_select", "index_sample", "index_add",
    "index_put", "index_fill", "masked_select", "masked_fill",
    "masked_scatter", "roll", "flip", "rot90", "take_along_axis",
    "put_along_axis", "repeat_interleave", "unbind", "unstack", "slice",
    "strided_slice", "crop", "moveaxis", "swapaxes", "tensordot",
    "as_complex", "as_real", "view", "view_as", "unfold", "fliplr", "flipud",
    "take", "select_scatter", "unflatten", "atleast_1d", "atleast_2d",
    "atleast_3d", "rad2deg", "block_diag", "hstack", "vstack", "dstack",
    "column_stack", "row_stack", "as_strided", "shard_index",
    "slice_scatter", "where", "bucketize", "searchsorted", "top_p_sampling",
]

_slice = builtins.slice


def _resolve_shape(shape):
    if isinstance(shape, Tensor):
        return [int(v) for v in shape.tolist()]
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(unwrap(s)) for s in shape]


def _idx(i):
    return i.long() if isinstance(i, torch.Tensor) else i


def reshape(x, shape, name=None):
    sh = _resolve_shape(shape)

    def fn(a):
        # paddle semantics: 0 copies the input's dim
        return a.reshape([a.shape[i] if (s == 0 and i < a.dim()) else s
                          for i, s in enumerate(sh)])
    return apply(fn, x)


def reshape_(x, shape, name=None):
    out = reshape(x, shape)
    x._replace(out._value)
    return x


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    d = _dt.convert_dtype(shape_or_dtype)
    return apply(lambda a: a.view(d), x)


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def fn(a):
        if a.dim() == 0:
            return a.reshape(1)
        return torch.flatten(a, start_axis, stop_axis)
    return apply(fn, x)


def squeeze(x, axis=None, name=None):
    def fn(a):
        if axis is None:
            return torch.squeeze(a)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = tuple(int(ax) % a.dim() for ax in axes
                     if a.shape[int(ax) % a.dim()] == 1)
        return torch.squeeze(a, axes) if axes else a
    return apply(fn, x)


def unsqueeze(x, axis, name=None):
    def fn(a):
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = [int(unwrap(v)) for v in axes]
        n = a.dim() + len(axes)
        out = a
        for ax in sorted(ax % n if ax >= 0 else ax + n for ax in axes):
            out = out.unsqueeze(ax)
        return out
    return apply(fn, x)


def concat(x, axis=0, name=None):
    ax = int(unwrap(axis))
    return apply(lambda *xs: torch.cat(xs, ax), *x)


def stack(x, axis=0, name=None):
    return apply(lambda *xs: torch.stack(xs, int(axis)), *x)


def hstack(x, name=None):
    return apply(lambda *xs: torch.hstack(xs), *x)


def vstack(x, name=None):
    return apply(lambda *xs: torch.vstack(xs), *x)


def dstack(x, name=None):
    return apply(lambda *xs: torch.dstack(xs), *x)


def column_stack(x, name=None):
    return apply(lambda *xs: torch.column_stack(xs), *x)


row_stack = vstack


def block_diag(inputs, name=None):
    return apply(lambda *xs: torch.block_diag(*xs), *inputs)


def split(x, num_or_sections, axis=0, name=None):
    ax = int(unwrap(axis))

    def fn(a):
        if isinstance(num_or_sections, int):
            if a.shape[ax] % num_or_sections:
                raise ValueError(
                    f"split: axis {ax} of size {a.shape[ax]} does not divide "
                    f"into {num_or_sections}")
            return tuple(torch.split(a, a.shape[ax] // num_or_sections, ax))
        secs = [int(unwrap(s)) for s in num_or_sections]
        known = builtins.sum(s for s in secs if s != -1)
        secs = [s if s != -1 else a.shape[ax] - known for s in secs]
        return tuple(torch.split(a, secs, ax))
    return list(apply(fn, x, multi=True))


def tensor_split(x, num_or_indices, axis=0, name=None):
    def fn(a):
        arg = num_or_indices if isinstance(num_or_indices, int) else \
            [int(i) for i in num_or_indices]
        return tuple(torch.tensor_split(a, arg, int(axis)))
    return list(apply(fn, x, multi=True))


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=1)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def chunk(x, chunks, axis=0, name=None):
    # numpy's array_split: the first (n % chunks) pieces one larger
    return tensor_split(x, int(chunks), axis)


def tile(x, repeat_times, name=None):
    reps = tuple(int(unwrap(r)) for r in repeat_times) \
        if isinstance(repeat_times, (list, tuple)) else \
        (int(unwrap(repeat_times)),)
    return apply(lambda a: torch.tile(a, reps), x)


def expand(x, shape, name=None):
    sh = _resolve_shape(shape)
    return apply(lambda a: a.expand(sh), x)


def expand_as(x, y, name=None):
    return apply(lambda a, b: a.expand(b.shape), x, y)


def broadcast_to(x, shape, name=None):
    sh = _resolve_shape(shape)
    return apply(lambda a: torch.broadcast_to(a, sh), x)


def broadcast_tensors(inputs, name=None):
    return list(apply(lambda *xs: tuple(torch.broadcast_tensors(*xs)),
                      *inputs, multi=True))


def gather(x, index, axis=0, name=None):
    ax = int(unwrap(axis))
    return apply(lambda a, i: torch.index_select(a, ax, i.reshape(-1).long()),
                 x, index)


def gather_nd(x, index, name=None):
    def fn(a, idx):
        idx = idx.long()
        if idx.shape[-1] == 0:
            return a.expand(tuple(idx.shape[:-1]) + tuple(a.shape))
        return a[tuple(idx[..., i] for i in range(idx.shape[-1]))]
    return apply(fn, x, index)


def scatter(x, index, updates, overwrite=True, name=None):
    def fn(a, idx, upd):
        idx = idx.reshape(-1).long()
        if overwrite:
            return a.index_put((idx,), upd)
        zeroed = a.index_put((idx,), torch.zeros_like(upd))
        return zeroed.index_put((idx,), upd, accumulate=True)
    return apply(fn, x, index, updates)


def scatter_(x, index, updates, overwrite=True, name=None):
    out = scatter(x, index, updates, overwrite)
    x._replace(out._value)
    return x


def scatter_nd(index, updates, shape, name=None):
    sh = _resolve_shape(shape)

    def fn(idx, upd):
        out = torch.zeros(sh, dtype=upd.dtype, device=upd.device)
        idx = idx.long()
        return out.index_put(tuple(idx[..., i] for i in range(idx.shape[-1])),
                             upd, accumulate=True)
    return apply(fn, index, updates)


def scatter_nd_add(x, index, updates, name=None):
    def fn(a, idx, upd):
        idx = idx.long()
        return a.index_put(tuple(idx[..., i] for i in range(idx.shape[-1])),
                           upd, accumulate=True)
    return apply(fn, x, index, updates)


def index_select(x, index, axis=0, name=None):
    return apply(lambda a, i: torch.index_select(a, int(axis),
                                                 i.reshape(-1).long()),
                 x, index)


def index_sample(x, index, name=None):
    return apply(lambda a, i: torch.gather(a, 1, i.long()), x, index)


def index_add(x, index, axis, value, name=None):
    return apply(lambda a, i, v: torch.index_add(a, int(axis), i.long(), v),
                 x, index, value)


def index_fill(x, index, axis, value, name=None):
    def fn(a, i, v):
        moved = a.movedim(int(axis), 0)
        v = torch.as_tensor(v, device=a.device).to(a.dtype)
        out = moved.index_put((i.long(),), v.expand(moved[0].shape)
                              if v.dim() == 0 else v)
        return out.movedim(0, int(axis))
    return apply(fn, x, index, value)


def index_put(x, indices, value, accumulate=False, name=None):
    idxs = tuple(_idx(unwrap(i)) for i in indices)
    return apply(lambda a, v: a.index_put(idxs, torch.as_tensor(
        v, device=a.device).to(a.dtype), accumulate=accumulate), x, value)


def masked_select(x, mask, name=None):
    return apply(lambda a, m: torch.masked_select(a, m.bool()), x, mask)


def masked_fill(x, mask, value, name=None):
    v = unwrap(value)
    return apply(lambda a, m: torch.where(m.bool(), torch.as_tensor(
        v, device=a.device).to(a.dtype), a), x, mask)


def masked_scatter(x, mask, value, name=None):
    return apply(lambda a, m, v: torch.masked_scatter(
        a, m.bool().expand(a.shape), v.to(a.dtype)), x, mask, value)


def roll(x, shifts, axis=None, name=None):
    sh = tuple(shifts) if isinstance(shifts, (list, tuple)) else \
        int(unwrap(shifts))
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis

    def fn(a):
        if ax is None:
            return torch.roll(a.reshape(-1), sh).reshape(a.shape)
        return torch.roll(a, sh, ax)
    return apply(fn, x)


def flip(x, axis, name=None):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),)
    return apply(lambda a: torch.flip(a, ax), x)


def fliplr(x, name=None):
    return apply(torch.fliplr, x)


def flipud(x, name=None):
    return apply(torch.flipud, x)


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply(lambda a: torch.rot90(a, int(k), tuple(axes)), x)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    def fn(a, idx):
        idx = idx.long()
        if broadcast:
            tgt = list(a.shape)
            tgt[axis] = idx.shape[axis]
            idx = idx.expand(tgt)
        return torch.gather(a, int(axis), idx)
    return apply(fn, arr, indices)


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    def fn(a, idx, v):
        idx = idx.long()
        v = torch.as_tensor(v, device=a.device).to(a.dtype).expand(idx.shape)
        ax = int(axis)
        if reduce == "assign":
            return torch.scatter(a, ax, idx, v)
        red = {"add": "sum", "sum": "sum", "mul": "prod", "multiply": "prod",
               "amax": "amax", "amin": "amin", "mean": "mean"}[reduce]
        return torch.scatter_reduce(a, ax, idx, v, red,
                                    include_self=include_self)
    return apply(fn, arr, indices, values)


def select_scatter(x, values, axis, index, name=None):
    return apply(lambda a, v: torch.select_scatter(a, v.to(a.dtype),
                                                   int(axis), int(index)),
                 x, values)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    def fn(a, v):
        sl = [_slice(None)] * a.dim()
        for ax, s, e, st in zip(axes, starts, ends, strides):
            sl[ax] = _slice(int(s), int(e), int(st))
        out = a.clone()
        out[tuple(sl)] = v.to(a.dtype)
        return out
    return apply(fn, x, value)


def repeat_interleave(x, repeats, axis=None, name=None):
    return apply(lambda a, r: torch.repeat_interleave(
        a, r if isinstance(r, torch.Tensor) else int(r), axis), x, repeats)


def unbind(input, axis=0, name=None):
    return list(apply(lambda a: tuple(torch.unbind(a, int(axis))), input,
                      multi=True))


unstack = unbind


def slice(input, axes, starts, ends, name=None):
    def fn(a):
        sl = [_slice(None)] * a.dim()
        for ax, s, e in zip(axes, starts, ends):
            sl[int(ax)] = _slice(int(unwrap(s)), int(unwrap(e)))
        return a[tuple(sl)]
    return apply(fn, input)


def strided_slice(x, axes, starts, ends, strides, name=None):
    def fn(a):
        sl = [_slice(None)] * a.dim()
        for ax, s, e, st in zip(axes, starts, ends, strides):
            if int(st) < 0:     # torch slices step forward only
                idx = torch.arange(a.shape[int(ax)], device=a.device)[
                    _slice(int(s), int(e), int(st))]
                a = torch.index_select(a, int(ax), idx)
            else:
                sl[int(ax)] = _slice(int(s), int(e), int(st))
        return a[tuple(sl)]
    return apply(fn, x)


def crop(x, shape=None, offsets=None, name=None):
    sh = _resolve_shape(shape)
    offs = [int(unwrap(o)) for o in offsets] if offsets is not None \
        else [0] * len(sh)

    def fn(a):
        return a[tuple(_slice(o, o + (s if s != -1 else a.shape[i] - o))
                       for i, (o, s) in enumerate(zip(offs, sh)))]
    return apply(fn, x)


def as_strided(x, shape, stride, offset=0, name=None):
    return apply(lambda a: torch.as_strided(a.contiguous(), tuple(shape),
                                            tuple(stride), offset), x)


def moveaxis(x, source, destination, name=None):
    return apply(lambda a: torch.movedim(a, source, destination), x)


def swapaxes(x, axis0, axis1, name=None):
    return apply(lambda a: torch.swapaxes(a, int(axis0), int(axis1)), x)


def tensordot(x, y, axes=2, name=None):
    ax = axes
    if isinstance(ax, (list, tuple)):
        ax = [[int(v) for v in (a if isinstance(a, (list, tuple)) else [a])]
              for a in ax]
    return apply(lambda a, b: torch.tensordot(a, b, ax), x, y)


def as_complex(x, name=None):
    return apply(lambda a: torch.complex(a[..., 0], a[..., 1]), x)


def as_real(x, name=None):
    return apply(lambda a: torch.stack([a.real, a.imag], -1), x)


def take(x, index, mode="raise", name=None):
    def fn(a, idx):
        flat = a.reshape(-1)
        idx = idx.long()
        n = flat.shape[0]
        if mode == "wrap":
            idx = torch.remainder(idx, n)
        elif mode == "clip":
            idx = torch.clamp(idx, 0, n - 1)
        else:
            idx = torch.where(idx < 0, idx + n, idx)
        return flat[idx]
    return apply(fn, x, index)


def unflatten(x, axis, shape, name=None):
    return apply(lambda a: torch.unflatten(a, int(axis),
                                           _resolve_shape(shape)), x)


def unfold(x, axis, size, step, name=None):
    return apply(lambda a: a.unfold(int(axis), int(size), int(step)), x)


def atleast_1d(*inputs, name=None):
    outs = [apply(torch.atleast_1d, x) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [apply(torch.atleast_2d, x) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = [apply(torch.atleast_3d, x) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def rad2deg(x, name=None):
    return apply(lambda a: torch.rad2deg(
        a if a.is_floating_point() else a.double()), x)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def fn(idx):
        size = index_num // nshards
        lo = shard_id * size
        ok = (idx >= lo) & (idx < lo + size)
        return torch.where(ok, idx - lo, torch.full_like(idx, ignore_value))
    return apply(fn, input)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        nz = torch.nonzero(unwrap(condition))
        if nz.shape[1] > 1:
            return tuple(Tensor(nz[:, i:i + 1]) for i in range(nz.shape[1]))
        return Tensor(nz)

    def fn(c, a, b):
        a = torch.as_tensor(a, device=c.device)
        b = torch.as_tensor(b, device=c.device)
        d = torch.promote_types(a.dtype, b.dtype)
        return torch.where(c.bool(), a.to(d), b.to(d))
    return apply(fn, condition, x, y)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return apply(lambda a, s: torch.bucketize(a, s, out_int32=out_int32,
                                              right=right),
                 x, sorted_sequence)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return apply(lambda s, v: torch.searchsorted(s, v, out_int32=out_int32,
                                                 right=right),
                 sorted_sequence, values)


def top_p_sampling(x, ps, threshold=None, seed=None, name=None):
    """Nucleus sampling: per row, the smallest set of tokens whose
    probability reaches p, renormalised, one token drawn (Gumbel over the
    port's key stream)."""
    from .. import _prng
    from .._core.state import prng
    key = prng.next_key() if seed is None else _prng.key(int(seed))

    def fn(logits, p):
        probs = torch.softmax(logits, -1)
        sorted_probs, sorted_idx = torch.sort(probs, dim=-1,
                                              descending=True, stable=True)
        cum = torch.cumsum(sorted_probs, -1)
        keep = cum - sorted_probs <= p[..., None]
        filtered = torch.where(keep, sorted_probs,
                               torch.zeros_like(sorted_probs))
        filtered = filtered / filtered.sum(-1, keepdim=True)
        n = filtered.shape[-1]
        rows = filtered.reshape(-1, n)
        g = -torch.log(-torch.log(_prng.uniform_real(
            key, rows.shape, torch.float32, torch.finfo(torch.float32).tiny,
            1.0, device=rows.device)))
        choice = torch.argmax(torch.log(rows.float() + 1e-10) + g, -1)
        choice = choice.reshape(filtered.shape[:-1] + (1,))
        return (torch.gather(filtered, -1, choice),
                torch.gather(sorted_idx, -1, choice))
    return apply(fn, x, ps, multi=True)
