"""Tensor: Paddle's imperative tensor over one torch.Tensor
(counterpart of `paddle_tpu/_core/tensor.py`).

Torch autograd is the tape. `apply(fn, *args)` runs `fn` on the raw
torch tensors and wraps what it returns; it records nothing of its own.
Paddle's surface stays: `shape` is a list, `stop_gradient` is the
inverse of `requires_grad`, `grad` is a Tensor or None, and `numpy`,
`item`, `astype` and `place` keep their meaning.

In-place ops are snapshot-consistent, as the reference's tape is: a
value mutated after an op consumed it does not change that op's
gradient. So `_replace`, `set_value`, `__setitem__`, `copy_`, `fill_`
and the `op_` variants rebind the wrapper to a new torch tensor built
out of place; they never write into a tensor autograd saved. Two cases
write in place instead, under no_grad: a leaf that requires grad (the
optimizer's update, or any in-place op under `no_grad`) and a
`Parameter`, which keeps one torch leaf for its life so that an
optimizer built before `set_state_dict` updates the loaded values. An
in-place op on a leaf that requires grad while grad is enabled raises,
as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtypes as _dt


class Place:
    def __init__(self, kind: str, idx: int = 0):
        self._kind, self._idx = kind, idx

    def __repr__(self):
        return f"Place({self._kind}:{self._idx})"

    def __eq__(self, other):
        return isinstance(other, Place) and \
            (self._kind, self._idx) == (other._kind, other._idx)

    def __hash__(self):
        return hash((self._kind, self._idx))

    def is_tpu_place(self):
        return False

    def is_cpu_place(self):
        return self._kind == "cpu"

    def is_gpu_place(self):
        return self._kind == "gpu"

    def gpu_device_id(self):
        return self._idx


class _HookRemoveHelper:
    """Returned by Tensor.register_hook: remove() deregisters once and
    says whether it did."""

    def __init__(self, handle):
        self._handle = handle

    def remove(self):
        if self._handle is None:
            return False
        self._handle.remove()
        self._handle = None
        return True


def as_torch(v):
    """A value (Tensor, torch tensor, numpy array — ml_dtypes bfloat16
    too — or list) as a detached torch tensor."""
    if isinstance(v, Tensor):
        return v._value.detach()
    if isinstance(v, torch.Tensor):
        return v.detach()
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _raw_like(v, like):
    """A value to assign into `like`: a torch tensor of its dtype on its
    device."""
    if isinstance(v, (Tensor, np.ndarray)):
        v = as_torch(v)
    return torch.as_tensor(v, device=like.device).to(like.dtype)


class Tensor:
    """A Paddle tensor: `_value` is the torch.Tensor it wraps."""

    __slots__ = ("_value", "name", "persistable", "dist_spec", "_grad_wrap",
                 "__weakref__")

    def __init__(self, value, stop_gradient=True, name=None):
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(value)
        self._value = value
        self.name = name
        self.persistable = False
        self.dist_spec = None
        self._grad_wrap = None
        if not stop_gradient:
            self.stop_gradient = False

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self):
        return self._value.dim()

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def size(self):
        return int(self._value.numel())

    @property
    def place(self):
        d = self._value.device
        if d.type == "cuda":
            return Place("gpu", d.index or 0)
        return Place("cpu", 0)

    @property
    def is_leaf(self):
        return self._value.grad_fn is None

    @property
    def stop_gradient(self):
        return not self._value.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, v):
        if v:
            if self._value.grad_fn is not None:
                self._value = self._value.detach()
            elif self._value.requires_grad:
                self._value.requires_grad_(False)
        elif not self._value.requires_grad and (
                self._value.is_floating_point() or self._value.is_complex()):
            self._value.requires_grad_(True)

    @property
    def requires_grad(self):
        return self._value.requires_grad

    @requires_grad.setter
    def requires_grad(self, v):
        self.stop_gradient = not v

    @property
    def grad(self):
        g = self._value.grad
        if g is None:
            self._grad_wrap = None
            return None
        if self._grad_wrap is None or self._grad_wrap._value is not g:
            self._grad_wrap = Tensor(g)
        return self._grad_wrap

    @grad.setter
    def grad(self, g):
        self._value.grad = None if g is None else _raw_like(g, self._value)
        self._grad_wrap = None

    @property
    def T(self):
        from ..tensor.linalg import t
        return t(self)

    @property
    def mT(self):
        return apply(lambda x: x.transpose(-1, -2), self)

    @property
    def real(self):
        return apply(torch.real, self)

    @property
    def imag(self):
        return apply(torch.imag, self)

    def numel(self):
        return Tensor(torch.tensor(self.size, dtype=torch.int64,
                                   device=self._value.device))

    def dim(self):
        return self.ndim

    def rank(self):
        return self.ndim

    def element_size(self):
        return self._value.element_size()

    # -- conversion ---------------------------------------------------------
    def numpy(self):
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            try:
                import ml_dtypes
                return v.cpu().view(torch.int16).numpy().view(
                    ml_dtypes.bfloat16)
            except ImportError:
                v = v.float()
        return v.cpu().numpy()

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._value.detach().item()

    def tolist(self):
        return self._value.tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def astype(self, dtype):
        d = _dt.convert_dtype(dtype)
        return apply(lambda x: x.to(d), self)

    cast = astype

    def cpu(self):
        return Tensor(self._value.detach().cpu(), self.stop_gradient)

    def cuda(self, device_id=None, blocking=True):
        dev = torch.device("cuda", 0 if device_id is None else device_id)
        return apply(lambda x: x.to(dev), self)

    def to(self, *args, **kwargs):
        out = self
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, str) and a.split(":")[0] in ("cpu", "gpu",
                                                          "cuda"):
                dev = torch.device("cpu") if a == "cpu" else \
                    torch.device("cuda", int(a.split(":")[1])
                                 if ":" in a else 0)
                out = apply(lambda x: x.to(dev), out)
                continue
            if isinstance(a, Place):
                dev = torch.device("cpu") if a.is_cpu_place() else \
                    torch.device("cuda", a.gpu_device_id())
                out = apply(lambda x: x.to(dev), out)
                continue
            try:
                d = _dt.convert_dtype(a)
            except TypeError:
                continue
            if d is not None:
                out = out.astype(d)
        return out

    def clone(self):
        return apply(torch.clone, self)

    def detach(self):
        return Tensor(self._value.detach(), name=self.name)

    def detach_(self):
        self._value = self._value.detach()
        return self

    def pin_memory(self):
        return self

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True

    def value(self):
        return self

    def apply(self, func):
        """func(self), refused for a tensor that requires grad: apply is
        a data-editing escape hatch, not a differentiable op."""
        if not self.stop_gradient:
            raise RuntimeError(
                "Cannot apply function on a tensor that requires grad; "
                "detach() first or use normal ops for a differentiable "
                "path.")
        return func(self)

    def apply_(self, func):
        out = self.apply(func)
        self._replace(_raw_like(out, self._value))
        return self

    def to_dense(self):
        return self

    def __dlpack__(self, stream=None):
        return self._value.detach().__dlpack__()

    def __dlpack_device__(self):
        return self._value.__dlpack_device__()

    # -- autograd -----------------------------------------------------------
    def retain_grads(self):
        if self._value.grad_fn is not None:
            self._value.retain_grad()

    def gradient(self):
        """The gradient as a numpy array (None when there is none)."""
        return None if self.grad is None else self.grad.numpy()

    def register_hook(self, hook):
        """Backward hook, called with this tensor's gradient of the pass
        (a leaf's before it accumulates into .grad); a returned tensor
        replaces it. Returns a helper whose remove() deregisters."""
        if self.stop_gradient:
            raise RuntimeError(
                "Cannot register hook on a tensor with stop_gradient=True")

        def raw_hook(g):
            r = hook(Tensor(g))
            return None if r is None else _raw_like(r, g)
        return _HookRemoveHelper(self._value.register_hook(raw_hook))

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    def backward(self, grad_tensor=None, retain_graph=False):
        from .engine import backward as _backward
        _backward(self, grad_tensor, retain_graph)

    # -- mutation -----------------------------------------------------------
    def _writes_in_place(self):
        v = self._value
        return isinstance(self, Parameter) or (v.requires_grad and
                                               v.grad_fn is None)

    def _replace(self, new_value):
        """Make this tensor hold `new_value` (a torch tensor). A leaf that
        requires grad and a Parameter are written in place under no_grad
        (raising while grad is enabled for a leaf that requires grad);
        anything else is rebound."""
        v = self._value
        if self._writes_in_place():
            if v.requires_grad and torch.is_grad_enabled():
                raise RuntimeError(
                    "a leaf Tensor that requires grad is being used in an "
                    "inplace operation")
            with torch.no_grad():
                new_value = new_value.detach()
                if new_value.shape == v.shape and \
                        new_value.dtype == v.dtype:
                    v.copy_(new_value)
                else:
                    v.data = new_value.to(v.device)
            self._grad_wrap = None
        else:
            self._value = new_value

    def set_value(self, value):
        self._replace(_raw_like(value, self._value))
        return self

    def copy_(self, other, *args):
        return self.set_value(other)

    def fill_(self, v):
        self._replace(torch.full_like(self._value.detach(), v))
        return self

    def zero_(self):
        return self.fill_(0)

    # -- indexing -----------------------------------------------------------
    def _convert_index(self, idx):
        def conv(i):
            if isinstance(i, Tensor):
                return i._value
            if isinstance(i, (list, np.ndarray)):
                return torch.as_tensor(np.asarray(i),
                                       device=self._value.device)
            return i
        if isinstance(idx, tuple):
            return tuple(conv(i) for i in idx)
        return conv(idx)

    def __getitem__(self, idx):
        idx = self._convert_index(idx)
        return apply(lambda x: x[idx], self)

    def __setitem__(self, idx, value):
        idx = self._convert_index(idx)

        def fn(x, v):
            y = x.clone()
            y[idx] = torch.as_tensor(v, device=x.device).to(x.dtype)
            return y
        if self._writes_in_place() and not torch.is_grad_enabled():
            with torch.no_grad():
                self._value[idx] = _raw_like(value, self._value)
            return
        out = apply(fn, self, value)
        self._value = out._value

    def __iter__(self):
        for i in range(self.shape[0] if self.ndim else 0):
            yield self[i]

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self.shape[0]

    # -- python scalar protocol ---------------------------------------------
    def __bool__(self):
        return bool(self._value)

    def __int__(self):
        return int(self._value.detach())

    def __float__(self):
        return float(self._value.detach())

    def __index__(self):
        return int(self._value)

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype="
                f"{_dt.dtype_name(self.dtype)}, place={self.place}, "
                f"stop_gradient={self.stop_gradient},\n"
                f"{self._value.detach().cpu()})")

    __str__ = __repr__

    # Arithmetic operators and the op methods are attached by
    # paddle_tpu_torch.tensor (the reference's monkey-patch pattern).


def unwrap(x):
    return x._value if isinstance(x, Tensor) else x


def wrap(value, stop_gradient=True, name=None):
    return Tensor(value, stop_gradient=stop_gradient, name=name)


def apply(fn, *args, name=None, multi=False, **kwargs):
    """Run `fn` over the raw torch tensors of `args` (other arguments
    pass through) and wrap what it returns; torch autograd records the
    graph. A tuple or list result (or `multi`) comes back as a tuple or
    list of Tensors."""
    raw = tuple(unwrap(a) for a in args)
    out = fn(*raw, **kwargs)
    if multi or isinstance(out, (tuple, list)):
        outs = tuple(o if o is None else Tensor(o) for o in out)
        return list(outs) if isinstance(out, list) else outs
    return Tensor(out)


class Parameter(Tensor):
    """A trainable leaf: stop_gradient defaults to False. It keeps one
    torch leaf for its life (see `Tensor._replace`)."""

    __slots__ = ("trainable", "optimize_attr", "regularizer", "need_clip",
                 "is_distributed")

    def __init__(self, value, name=None, trainable=True):
        value = unwrap(value)
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(value)
        super().__init__(value.detach(), stop_gradient=not trainable,
                         name=name)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False
        self.persistable = True

    def __repr__(self):
        return "Parameter " + super().__repr__()
