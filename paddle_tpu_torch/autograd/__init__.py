"""Autograd public API (counterpart of `paddle_tpu/autograd/__init__.py`).

`no_grad`, `enable_grad` and `set_grad_enabled` are torch's grad mode;
`backward` and `grad` are the engine's thin calls into torch autograd.
`PyLayer` runs on `torch.autograd.Function`: a user's forward and
backward see and return Tensors, the Function carries raw tensors.
"""
from __future__ import annotations

import functools

import torch

from .._core.engine import grad, run_backward
from .._core.tensor import Tensor, unwrap


class no_grad:
    """Context manager and decorator, as paddle.no_grad."""

    def __enter__(self):
        self._ctx = torch.no_grad()
        return self._ctx.__enter__()

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with torch.no_grad():
                return fn(*a, **k)
        return wrapper


class enable_grad:
    def __enter__(self):
        self._ctx = torch.enable_grad()
        return self._ctx.__enter__()

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with torch.enable_grad():
                return fn(*a, **k)
        return wrapper


class set_grad_enabled:
    """Context manager: grad mode `mode` inside, the previous mode
    after (as the reference's, it sets nothing until entered)."""

    def __init__(self, mode):
        self.mode = bool(mode)

    def __enter__(self):
        self.prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self.mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self.prev)
        return False


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward over a list of tensors."""
    ts = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    gs = grad_tensors if isinstance(grad_tensors, (list, tuple)) else \
        [grad_tensors] * len(ts)
    run_backward(list(ts), list(gs), retain_graph)


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


def _function_for(cls):
    """The torch.autograd.Function behind a PyLayer subclass (made once
    per class)."""
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    def forward(ctx, spec, kwargs, *raws):
        pctx = PyLayerContext()
        it = iter(raws)
        args = [Tensor(next(it)) if is_t else a for is_t, a in spec]
        with torch.no_grad():
            out = cls.forward(pctx, *args, **kwargs)
        ctx.pctx = pctx
        ctx.n_in = len(raws)
        ctx.multi = isinstance(out, (tuple, list))
        outs = tuple(unwrap(o) for o in out) if ctx.multi else unwrap(out)
        return outs

    def backward(ctx, *cts):
        with torch.no_grad():
            gin = cls.backward(ctx.pctx, *[Tensor(c) for c in cts])
        if not isinstance(gin, (tuple, list)):
            gin = (gin,)
        gin = tuple(None if g is None else unwrap(g) for g in gin)
        gin = gin + (None,) * (ctx.n_in - len(gin))
        return (None, None) + gin[:ctx.n_in]

    fn = type(cls.__name__ + "Function", (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward)})
    cls._torch_function = fn
    return fn


class PyLayer:
    """Custom forward/backward: subclass with @staticmethod
    forward(ctx, *args) and backward(ctx, *grads); backward returns one
    gradient per Tensor argument."""

    @classmethod
    def apply(cls, *args, **kwargs):
        spec = tuple((isinstance(a, Tensor), None if isinstance(a, Tensor)
                      else a) for a in args)
        raws = [a._value for a in args if isinstance(a, Tensor)]
        out = _function_for(cls).apply(spec, kwargs, *raws)
        if isinstance(out, tuple):
            return tuple(Tensor(o) for o in out)
        return Tensor(out)


def jacobian(ys, xs, batch_axis=None):
    """paddle.autograd.jacobian (dense), one backward per output
    element."""
    ys_list = ys if isinstance(ys, (list, tuple)) else [ys]
    xs_list = xs if isinstance(xs, (list, tuple)) else [xs]
    rows = []
    for y in ys_list:
        n = y.size
        for i in range(n):
            seed = torch.zeros(n, dtype=y.dtype, device=y._value.device)
            seed[i] = 1.0
            gs = grad([y], xs_list, grad_outputs=[Tensor(seed.reshape(
                y._value.shape))], retain_graph=True)
            rows.append([g._value.reshape(-1) for g in gs])
    out = [Tensor(torch.stack([r[j] for r in rows]))
           for j in range(len(xs_list))]
    return out[0] if len(out) == 1 else out


class saved_tensors_hooks:
    """Pack/unpack hooks over the raw tensors autograd saves for
    backward (torch.autograd.graph.saved_tensors_hooks)."""

    def __init__(self, pack_hook, unpack_hook):
        self._ctx = torch.autograd.graph.saved_tensors_hooks(pack_hook,
                                                             unpack_hook)

    def __enter__(self):
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        return False


__all__ = ["no_grad", "enable_grad", "backward", "grad", "PyLayer",
           "PyLayerContext", "jacobian", "set_grad_enabled",
           "saved_tensors_hooks"]
