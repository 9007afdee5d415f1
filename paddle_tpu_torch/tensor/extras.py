"""In-place machinery (counterpart of the in-place part of
`paddle_tpu/tensor/extras.py`)."""
from __future__ import annotations

import torch

from .._core.tensor import Tensor, unwrap


def inplace_apply(x, base_fn, *args, **kwargs):
    """Run the functional op and make x hold its result. A leaf that
    requires grad refuses while grad is enabled (paddle: 'leaf Variable
    that requires grad is using inplace'); `Tensor._replace` keeps the
    op snapshot-consistent."""
    if isinstance(x, Tensor) and not x.stop_gradient and x.is_leaf and \
            torch.is_grad_enabled():
        raise RuntimeError(
            f"a leaf Tensor that requires grad is being used in an "
            f"inplace operation ({getattr(base_fn, '__name__', 'op')}_)")
    out = base_fn(x, *args, **kwargs)
    x._replace(unwrap(out) if isinstance(out, Tensor) else
               torch.as_tensor(out, device=x._value.device))
    return x


def make_inplace(base_fn, name):
    def fn(x, *args, **kwargs):
        return inplace_apply(x, base_fn, *args, **kwargs)
    fn.__name__ = name
    fn.__qualname__ = name
    fn.__doc__ = f"Inplace variant of `{base_fn.__name__}` (paddle `{name}`)."
    return fn

