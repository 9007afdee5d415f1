"""Backward (counterpart of `paddle_tpu/_core/engine.py`): thin calls to
`torch.autograd.backward` and `torch.autograd.grad` with the reference's
`retain_graph`, `create_graph` and accumulation semantics — `backward`
accumulates into leaves' `.grad` (and into intermediates that called
`retain_grads`), `grad` returns the gradients and leaves `.grad` alone."""
from __future__ import annotations

import torch

from .tensor import Tensor, unwrap


def _seed(t, g):
    if g is None:
        return torch.ones_like(t._value)
    return torch.as_tensor(unwrap(g), device=t._value.device).to(
        t._value.dtype)


def run_backward(tensors, grad_tensors, retain_graph=False):
    """Backward over several outputs at once; outputs that stop the
    gradient are skipped."""
    pairs = [(t, g) for t, g in zip(tensors, grad_tensors)
             if not t.stop_gradient]
    if not pairs:
        return
    torch.autograd.backward([t._value for t, _ in pairs],
                            [_seed(t, g) for t, g in pairs],
                            retain_graph=retain_graph)


def backward(tensor: Tensor, grad_tensor=None, retain_graph=False):
    if tensor.stop_gradient:
        raise RuntimeError(
            "Tensor has stop_gradient=True; nothing to backpropagate.")
    run_backward([tensor], [grad_tensor], retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of `outputs` with respect to `inputs`,
    as a list of Tensors. An input the outputs do not reach gets zeros,
    or None with `allow_unused`. The graph is kept unless
    `retain_graph=False`."""
    outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is None:
        gl = [None] * len(outs)
    else:
        gl = grad_outputs if isinstance(grad_outputs, (list, tuple)) \
            else [grad_outputs]
    pairs = [(o, g) for o, g in zip(outs, gl) if not o.stop_gradient]
    wanted = [i for i, t in enumerate(ins) if not t.stop_gradient]
    got = [None] * len(ins)
    if pairs and wanted:
        res = torch.autograd.grad(
            [o._value for o, _ in pairs], [ins[i]._value for i in wanted],
            [_seed(o, g) for o, g in pairs],
            retain_graph=True if retain_graph is None else retain_graph,
            create_graph=create_graph, allow_unused=True)
        for i, r in zip(wanted, res):
            got[i] = r
    result = []
    for t, r in zip(ins, got):
        if r is None:
            result.append(None if allow_unused else
                          Tensor(torch.zeros_like(t._value.detach())))
        else:
            result.append(Tensor(r if create_graph else r.detach()))
    return result
