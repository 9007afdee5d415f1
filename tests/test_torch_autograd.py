"""The port's eager autograd (Tensor on torch autograd, paddle.grad,
no_grad, PyLayer, in-place ops, hooks) held to the JAX package's tape:
every scenario of tests/test_autograd.py runs through both packages on
the same numpy inputs, and their gradients agree within 1e-6 (fp32) or
1e-12 (fp64)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch._core import state as tstate

ATOL = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.fixture(autouse=True)
def _cpu():
    prev = tstate._device
    tstate.set_device("cpu")
    yield
    tstate._device = prev


def _arr(seed, shape, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _np(t):
    return None if t is None else np.asarray(t.numpy())


# every scenario takes the package and returns {name: array or value}
def simple_chain(pt):
    a = pt.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    (a * a + 2 * a).sum().backward()
    return {"grad": _np(a.grad)}


def matmul_grad(pt):
    ta = pt.to_tensor(_arr(0, (3, 4), np.float64), stop_gradient=False)
    tb = pt.to_tensor(_arr(1, (4, 2), np.float64), stop_gradient=False)
    pt.matmul(ta, tb).sum().backward()
    return {"ga": _np(ta.grad), "gb": _np(tb.grad)}


def broadcast_grad(pt):
    a = pt.to_tensor(_arr(2, (3, 1), np.float64), stop_gradient=False)
    b = pt.to_tensor(_arr(3, (1, 4), np.float64), stop_gradient=False)
    (a * b).sum().backward()
    return {"ga": _np(a.grad), "gb": _np(b.grad), "shape": a.grad.shape}


def grad_accumulation(pt):
    a = pt.to_tensor([1.0, 1.0], stop_gradient=False)
    (a * 2).sum().backward()
    (a * 3).sum().backward()
    g = _np(a.grad)
    a.clear_grad()
    return {"grad": g, "cleared": a.grad is None}


def stop_gradient_blocks(pt):
    a = pt.to_tensor([1.0], stop_gradient=False)
    b = a * 2
    c = b.detach() * 3 + a
    c.sum().backward()
    return {"grad": _np(a.grad)}


def composite(pt):
    t = pt.to_tensor(_arr(4, (5,), np.float64), stop_gradient=False)
    (pt.tanh(t) * pt.exp(-t * t) + t ** 3).sum().backward()
    return {"grad": _np(t.grad)}


def multi_output_op(pt):
    x = pt.to_tensor(_arr(5, (6,), np.float64), stop_gradient=False)
    v, i = pt.topk(x, 3)
    v.sum().backward()
    return {"grad": _np(x.grad), "idx": _np(i)}


def getitem_grad(pt):
    x = pt.to_tensor(np.ones((3, 3), np.float32), stop_gradient=False)
    x[1].sum().backward()
    return {"grad": _np(x.grad)}


def retain_grads_intermediate(pt):
    a = pt.to_tensor([2.0], stop_gradient=False)
    b = a * 3
    b.retain_grads()
    (b * b).sum().backward()
    return {"gb": _np(b.grad), "ga": _np(a.grad)}


def paddle_grad(pt):
    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    (gx,) = pt.grad((x * x).sum(), x)
    return {"gx": _np(gx), "x_grad_none": x.grad is None}


def no_grad_ctx(pt):
    x = pt.to_tensor([1.0], stop_gradient=False)
    with pt.no_grad():
        y = x * 2

    @pt.no_grad()
    def helper(t):
        return t * 2
    return {"ctx": y.stop_gradient, "decorated": helper(x).stop_gradient}


def pylayer(pt):
    class Double(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 2

        @staticmethod
        def backward(ctx, gy):
            return gy * 10  # deliberately nonstandard

    x = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    y = Double.apply(x)
    y.sum().backward()
    return {"y": _np(y), "grad": _np(x.grad)}


def inplace_earlier_consumer(pt):
    w = pt.to_tensor([2.0], stop_gradient=False)
    x = w * 1.0
    y = x.exp()
    x.multiply_(pt.to_tensor([3.0]))  # mutate AFTER y consumed x
    y.backward()
    return {"grad": _np(w.grad), "x": _np(x)}


def inplace_through_mutation(pt):
    w = pt.to_tensor([2.0], stop_gradient=False)
    x = w * 1.0
    x.multiply_(pt.to_tensor([3.0]))
    (x * x).sum().backward()
    return {"grad": _np(w.grad)}


def setitem_keeps_history(pt):
    w = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    x = w * 2.0
    x[0] = 5.0
    x.sum().backward()
    return {"grad": _np(w.grad), "x": _np(x)}


def leaf_inplace_raises(pt):
    w = pt.to_tensor([1.0], stop_gradient=False)
    try:
        w.exp_()
    except RuntimeError:
        return {"raised": True}
    return {"raised": False}


def no_grad_mutation(pt):
    w = pt.to_tensor([2.0], stop_gradient=False)
    x = w * 1.0
    y = x.exp()
    with pt.no_grad():
        x.add_(pt.to_tensor([1.0]))
    y.backward()
    z = (x * x).sum()
    return {"grad": _np(w.grad), "z_stops": z.stop_gradient, "x": _np(x)}


def leaf_hook_accumulated(pt):
    w = pt.to_tensor([2.0, 3.0], stop_gradient=False)
    seen = {}
    h = w.register_hook(lambda g: seen.__setitem__("g", g.numpy()))
    ((w * w).sum() + (3.0 * w).sum()).backward()
    return {"seen": seen["g"], "grad": _np(w.grad),
            "removes": (h.remove(), h.remove())}


def intermediate_hook_replaces(pt):
    w = pt.to_tensor([2.0, 3.0], stop_gradient=False)
    v = w * w
    v.register_hook(lambda g: g * 10)
    v.sum().backward()
    return {"grad": _np(w.grad)}


def removed_hook(pt):
    w = pt.to_tensor([1.0], stop_gradient=False)
    v = w * 2.0
    h = v.register_hook(lambda g: g * 100)
    h.remove()
    v.sum().backward()
    return {"grad": _np(w.grad)}


def hook_on_stopped_raises(pt):
    t = pt.to_tensor([1.0])
    try:
        t.register_hook(lambda g: g)
    except RuntimeError:
        return {"raised": True}
    return {"raised": False}


def gradient_accessor(pt):
    w = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    before = w.gradient()
    (w * w).sum().backward()
    return {"before": before is None, "after": w.gradient()}


def apply_and_apply_(pt):
    y = pt.to_tensor([[1.0, 2.0]])
    z = y.apply(lambda t: t * 3 + 2)
    y.apply_(lambda t: t * 2)
    w = pt.to_tensor([1.0], stop_gradient=False)
    try:
        w.apply(lambda t: t)
        refused = False
    except RuntimeError:
        refused = True
    return {"z": _np(z), "y": _np(y), "refused": refused}


def value_dense_dlpack(pt):
    x = pt.to_tensor([[1.0]])
    return {"identity": x.value() is x and x.to_dense() is x,
            "dlpack": x.__dlpack__() is not None,
            "device": isinstance(x.__dlpack_device__(), tuple)}


def leaf_hook_per_pass(pt):
    w = pt.to_tensor([1.0], stop_gradient=False)
    seen = []
    w.register_hook(lambda g: seen.append(float(g.numpy()[0])))
    (w * 2.0).sum().backward()
    (w * 2.0).sum().backward()
    return {"seen": seen, "grad": _np(w.grad)}


def replacing_leaf_hook(pt):
    w = pt.to_tensor([1.0], stop_gradient=False)
    (w * 2.0).sum().backward()
    h = w.register_hook(lambda g: g * 0)
    (w * 2.0).sum().backward()
    h.remove()
    return {"grad": _np(w.grad)}


def leaf_hook_under_grad_api(pt):
    w = pt.to_tensor([1.0], stop_gradient=False)
    w.register_hook(lambda g: g * 10)
    (gw,) = pt.grad((w * 2.0).sum(), [w])
    return {"gw": _np(gw)}


def patch_method_surface(pt):
    t = pt.to_tensor([1.0])
    return {m: hasattr(t, m) for m in (
        "set_value", "backward", "clear_grad", "gradient", "apply_",
        "apply", "register_hook", "item", "to", "to_dense", "value", "cpu",
        "pin_memory", "__dlpack__", "__dlpack_device__", "__array__",
        "__getitem__", "__setitem__")}


SCENARIOS = [simple_chain, matmul_grad, broadcast_grad, grad_accumulation,
             stop_gradient_blocks, composite, multi_output_op, getitem_grad,
             retain_grads_intermediate, paddle_grad, no_grad_ctx, pylayer,
             inplace_earlier_consumer, inplace_through_mutation,
             setitem_keeps_history, leaf_inplace_raises, no_grad_mutation,
             leaf_hook_accumulated, intermediate_hook_replaces, removed_hook,
             hook_on_stopped_raises, gradient_accessor, apply_and_apply_,
             value_dense_dlpack, leaf_hook_per_pass, replacing_leaf_hook,
             leaf_hook_under_grad_api, patch_method_surface]


def _same(a, b, key):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (key, a, b)
        np.testing.assert_allclose(a, b, rtol=ATOL[a.dtype.type] if
                                   a.dtype.type in ATOL else 0,
                                   atol=ATOL.get(a.dtype.type, 0),
                                   err_msg=key)
    else:
        assert a == b, (key, a, b)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    ref = scenario(jp)
    got = scenario(tp)
    assert ref.keys() == got.keys()
    for k in ref:
        _same(ref[k], got[k], f"{scenario.__name__}.{k}")


def test_gradients_are_torch_leaves():
    """backward accumulates into the torch leaf itself: `.grad` is the
    leaf's gradient, and a Parameter keeps its leaf across steps."""
    p = tp.Parameter(torch.ones(3))
    leaf = p._value
    (p * 2.0).sum().backward()
    assert p.grad._value is leaf.grad
    with tp.no_grad():
        p.set_value(np.full(3, 5.0, np.float32))
    assert p._value is leaf and np.allclose(p.numpy(), 5.0)


def test_saved_tensors_hooks_see_saved_values():
    packed = []

    def pack(t):
        packed.append(t.shape)
        return t

    x = tp.to_tensor(_arr(6, (4,)), stop_gradient=False)
    with tp.autograd.saved_tensors_hooks(pack, lambda t: t):
        y = (x * x).sum()
    y.backward()
    assert packed and np.allclose(x.grad.numpy(), 2 * x.numpy(), atol=1e-6)


def test_jacobian_matches_jax():
    a = _arr(7, (3,), np.float64)
    outs = []
    for pt in (jp, tp):
        x = pt.to_tensor(a, stop_gradient=False)
        outs.append(np.asarray(pt.autograd.jacobian(x * x * 2.0, x).numpy()))
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-12)


def test_place_reports_the_device():
    """Place is truthful: a CPU tensor is a CPU place, not a GPU one (the
    reference's is_gpu_place() is always False, a TPU shim)."""
    t = tp.to_tensor([1.0])
    assert t.place.is_cpu_place() and not t.place.is_gpu_place()
    assert not t.place.is_tpu_place()


def test_set_grad_enabled_is_a_context_as_in_jax():
    outs = []
    for pt in (jp, tp):
        x = pt.to_tensor([1.0], stop_gradient=False)
        ctx = pt.set_grad_enabled(False)
        before = (x * 2).stop_gradient       # nothing set until entered
        with ctx:
            inside = (x * 2).stop_gradient
        after = (x * 2).stop_gradient
        outs.append((before, inside, after))
    assert outs[0] == outs[1] == (False, True, False)
