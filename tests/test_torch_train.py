"""paddle_tpu_torch's single-device pretrain step held to the JAX
package's `llama_spmd.make_train_step`.

Both packages start from the same weights and optimizer state (the JAX
trees carried across by `params_from_jax`) and take 3 steps on the same
batch, whose labels are partly ignored (< 0). On the CPU the port's
attention runs the plain versions of the flash kernels, the JAX step its
XLA reference (`mha_reference`)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu_torch.ops.flash_attention as fa
from paddle_tpu.models import llama_spmd as M
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu_torch.models import llama_spmd as T
from paddle_tpu_torch.models.llama import LlamaConfig

DIMS = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64)
CFG = LlamaConfig.tiny(**DIMS)
STEPS = 3
LR = 3e-4
# fp32 on both sides, sums in another order: the losses agree to 1e-5
# relative, the step-1 gradients elementwise to GRAD_TOL
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
# AdamW's first steps move an element by about lr whatever the size of
# its gradient, so a gradient near zero whose sign differs between the
# two runs moves it by up to 2 lr: parameters are held to 2.5 lr
# elementwise, and to 1e-5 in relative norm
PARAM_ATOL = 2.5 * LR


def _batch():
    rng = np.random.default_rng(0)
    x = rng.integers(0, DIMS["vocab"], (4, 16))
    y = rng.integers(0, DIMS["vocab"], (4, 16))
    y[0, :5] = -1              # unevenly ignored labels
    y[2, 9:] = -1
    return x, y


def _jax_params():
    return M.init_params(JaxConfig.tiny(**DIMS), seed=3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_grads():
    """The one-shot step's gradients (remat changes none of them)."""
    x, y = _batch()
    return _np(jax.grad(M.loss_fn)(_jax_params(), (x, y),
                                   JaxConfig.tiny(**DIMS)))


def _jax_run(n_micro, remat):
    cfg = JaxConfig.tiny(**DIMS)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    x, y = _batch()
    params = _jax_params()
    opt = M.init_opt_state(params)
    step = M.make_train_step(cfg, mesh, n_micro=n_micro, remat=remat,
                             donate=False)
    losses = []
    for i in range(STEPS):
        params, opt, loss = step(params, opt, jnp.asarray(i), (x, y))
        losses.append(float(loss))
    return {"losses": losses, "params": _np(params), "opt": _np(opt)}


def _torch_run(n_micro, remat):
    x, y = _batch()
    params = T.params_from_jax(_np(_jax_params()), "cpu")
    opt = T.params_from_jax(_np(M.init_opt_state(_jax_params())), "cpu")
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    _, grads = T.loss_and_grads(params, batch, CFG, n_micro, remat)
    step = T.make_train_step(CFG, n_micro=n_micro, remat=remat, lr=LR,
                             device="cpu")
    losses = []
    for i in range(STEPS):
        params, opt, loss = step(params, opt, i, (x, y))
        losses.append(float(loss))
    return {"losses": losses, "grads": grads, "params": params, "opt": opt}


def _pairs(np_tree, t_tree, path=""):
    if isinstance(np_tree, dict):
        for k in np_tree:
            yield from _pairs(np_tree[k], t_tree[k], f"{path}/{k}")
    else:
        yield path, np_tree, t_tree.detach().numpy()


RUNS = {"remat": (None, True), "no_remat": (None, False),
        "n_micro2": (2, True)}


@pytest.fixture(scope="module")
def runs():
    grads = _jax_grads()
    return {name: (dict(_jax_run(*args), grads=grads), _torch_run(*args))
            for name, args in RUNS.items()}


@pytest.mark.parametrize("name", list(RUNS))
def test_losses_match_jax(runs, name):
    want, got = runs[name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("name", list(RUNS))
def test_step1_grads_match_jax(runs, name):
    """The step's gradients before clipping, against JAX's one-shot
    gradients (with n_micro=2, the port's accumulated ones)."""
    want, got = runs[name]
    for path, a, b in _pairs(want["grads"], got["grads"]):
        assert b.dtype == np.float32, path
        np.testing.assert_allclose(b, a, err_msg=path, **GRAD_TOL)


@pytest.mark.parametrize("name", list(RUNS))
def test_params_and_opt_state_after_steps_match_jax(runs, name):
    want, got = runs[name]
    for tree in ("params", "opt"):
        for path, a, b in _pairs(want[tree], got[tree]):
            if path.endswith("/v"):
                # second moments: squares of gradients, ~1e-6 and below
                np.testing.assert_allclose(b, a, atol=1e-10, rtol=1e-3,
                                           err_msg=path)
                continue
            if path.endswith("/m"):
                np.testing.assert_allclose(b, a, err_msg=path, **GRAD_TOL)
                continue
            np.testing.assert_allclose(b, a, atol=PARAM_ATOL, rtol=0,
                                       err_msg=path)
            assert np.linalg.norm(b - a) <= 1e-5 * np.linalg.norm(a), path


def test_grad_accumulation_equals_one_shot_step(runs):
    one, acc = runs["remat"][1], runs["n_micro2"][1]
    np.testing.assert_allclose(acc["losses"], one["losses"], rtol=LOSS_RTOL)


def test_params_from_jax_carries_the_opt_state_tree():
    params = _jax_params()
    want = _np(M.init_opt_state(params))
    opt = T.params_from_jax(want, "cpu")
    n = 0
    for path, a, b in _pairs(want, opt):
        assert b.dtype == np.float32, path
        np.testing.assert_array_equal(b, a, err_msg=path)
        n += 1
    assert n == 3 * len(jax.tree.leaves(params))
    # and the port's own init_opt_state builds the same tree
    mine = T.init_opt_state(T.params_from_jax(_np(params), "cpu"))
    for path, a, b in _pairs(want, mine):
        np.testing.assert_array_equal(b, a, err_msg=path)


def test_remat_runs_the_attention_forward_again(monkeypatch):
    """Under checkpointing each layer's attention forward runs twice per
    step (forward, then the recompute in backward), dQ and dK/dV once;
    without it, once each. Counted on the plain versions the CPU runs."""
    calls = {"fwd": 0, "dq": 0, "dkv": 0}

    def counting(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped
    for name, attr in (("fwd", "flash_fwd_reference"),
                       ("dq", "flash_bwd_dq_reference"),
                       ("dkv", "flash_bwd_dkv_reference")):
        monkeypatch.setattr(fa, attr, counting(name, getattr(fa, attr)))
    x, y = _batch()
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    L = CFG.num_hidden_layers
    for remat, fwd_per_layer in ((True, 2), (False, 1)):
        params = T.params_from_jax(_np(_jax_params()), "cpu")
        opt = T.init_opt_state(params)
        step = T.make_train_step(CFG, remat=remat, device="cpu")
        for k in calls:
            calls[k] = 0
        for i in range(2):
            step(params, opt, i, (x, y))
        assert calls == {"fwd": fwd_per_layer * L * 2, "dq": L * 2,
                         "dkv": L * 2}, remat
    # CPU tensors never launch a kernel
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == before


def test_step_updates_in_place():
    x, y = _batch()
    params = T.params_from_jax(_np(_jax_params()), "cpu")
    opt = T.init_opt_state(params)
    wq = params["layers"]["wq"]
    before = wq.clone()
    step = T.make_train_step(CFG, device="cpu")
    p2, o2, loss = step(params, opt, 0, (x, y))
    assert p2 is params and o2 is opt
    assert p2["layers"]["wq"] is wq and not torch.equal(wq, before)
    assert not wq.requires_grad and loss.dim() == 0


@pytest.mark.parametrize("kw,match", [
    ({"sp_axis": "sp"}, "sequence parallelism"),
    ({"schedule": "1f1b"}, "pipeline schedules"),
    ({"fused_ce": True}, "fused linear"),
    ({"remat": "dots"}, "dots"),
])
def test_later_slices_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        T.make_train_step(CFG, device="cpu", **kw)


def test_mesh_of_more_than_one_device_raises():
    one = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    T.make_train_step(CFG, mesh=one, device="cpu")
    two = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    with pytest.raises(NotImplementedError, match="more than one device"):
        T.make_train_step(CFG, mesh=two, device="cpu")


def test_doc_ids_raise():
    x, y = _batch()
    params = T.params_from_jax(_np(_jax_params()), "cpu")
    step = T.make_train_step(CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="doc_ids"):
        step(params, T.init_opt_state(params), 0, (x, y, np.zeros_like(x)))


def test_params_on_another_device_raise():
    x, y = _batch()
    params = T.params_from_jax(_np(_jax_params()), "cpu")
    opt = T.init_opt_state(params)
    params["final_norm"] = params["final_norm"].to("meta")
    with pytest.raises(ValueError, match="live on meta"):
        T.make_train_step(CFG, device="cpu")(params, opt, 0, (x, y))
