"""paddle_tpu_torch's single-device pretrain step held to the JAX
package's `llama_spmd.make_train_step`.

Both packages start from the same weights and optimizer state (the JAX
trees carried across by `params_from_jax`) and take 3 steps on the same
batch, whose labels are partly ignored (< 0), with and without packed
documents (a third batch element, doc_ids). On the CPU the port's
attention runs the plain versions of the flash and FlashMask kernels,
the JAX step its XLA references (`mha_reference`,
`flashmask_reference`). The options that take a mesh of ranks
(sp_axis, schedule, a dp mesh with and without packed documents) run on
two gloo ranks here and take the single-device step's losses;
`tests/test_torch_train_parallel.py` holds every layout to JAX's."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu_torch.ops.flash_attention as fa
import paddle_tpu_torch.ops.flashmask_attention as fm
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


def _packed_batch():
    """The batch with contiguous documents of uneven lengths per row."""
    x, y = _batch()
    doc = np.stack([np.repeat(np.arange(len(lens)), lens) for lens in
                    ([5, 7, 4], [16], [3, 3, 10], [8, 8])])
    return x, y, doc


def _jax_params():
    return M.init_params(JaxConfig.tiny(**DIMS), seed=3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_grads(packed):
    """The one-shot step's gradients (remat changes none of them)."""
    batch = _packed_batch() if packed else _batch()
    return _np(jax.grad(M.loss_fn)(_jax_params(), batch,
                                   JaxConfig.tiny(**DIMS)))


def _jax_run(n_micro, remat, packed):
    cfg = JaxConfig.tiny(**DIMS)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    batch = _packed_batch() if packed else _batch()
    params = _jax_params()
    opt = M.init_opt_state(params)
    step = M.make_train_step(cfg, mesh, n_micro=n_micro, remat=remat,
                             donate=False)
    losses = []
    for i in range(STEPS):
        params, opt, loss = step(params, opt, jnp.asarray(i), batch)
        losses.append(float(loss))
    return {"losses": losses, "params": _np(params), "opt": _np(opt)}


def _torch_run(n_micro, remat, packed):
    batch = _packed_batch() if packed else _batch()
    params = T.params_from_jax(_np(_jax_params()), "cpu")
    opt = T.params_from_jax(_np(M.init_opt_state(_jax_params())), "cpu")
    _, grads = T.loss_and_grads(params, tuple(map(torch.from_numpy, batch)),
                                CFG, n_micro, remat)
    step = T.make_train_step(CFG, n_micro=n_micro, remat=remat, lr=LR,
                             device="cpu")
    losses = []
    for i in range(STEPS):
        params, opt, loss = step(params, opt, i, batch)
        losses.append(float(loss))
    return {"losses": losses, "grads": grads, "params": params, "opt": opt}


def _pairs(np_tree, t_tree, path=""):
    if isinstance(np_tree, dict):
        for k in np_tree:
            yield from _pairs(np_tree[k], t_tree[k], f"{path}/{k}")
    else:
        yield path, np_tree, t_tree.detach().numpy()


# name -> (n_micro, remat, packed documents)
RUNS = {"remat": (None, True, False), "no_remat": (None, False, False),
        "n_micro2": (2, True, False), "packed": (None, True, True),
        "packed_no_remat": (None, False, True),
        "packed_n_micro2": (2, True, True)}


@pytest.fixture(scope="module")
def runs():
    grads = {packed: _jax_grads(packed) for packed in (False, True)}
    return {name: (dict(_jax_run(*args), grads=grads[args[2]]),
                   _torch_run(*args))
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


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def test_packed_grad_accumulation_equals_one_shot_step(runs):
    """n_micro=2 cuts every batch element, doc_ids included."""
    one, acc = runs["packed"][1], runs["packed_n_micro2"][1]
    np.testing.assert_allclose(acc["losses"], one["losses"], rtol=LOSS_RTOL)
    for path, a, b in _pairs(_np_tree(one["grads"]), acc["grads"]):
        np.testing.assert_allclose(b, a, err_msg=path, **GRAD_TOL)


def test_packed_masking_changes_the_loss(runs):
    assert abs(runs["packed"][1]["losses"][0]
               - runs["remat"][1]["losses"][0]) > 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_doc_end_indices_equal_jax(seed):
    rng = np.random.default_rng(seed)
    doc = np.stack([np.repeat(np.arange(n), np.diff(np.concatenate(
        [[0], np.sort(rng.choice(np.arange(1, 50), n - 1, replace=False)),
         [50]]))) for n in (1, 3, 7)])
    want = np.asarray(M.doc_end_indices(jnp.asarray(doc)))
    got = T.doc_end_indices(torch.from_numpy(doc))
    assert got.dtype == torch.int32 and got.shape == (3, 1, 50, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_packed_forward_equals_separate_documents():
    """Packed (doc_ids) forward equals each document run as its own
    sequence: attention across documents is fully blocked."""
    params = T.params_from_jax(_np(M.init_params(JaxConfig.tiny(**DIMS),
                                                 seed=0)), "cpu")
    rng = np.random.default_rng(0)
    lens = [10, 6, 16]
    ids = torch.from_numpy(rng.integers(0, DIMS["vocab"], (1, 32)))
    doc = torch.from_numpy(np.repeat(np.arange(3), lens)[None])
    with torch.no_grad():
        packed = T.forward(params, ids, CFG, remat=False, doc_ids=doc)
        off = 0
        for n in lens:
            solo = T.forward(params, ids[:, off:off + n], CFG, remat=False)
            torch.testing.assert_close(packed[:, off:off + n], solo,
                                       atol=1e-5, rtol=1e-5)
            off += n


def test_packed_step_runs_flashmask_not_flash(monkeypatch):
    """doc_ids route every layer through the FlashMask plain versions on
    the CPU (the forward twice per layer and step under remat) and none
    through the flash ones; no kernel launches."""
    calls = {}

    def counting(mod, attr):
        fn = getattr(mod, attr)

        def wrapped(*a):
            calls[attr] = calls.get(attr, 0) + 1
            return fn(*a)
        monkeypatch.setattr(mod, attr, wrapped)
    for attr in ("flash_fwd_reference", "flash_bwd_dq_reference",
                 "flash_bwd_dkv_reference"):
        counting(fa, attr)
    for attr in ("flashmask_fwd_reference", "flashmask_bwd_dq_reference",
                 "flashmask_bwd_dkv_reference"):
        counting(fm, attr)
    before = (fm.launches_fwd, fm.launches_dq, fm.launches_dkv)
    params = T.params_from_jax(_np(_jax_params()), "cpu")
    step = T.make_train_step(CFG, remat=True, device="cpu")
    for i in range(2):
        step(params, T.init_opt_state(params), i, _packed_batch())
    L = CFG.num_hidden_layers
    assert calls == {"flashmask_fwd_reference": 2 * L * 2,
                     "flashmask_bwd_dq_reference": L * 2,
                     "flashmask_bwd_dkv_reference": L * 2}
    assert (fm.launches_fwd, fm.launches_dq, fm.launches_dkv) == before


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


# the options that once raised, on two gloo ranks spawned once for the
# module (tests/_torch_ranks.py): name -> (mesh axes, options, batch)
MESH_RUNS = {"sp_axis": ({"sp": 2}, {"batch_spec": (None, "sp"),
                                     "sp_axis": "sp"}, "plain"),
             "schedule": ({"pp": 2}, {"batch_spec": (), "schedule": "1f1b",
                                      "n_micro": 2}, "plain"),
             "mesh": ({"dp": 2}, {}, "plain"),
             "mesh_doc_ids": ({"dp": 2}, {}, "docs")}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    import _torch_ranks as R
    from paddle_tpu_torch.distributed import launch
    cases = {name: {"world": 2, "axes": axes, "kw": kw, "dims": DIMS,
                    "params": "p", "batch": batch}
             for name, (axes, kw, batch) in MESH_RUNS.items()}
    params = _jax_params()
    data = {"cases": cases, "params": {"p": _np(params)},
            "opt": {"p": _np(M.init_opt_state(params))},
            "batches": {"plain": _batch(), "docs": _packed_batch()},
            "steps": STEPS, "lr": LR}
    return launch.spawn(R.train_layouts, 2, "gloo", "cpu", 180,
                        args=(data,), threads=1,
                        store_dir=str(tmp_path_factory.mktemp("store")))[0]


@pytest.mark.parametrize("docs", [False, True], ids=["plain", "doc_ids"])
def test_a_two_rank_mesh_runs(runs, mesh_runs, docs):
    """A dp 2 mesh (the JAX package's dp-sharded step, with and without
    packed documents) takes the single-device step's losses."""
    got = mesh_runs["mesh_doc_ids" if docs else "mesh"]["losses"]
    want = runs["packed" if docs else "remat"][1]["losses"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_sp_axis_runs_on_a_two_rank_mesh(runs, mesh_runs):
    np.testing.assert_allclose(mesh_runs["sp_axis"]["losses"],
                               runs["remat"][1]["losses"], rtol=LOSS_RTOL)


def test_schedule_runs_on_a_two_stage_mesh(runs, mesh_runs):
    """schedule="1f1b" on a pp 2 mesh: the single-device losses."""
    np.testing.assert_allclose(mesh_runs["schedule"]["losses"],
                               runs["remat"][1]["losses"], rtol=LOSS_RTOL)


def test_a_mesh_of_one_device_is_one_device():
    """A JAX mesh of one device (or none) is the single-device step; a
    JAX mesh of more devices cannot drive ranks."""
    x, y = _batch()
    one = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    params = T.params_from_jax(_np(_jax_params()), "cpu")
    step = T.make_train_step(CFG, mesh=one, device="cpu")
    assert np.isfinite(float(step(params, T.init_opt_state(params), 0,
                                  (x, y))[2]))
    two = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    with pytest.raises(ValueError, match="rank mesh"):
        T.make_train_step(CFG, mesh=two, device="cpu")


def test_params_on_another_device_raise():
    x, y = _batch()
    params = T.params_from_jax(_np(_jax_params()), "cpu")
    opt = T.init_opt_state(params)
    params["final_norm"] = params["final_norm"].to("meta")
    with pytest.raises(ValueError, match="live on meta"):
        T.make_train_step(CFG, device="cpu")(params, opt, 0, (x, y))
