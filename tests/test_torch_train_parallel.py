"""paddle_tpu_torch's hybrid-parallel train step held to the JAX
package's `llama_spmd.make_train_step` on the same mesh shapes.

Both packages start from the JAX package's weights and optimizer state
(the port's ranks take them through `params_from_jax`, then
`place_params`) and take 2 steps on the same batch, whose labels are
partly ignored (< 0), on every layout: dp 2 (also with packed
documents, and with n_micro 2), tp 2 (also with the fused linear+CE
head, each chunk over the rank's vocabulary columns), dp 2 x tp 2,
pp 2 with GPipe and 1F1B, pp 4 interleaved (vpp 2), sp 2 ring and
sp 4 Ulysses. The JAX side
runs on conftest's CPU devices, the port's as gloo ranks spawned once
per world size (`tests/_torch_ranks.py`, a deadline each). The port's
step-1 gradients and its parameters and optimizer state after the
steps are gathered from the ranks' shards. Refused layouts raise the
JAX package's exception, word for word."""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

import _torch_ranks as R
from paddle_tpu.models import llama_spmd as M
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu_torch.distributed import launch

DIMS = dict(vocab=64, hidden=32, layers=4, heads=4, kv_heads=2, ffn=64)
DIMS8 = dict(DIMS, layers=8)           # pp 4 x vpp 2 needs L % 8 == 0
DIMS_H2 = dict(DIMS, heads=2, kv_heads=2)
STEPS = 2
LR = 3e-4
DEADLINE_S = 240
# the tolerances of tests/test_torch_train.py
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
PARAM_ATOL = 2.5 * LR


def _batch():
    rng = np.random.default_rng(0)
    x = rng.integers(0, DIMS["vocab"], (4, 16))
    y = rng.integers(0, DIMS["vocab"], (4, 16))
    y[0, :5] = -1              # unevenly ignored labels
    y[2, 9:] = -1
    return x, y


def _packed_batch():
    x, y = _batch()
    doc = np.stack([np.repeat(np.arange(len(lens)), lens) for lens in
                    ([5, 7, 4], [16], [3, 3, 10], [8, 8])])
    return x, y, doc


BATCHES = {"plain": _batch(), "docs": _packed_batch()}
PARAMS = {"L4": DIMS, "L8": DIMS8, "H2": DIMS_H2}


def _case(world, axes, params="L4", batch="plain", refusal=False, **kw):
    return {"world": world, "axes": axes, "params": params,
            "dims": PARAMS[params], "batch": batch, "refusal": refusal,
            "kw": kw}


NO_DP = ()                     # batch_spec P(): no data axis in the mesh
LAYOUTS = {
    "dp2": _case(2, {"dp": 2}),
    "dp2_docs": _case(2, {"dp": 2}, batch="docs"),
    "dp2_n_micro2": _case(2, {"dp": 2}, n_micro=2),
    "tp2": _case(2, {"tp": 2}, batch_spec=NO_DP),
    "tp2_fused_ce": _case(2, {"tp": 2}, batch_spec=NO_DP, fused_ce=True),
    "pp2_gpipe": _case(2, {"pp": 2}, batch_spec=NO_DP, schedule="gpipe"),
    "pp2_1f1b": _case(2, {"pp": 2}, batch_spec=NO_DP, schedule="1f1b",
                      n_micro=2),
    "sp2_ring": _case(2, {"sp": 2}, batch_spec=(None, "sp"), sp_axis="sp"),
    "dp2_tp2": _case(4, {"dp": 2, "tp": 2}),
    "pp4_interleave": _case(4, {"pp": 4}, params="L8", batch_spec=NO_DP,
                            schedule="interleave", n_micro=4, vpp=2),
    "sp4_ulysses": _case(4, {"sp": 4}, batch_spec=(None, "sp"),
                         sp_axis="sp", sp_impl="ulysses"),
}
# layouts the JAX step refuses, with the same exception in the port
REFUSALS = {
    "pp2_gpipe_docs": _case(2, {"pp": 2}, batch="docs", refusal=True,
                            batch_spec=NO_DP, schedule="gpipe"),
    "pp2_1f1b_docs": _case(2, {"pp": 2}, batch="docs", refusal=True,
                           batch_spec=NO_DP, schedule="1f1b", n_micro=2),
    "sp2_docs": _case(2, {"sp": 2}, batch="docs", refusal=True,
                      batch_spec=(None, "sp"), sp_axis="sp"),
    "pp2_sp2_gpipe": _case(4, {"pp": 2, "sp": 2}, refusal=True,
                           batch_spec=(None, "sp"), sp_axis="sp",
                           schedule="gpipe"),
    "pp2_sp2_1f1b": _case(4, {"pp": 2, "sp": 2}, refusal=True,
                          batch_spec=(None, "sp"), sp_axis="sp",
                          schedule="1f1b", n_micro=2),
    "sp4_ulysses_2_heads": _case(4, {"sp": 4}, params="H2", refusal=True,
                                 batch_spec=(None, "sp"), sp_axis="sp",
                                 sp_impl="ulysses"),
}
# the port's own limits (the JAX step runs these under GSPMD)
PORT_LIMITS = {
    "tp4_two_kv_heads": (_case(4, {"tp": 4}, refusal=True,
                               batch_spec=NO_DP),
                         "ValueError", "KV heads (2) do not divide"),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(key):
    return M.init_params(JaxConfig.tiny(**PARAMS[key]), seed=3)


def _jax_mesh(case):
    n = case["world"]
    return Mesh(np.asarray(jax.devices()[:n]).reshape(
        tuple(case["axes"].values())), tuple(case["axes"]))


def _jax_kw(case):
    kw = dict(case["kw"])
    if "batch_spec" in kw:
        kw["batch_spec"] = JP(*kw["batch_spec"])
    return kw


def _jax_run(case):
    cfg = JaxConfig.tiny(**case["dims"])
    mesh = _jax_mesh(case)
    params = M.place_params(_jax_params(case["params"]), cfg, mesh)
    opt = M.init_opt_state(params)
    step = M.make_train_step(cfg, mesh, remat=True, donate=False, lr=LR,
                             **_jax_kw(case))
    batch = BATCHES[case["batch"]]
    losses = []
    for i in range(STEPS):
        params, opt, loss = step(params, opt, jnp.asarray(i), batch)
        losses.append(float(loss))
    return {"losses": losses, "params": _np(params), "opt": _np(opt)}


def _jax_refusal(case):
    cfg = JaxConfig.tiny(**case["dims"])
    mesh = _jax_mesh(case)
    params = M.place_params(_jax_params(case["params"]), cfg, mesh)
    step = M.make_train_step(cfg, mesh, remat=True, donate=False,
                             **_jax_kw(case))
    try:
        step(params, M.init_opt_state(params), jnp.asarray(0),
             BATCHES[case["batch"]])
    except Exception as e:
        return type(e).__name__, str(e)
    return None


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("store"))
    data = {"params": {k: _np(_jax_params(k)) for k in PARAMS},
            "opt": {k: _np(M.init_opt_state(_jax_params(k))) for k in PARAMS},
            "batches": BATCHES, "steps": STEPS, "lr": LR}
    cases = dict(LAYOUTS, **REFUSALS,
                 **{k: c for k, (c, _, _) in PORT_LIMITS.items()})
    with ThreadPoolExecutor(2) as pool:
        # the ranks run while the JAX side compiles
        futs = {n: pool.submit(
            launch.spawn, R.train_layouts, n, "gloo", "cpu", DEADLINE_S,
            args=(dict(data, cases={k: c for k, c in cases.items()
                                    if c["world"] == n}),),
            threads=1, store_dir=store) for n in (2, 4)}
        jax_out = {name: _jax_run(c) for name, c in LAYOUTS.items()}
        jax_out.update({name: _jax_refusal(c)
                        for name, c in REFUSALS.items()})
        grads = {(p, b): _np(jax.grad(M.loss_fn)(
            _jax_params(p), BATCHES[b], JaxConfig.tiny(**PARAMS[p])))
            for p, b in {(c["params"], c["batch"])
                         for c in LAYOUTS.values()}}
        port = {}
        for fut in futs.values():
            port.update(fut.result()[0])
    return {"jax": jax_out, "grads": grads, "port": port}


def _pairs(want, got, path=""):
    if isinstance(want, dict):
        for k in want:
            yield from _pairs(want[k], got[k], f"{path}/{k}")
    else:
        yield path, np.asarray(want), np.asarray(got)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_losses_match_jax(results, name):
    want, got = results["jax"][name], results["port"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_step1_grads_match_jax(results, name):
    """The step's gradients before clipping, gathered from the ranks,
    against JAX's one-shot gradients of the same batch."""
    case = LAYOUTS[name]
    want = results["grads"][(case["params"], case["batch"])]
    for path, a, b in _pairs(want, results["port"][name]["grads"]):
        assert b.dtype == np.float32, path
        np.testing.assert_allclose(b, a, err_msg=path, **GRAD_TOL)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_params_and_opt_state_after_steps_match_jax(results, name):
    want, got = results["jax"][name], results["port"][name]
    for tree in ("params", "opt"):
        for path, a, b in _pairs(want[tree], got[tree]):
            if path.endswith("/v"):
                np.testing.assert_allclose(b, a, atol=1e-10, rtol=1e-3,
                                           err_msg=path)
                continue
            if path.endswith("/m"):
                np.testing.assert_allclose(b, a, err_msg=path, **GRAD_TOL)
                continue
            np.testing.assert_allclose(b, a, atol=PARAM_ATOL, rtol=0,
                                       err_msg=path)
            assert np.linalg.norm(b - a) <= 1e-5 * np.linalg.norm(a), path


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_jax(results, name):
    want, got = results["jax"][name], results["port"][name]
    assert want is not None and got is not None, (want, got)
    assert got == want


@pytest.mark.parametrize("name", list(PORT_LIMITS))
def test_port_limits_raise(results, name):
    _, cls, words = PORT_LIMITS[name]
    got = results["port"][name]
    assert got is not None and got[0] == cls and words in got[1], got


@pytest.mark.parametrize("s,v", [(2, 2), (4, 2), (2, 4)])
def test_interleaved_placement_gives_each_rank_its_chunks(s, v):
    """place_params(vpp=v): rank r's layers are the JAX package's
    interleaved stage r (`group_virtual_stages`' row r, chunk by chunk),
    in the parameters and in the optimizer state; the ranks' blocks in
    order go back to the full stack."""
    import torch
    from paddle_tpu.parallel import pp as JPP
    from paddle_tpu_torch.models import llama_spmd as T
    from paddle_tpu_torch.parallel.mesh import RankMesh
    cfg = R._config(DIMS8)
    jp = _jax_params("L8")
    want = _np(JPP.group_virtual_stages(jp["layers"], s, v))
    full = T.params_from_jax(_np(jp), "cpu")
    opt = T.init_opt_state(full)
    blocks = []
    for r in range(s):
        mesh = RankMesh(np.arange(s), ("pp",), rank=r)
        got = T.place_params(full, cfg, mesh, vpp=v)
        got_opt = T.place_params(opt, cfg, mesh, vpp=v)
        for k, w in want.items():
            row = w[r].reshape(-1, *w.shape[3:])
            np.testing.assert_array_equal(got["layers"][k].numpy(), row)
            np.testing.assert_array_equal(
                got_opt["layers"][k]["master"].numpy(), row)
        np.testing.assert_array_equal(got["embed"].numpy(),
                                      full["embed"].numpy())
        blocks.append(got["layers"]["wq"])
    np.testing.assert_array_equal(
        T._deinterleave_layers(torch.cat(blocks), s, v).numpy(),
        full["layers"]["wq"].numpy())
