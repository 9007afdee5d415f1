"""paddle_tpu_torch's parallel layers held to the JAX package's.

The tensor-parallel layers (`ColumnParallelLinear` with and without
`gather_output`, `RowParallelLinear` with and without
`input_is_parallel`, `VocabParallelEmbedding`, `ParallelCrossEntropy`
and plain `nn.Linear`s split by `annotate_module_tp`) run on a rank
mesh {"tp": 2}, `MoELayer` on {"ep": 2} and `PipelineLayer` staged on
{"pp": 2}: gloo ranks spawned once (`tests/_torch_ranks.layer_cases`),
each layer cut to the rank's block by its dist_spec (`place_layer`).
Their outputs and the gradients of sum(out * w) (gathered whole) are
held to the JAX package's layers on the same weights (taken from the
JAX layers' state dicts) within 1e-5; MoE's dropped assignments are
identical (the dispatch tensors equal). PipelineLayer's warnings and
refusal are the JAX package's, word for word."""
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import paddle_tpu as jp
import _torch_ranks as R
from paddle_tpu_torch.distributed import launch

TOL = dict(rtol=1e-5, atol=1e-5)
DEADLINE_S = 180


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch._core import state as tstate
    prev = tstate._device
    tstate.set_device("cpu")
    yield
    tstate._device = prev


def _np(t):
    return np.asarray(t.numpy())


def _sd(layer):
    return {k: _np(v) for k, v in layer.state_dict().items()}


def _rng(seed):
    return np.random.default_rng(seed)


def _jax_grads(layer, x_t, out, w, extra=None):
    loss = (out * jp.to_tensor(w)).sum()
    if extra is not None:
        loss = loss + extra
    loss.backward()
    res = {"grads": {n: _np(p.grad) for n, p in layer.named_parameters()}}
    if x_t is not None and x_t.grad is not None:
        res["x_grad"] = _np(x_t.grad)
    return res


# ------------------------------------------------------ tp layer cases
TP_LAYERS = {
    "column_gather": ("ColumnParallelLinear", (16, 32), {}),
    "column_split": ("ColumnParallelLinear", (16, 32),
                     {"gather_output": False}),
    "column_no_bias": ("ColumnParallelLinear", (16, 32), {"has_bias": False}),
    "row_split_input": ("RowParallelLinear", (32, 16), {}),
    "row_parallel_input": ("RowParallelLinear", (32, 16),
                           {"input_is_parallel": True}),
    "vocab_embedding": ("VocabParallelEmbedding", (64, 16), {}),
    "parallel_ce": ("ParallelCrossEntropy", (), {}),
    "annotated_linears": ("annotated", (), {"dims": (16, 32, 8)}),
}
RULES = {"0.weight": (None, "tp"), "1.weight": ("tp", None)}


def _jax_tp_layer(kind, args, kw):
    from paddle_tpu import parallel as JPAR
    from paddle_tpu.parallel.tp import annotate_module_tp
    from jax.sharding import PartitionSpec as JP
    if kind == "annotated":
        d = kw["dims"]
        model = jp.nn.Sequential(jp.nn.Linear(d[0], d[1]),
                                 jp.nn.Linear(d[1], d[2]))
        return annotate_module_tp(model, {k: JP(*v) for k, v in
                                          RULES.items()})
    return getattr(JPAR, kind)(*args, **kw)


def _tp_inputs(name, kind, args, kw):
    rng = _rng(len(name))
    if kind == "VocabParallelEmbedding":
        x = rng.integers(0, args[0], (4, 6))
        x[0, :3] = [0, args[0] // 2, args[0] - 1]
        return x, rng.standard_normal((4, 6, args[1])).astype(np.float32)
    if kind == "ParallelCrossEntropy":
        x = rng.standard_normal((4, 6, 64)).astype(np.float32)
        return x, rng.standard_normal((4, 6)).astype(np.float32)
    width = kw.get("dims", args)[0]
    out_w = kw.get("dims", args)[-1]
    x = rng.standard_normal((4, 6, width)).astype(np.float32)
    return x, rng.standard_normal((4, 6, out_w)).astype(np.float32)


def _tp_cases():
    """(port cases, JAX results) of every TP_LAYERS entry."""
    cases, want = {}, {}
    for name, (kind, args, kw) in TP_LAYERS.items():
        jp.seed(7)
        layer = _jax_tp_layer(kind, args, kw)
        x, w = _tp_inputs(name, kind, args, kw)
        case = {"kind": kind, "args": args, "kw": kw, "sd": _sd(layer),
                "x": x, "w": w, "rules": RULES,
                "split_out": kw.get("gather_output") is False}
        x_t = jp.to_tensor(x, stop_gradient=x.dtype.kind != "f")
        if kind == "ParallelCrossEntropy":
            label = _rng(3).integers(0, 64, (4, 6))
            label[1, :2] = -100
            case["label"] = label
            out = layer(x_t, jp.to_tensor(label))
        else:
            out = layer(x_t)
        want[name] = dict(_jax_grads(layer, x_t, out, w), out=_np(out))
        cases[name] = case
    return cases, want


# ------------------------------------------------------------ MoE cases
MOE = {
    "top2_shared": ((16, 32, 4), {"top_k": 2, "capacity_factor": 1.0,
                                  "num_shared_experts": 1}),
    "top2_cf125": ((16, 32, 4), {"top_k": 2, "capacity_factor": 1.25}),
    "top1": ((16, 32, 4), {"top_k": 1, "capacity_factor": 1.0}),
}
AUX_WEIGHT = 0.5


def _jax_dispatch(x, gate_w, k, cf):
    import jax.numpy as jnp
    from paddle_tpu.parallel.moe import top_k_gating
    tokens = x.reshape(-1, x.shape[-1])
    T, E = tokens.shape[0], gate_w.shape[1]
    cap = max(1, int(cf * T * k / E))
    d, c, aux = top_k_gating(jnp.asarray(tokens) @ jnp.asarray(gate_w), k,
                             cap)
    return np.asarray(d), np.asarray(c), float(aux)


def _moe_cases():
    from paddle_tpu.parallel import MoELayer as JMoE
    cases, want = {}, {}
    for name, (args, kw) in MOE.items():
        jp.seed(11)
        layer = JMoE(*args, **kw)
        rng = _rng(5)
        x = rng.standard_normal((2, 16, args[0])).astype(np.float32)
        w = rng.standard_normal((2, 16, args[0])).astype(np.float32)
        x_t = jp.to_tensor(x, stop_gradient=False)
        out = layer(x_t)
        aux = float(_np(layer.aux_loss))
        res = _jax_grads(layer, x_t, out, w, layer.aux_loss * AUX_WEIGHT)
        disp, comb, _ = _jax_dispatch(x, _sd(layer)["gate_weight"],
                                      kw["top_k"], kw["capacity_factor"])
        want[name] = dict(res, out=_np(out), aux=aux, dispatch=disp,
                          combine=comb,
                          dropped=x.shape[0] * x.shape[1] * kw["top_k"]
                          - int(disp.sum()))
        cases[name] = {"args": args, "kw": kw, "sd": _sd(layer), "x": x,
                       "w": w, "aux_weight": AUX_WEIGHT}
    return cases, want


# ----------------------------------------------------- PipelineLayer
PP = {
    "eight_linears": {"descs": [("Linear", (16, 16))] * 8, "n_micro": 2},
    "head_run_tail": {"descs": [("Linear", (16, 32))]
                      + [("Linear", (32, 32))] * 4
                      + [("Linear", (32, 8))], "n_micro": 4},
    "two_runs": {"descs": [("Linear", (16, 16))] * 4
                 + [("Tanh", ())] + [("Linear", (16, 16))] * 3,
                 "n_micro": 2},
    "recompute": {"descs": [("Linear", (16, 16))] * 4, "n_micro": 2,
                  "recompute": 1},
}


def _jax_pipeline(case):
    from paddle_tpu.parallel.pp import LayerDesc, PipelineLayer
    jp.seed(13)
    descs = [LayerDesc(getattr(jp.nn, c), *a) for c, a in case["descs"]]
    pl = PipelineLayer(descs, num_stages=2)
    x = _rng(17).standard_normal((4, 3, case["descs"][0][1][0])).astype(
        np.float32)
    out = _np(pl(jp.to_tensor(x)))
    return pl, x, out


def _pp_cases():
    cases, want = {}, {}
    for name, case in PP.items():
        pl, x, out = _jax_pipeline(case)
        w = _rng(19).standard_normal(out.shape).astype(np.float32)
        cases[name] = dict(case, stages=2, x=x, w=w,
                           sds=[_sd(layer) for layer in pl.built])
        want[name] = {"out": out}
    return cases, want


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("store"))
    tp_cases, tp_want = _tp_cases()
    moe_cases, moe_want = _moe_cases()
    pp_cases, pp_want = _pp_cases()
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(launch.spawn, R.layer_cases, 2, "gloo", "cpu",
                          DEADLINE_S, args=({"tp": tp_cases, "moe": moe_cases,
                                             "pp": pp_cases},),
                          threads=1, store_dir=store)
        port = fut.result()[0]
    return {"tp": tp_want, "moe": moe_want, "pp": pp_want, "port": port}


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=path, **TOL)


@pytest.mark.parametrize("name", list(TP_LAYERS))
def test_tp_layer_matches_jax(results, name):
    want, got = results["tp"][name], results["port"][name]
    _close(got["out"], want["out"], "out")
    _close(got["grads"], want["grads"], "grads")
    if "x_grad" in want:
        _close(got["x_grad"], want["x_grad"], "x_grad")


@pytest.mark.parametrize("name", list(MOE))
def test_moe_on_ep2_matches_jax(results, name):
    want, got = results["moe"][name], results["port"][name]
    _close(got["out"], want["out"], "out")
    assert abs(got["aux"] - want["aux"]) <= 1e-5
    _close(got["grads"], want["grads"], "grads")
    _close(got["x_grad"], want["x_grad"], "x_grad")
    assert got["dropped"] == want["dropped"]


def test_moe_case_drops_assignments(results):
    """The capacity-factor-1 cases run over capacity, so the drop order
    is what the parity above checks."""
    assert results["moe"]["top2_shared"]["dropped"] > 0
    assert results["moe"]["top1"]["dropped"] > 0


@pytest.mark.parametrize("name", list(MOE))
def test_moe_dispatch_is_jax_dispatch(results, name):
    """The port's gating keeps and drops exactly the assignments JAX's
    does: dispatch equal, combine within 1e-6."""
    import torch
    from paddle_tpu_torch.parallel.moe import top_k_gating
    args, kw = MOE[name]
    want = results["moe"][name]
    case = MOE[name]
    x = _rng(5).standard_normal((2, 16, args[0])).astype(np.float32)
    jp.seed(11)
    from paddle_tpu.parallel import MoELayer as JMoE
    gate_w = _sd(JMoE(*case[0], **case[1]))["gate_weight"]
    tokens = torch.from_numpy(x.reshape(-1, args[0]))
    T, E, k = tokens.shape[0], gate_w.shape[1], kw["top_k"]
    cap = max(1, int(kw["capacity_factor"] * T * k / E))
    d, c, _ = top_k_gating(tokens @ torch.from_numpy(np.array(gate_w)), k,
                           cap)
    np.testing.assert_array_equal(d.numpy(), want["dispatch"])
    np.testing.assert_allclose(c.numpy(), want["combine"], atol=1e-6)


def test_expert_slot_positions_match_jax():
    import jax.numpy as jnp
    import torch
    from paddle_tpu.parallel.moe import expert_slot_positions as jesp
    from paddle_tpu_torch.parallel.moe import expert_slot_positions
    idx = _rng(23).integers(-1, 5, (40, 3))
    got = expert_slot_positions(torch.from_numpy(idx), 5).numpy()
    np.testing.assert_array_equal(got, np.asarray(jesp(jnp.asarray(idx), 5)))


@pytest.mark.parametrize("name", list(PP))
def test_pipeline_layer_staged_matches_sequential(results, name):
    got = results["port"][name]
    assert got["staged"]["staged"] and not got["sequential"]["staged"]
    _close(got["staged"]["out"], results["pp"][name]["out"], "vs jax")
    _close(got["staged"]["out"], got["sequential"]["out"], "out")
    _close(got["staged"]["x_grad"], got["sequential"]["x_grad"], "x_grad")
    for i, (a, b) in enumerate(zip(got["staged"]["grads"],
                                   got["sequential"]["grads"])):
        _close(a, b, f"layer {i}")


def test_pipeline_layer_segments_match_jax(results):
    for name, case in PP.items():
        from paddle_tpu.parallel.pp import LayerDesc, PipelineLayer
        descs = [LayerDesc(getattr(jp.nn, c), *a) for c, a in case["descs"]]
        want = PipelineLayer(descs, num_stages=2)._find_stageable_segments()
        got = results["port"][name]["staged"]["segments"]
        assert [tuple(s) for s in got] == want, name


def _warnings_of(make):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            make()
        except ValueError as e:
            return ["ValueError: " + str(e)]
    return [str(w.message) for w in caught]


@pytest.mark.parametrize("what", ["nothing_stackable", "mesh_mismatch",
                                  "recompute_off_path", "bad_seg_method"])
def test_pipeline_layer_warnings_and_refusal_match_jax(what):
    """The sequential fallback's warnings and the seg_method refusal,
    word for word (the port's mesh is built in one process: the
    warnings come at construction, before any collective)."""
    import jax
    from jax.sharding import Mesh
    from paddle_tpu.parallel.pp import LayerDesc as JD, PipelineLayer as JPL
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.parallel import LayerDesc, PipelineLayer
    from paddle_tpu_torch.parallel.mesh import RankMesh
    jmesh = Mesh(np.asarray(jax.devices()[:2]), ("pp",))
    tmesh = RankMesh(np.arange(2), ("pp",), rank=0)
    descs = {"nothing_stackable": [("Linear", (4, 8)), ("Linear", (8, 4))],
             "mesh_mismatch": [("Linear", (4, 4))] * 4,
             "recompute_off_path": [("Linear", (4, 8)), ("Linear", (8, 4))],
             "bad_seg_method": [("Linear", (4, 4))] * 4}[what]
    kw = {"nothing_stackable": dict(num_stages=2),
          "mesh_mismatch": dict(num_stages=4),
          "recompute_off_path": dict(num_stages=2, recompute_interval=1),
          "bad_seg_method": dict(num_stages=2, seg_method="even")}[what]
    want = _warnings_of(lambda: JPL([JD(getattr(jp.nn, c), *a)
                                     for c, a in descs], mesh=jmesh, **kw))
    got = _warnings_of(lambda: PipelineLayer(
        [LayerDesc(getattr(nn, c), *a) for c, a in descs], mesh=tmesh,
        **kw))
    assert want and got == want


def test_annotate_module_tp_sets_the_jax_specs():
    from paddle_tpu.models.llama import LlamaConfig as JC
    from paddle_tpu.models.llama import LlamaForCausalLM as JL
    from paddle_tpu.parallel.tp import annotate_module_tp as jann
    from jax.sharding import PartitionSpec as JP
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.parallel import P, annotate_module_tp
    rules = {"*norm.weight": ("tp",), "*.mlp.up_proj.weight": ("tp", None)}
    jm = jann(JL(JC.tiny()), {k: JP(*v) for k, v in rules.items()})
    tm = annotate_module_tp(LlamaForCausalLM(LlamaConfig.tiny()),
                            {k: P(*v) for k, v in rules.items()})
    want = {n: (tuple(p.dist_spec) if p.dist_spec is not None else None,
                p.is_distributed) for n, p in jm.named_parameters()}
    got = {n: (tuple(p.dist_spec) if p.dist_spec is not None else None,
               p.is_distributed) for n, p in tm.named_parameters()}
    assert got == want


def test_mark_sequence_parallel_keeps_values():
    from paddle_tpu.parallel.tp import mark_sequence_parallel as jmark
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.parallel import mark_sequence_parallel
    x = _rng(29).standard_normal((2, 8, 4)).astype(np.float32)
    want = _np(jmark(jp.to_tensor(x)))
    t = paddle.to_tensor(x)
    got = mark_sequence_parallel(t)
    assert got is t
    np.testing.assert_array_equal(got.numpy(), want)
