"""paddle_tpu_torch's parallel `Trainer` held to the JAX package's
`paddle_tpu.parallel.Trainer` on the same mesh shapes.

Both packages start from the JAX model's weights (the port's through
`set_state_dict`) and take 3 steps on the same batch. The JAX side runs
on conftest's CPU devices, the port's as 2 gloo ranks spawned once
(`tests/_torch_ranks.trainer_cases`):

  * the tiny Layer-tree Llama on tp 2 (AdamW + clip 1.0; Lamb and
    LarsMomentum, whose trust ratios take whole-tensor norms; a
    TrainingHealthMonitor with a StepDecay schedule; an eager loop on
    the placed layers, whose clip and Lamb step sum their norms over
    the ranks) and on dp 2 through DataParallel;
  * an MLP on dp 2 plain and with ZeRO stages 1, 2 and 3 (the slots,
    and for stage 3 the parameters, sliced over dp);
  * the refusals: a mesh lacking an axis a dist_spec names (both
    packages raise ValueError), and the port's own limits (tp not
    dividing the KV heads or the vocabulary).

Losses agree within JAX's own 1e-5 (tests/test_distributed.py) and
parameters after the steps within the tolerances of
tests/test_torch_train_parallel.py (2.5 lr per step elementwise, 1e-5
in relative norm). The dp mean under uneven ignore_index labels is a
named divergence (ROADMAP.md Queue 3): the port's loss is the mean of
the ranks' means; the test measures its distance from JAX's global
mean."""
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

import paddle_tpu as jp
import _torch_ranks as R
from paddle_tpu.models.llama import LlamaConfig as JC
from paddle_tpu.models.llama import LlamaForCausalLM as JL
from paddle_tpu.parallel import Trainer as JTrainer
from paddle_tpu_torch.distributed import launch

STEPS = 3
LR = 1e-3
LOSS_RTOL = 1e-5
PARAM_ATOL = 2.5 * LR
DEADLINE_S = 240
DIMS = {}                        # LlamaConfig.tiny(): 2 layers, 4 / 2 heads
MLP = (32, 64, 16)               # both weights >= fsdp_spec's 1024 elements


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch._core import state as tstate
    prev = tstate._device
    tstate.set_device("cpu")
    yield
    tstate._device = prev


def _np(t):
    return np.asarray(t.numpy())


def _llama_batch(uneven=False):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (4, 16))
    y = rng.integers(0, 256, (4, 16))
    if uneven:                   # rows 0-1 (rank 0) lose 14 labels
        y[0, :12] = -100
        y[1, :2] = -100
    return x, y


def _mlp_batch():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((8, MLP[0])).astype(np.float32),
            rng.integers(0, MLP[2], (8,)))


def _jax_model(kind, dims=DIMS):
    jp.seed(0)
    if kind == "llama":
        return JL(JC.tiny(**dims))
    return jp.nn.Sequential(jp.nn.Linear(MLP[0], MLP[1]), jp.nn.Tanh(),
                            jp.nn.Linear(MLP[1], MLP[2]))


def _jax_loss(kind):
    if kind == "llama":
        return lambda m, b: m(b[0], labels=b[1])[0]
    return lambda m, b: jp.nn.functional.cross_entropy(m(b[0]), b[1])


def _jax_opt(spec, params):
    kind, kw = spec[0], dict(spec[1])
    lr = kw.pop("lr")
    if isinstance(lr, dict):
        lr = jp.optimizer.lr.StepDecay(**lr)
    return getattr(jp.optimizer, kind)(lr, parameters=params, **kw)


def _case(model, axes, opt=("AdamW", {"lr": LR}), steps=STEPS, **kw):
    return dict(model=model, axes=axes, opt=opt, steps=steps, dims=(
        DIMS if model == "llama" else MLP), **kw)


DP = (("dp",), ("dp",))
CASES = {
    "llama_tp2": _case("llama", {"tp": 2}, clip=1.0),
    "llama_dp2": _case("llama", {"dp": 2, "tp": 1}, clip=1.0,
                       batch_spec=DP, wrap=True),
    "llama_tp2_lamb": _case("llama", {"tp": 2}, clip=1.0,
                            opt=("Lamb", {"lr": LR})),
    "llama_tp2_lars": _case("llama", {"tp": 2},
                            opt=("LarsMomentum", {"lr": 0.1})),
    "llama_tp2_health_sched": _case(
        "llama", {"tp": 2}, clip=0.5, health=True,
        opt=("AdamW", {"lr": {"learning_rate": LR, "step_size": 2,
                              "gamma": 0.5}})),
    "llama_tp2_eager_lamb_clip": _case("llama", {"tp": 2}, clip=0.5,
                                       eager=True, opt=("Lamb", {"lr": LR})),
    "mlp_dp2": _case("mlp", {"dp": 2}, batch_spec=DP,
                     opt=("SGD", {"lr": 0.1})),
    "mlp_zero1": _case("mlp", {"dp": 2}, batch_spec=DP, stage=1, clip=1.0),
    "mlp_zero2": _case("mlp", {"dp": 2}, batch_spec=DP, level="os_g",
                       clip=1.0),
    "mlp_zero3": _case("mlp", {"dp": 2}, batch_spec=DP, level="p_g_os",
                       clip=1.0),
    "mlp_zero3_lamb": _case("mlp", {"dp": 2}, batch_spec=DP, stage=3,
                            opt=("Lamb", {"lr": LR})),
}
UNEVEN = _case("llama", {"dp": 2, "tp": 1}, batch_spec=DP, steps=1)
REFUSALS = {"dp_mesh_lacks_tp": {"axes": {"dp": 2}}}
PORT_LIMITS = {
    "tp2_one_kv_head": ({"axes": {"tp": 2}, "dims": {"kv_heads": 1}},
                        "ValueError", "KV heads (1) do not divide"),
    "tp2_odd_vocab": ({"axes": {"tp": 2}, "dims": {"vocab": 255}},
                      "ValueError", "does not divide over tp=2"),
}


def _jax_mesh(axes):
    return Mesh(np.asarray(jax.devices()[:2]).reshape(tuple(axes.values())),
                tuple(axes))


def _jax_eager(case, batch):
    """The eager loop one process runs: backward, then the optimizer's
    step with its own global-norm clip."""
    model = _jax_model(case["model"])
    kind, kw = case["opt"][0], dict(case["opt"][1])
    lr = kw.pop("lr")
    opt = getattr(jp.optimizer, kind)(
        lr, parameters=model.parameters(),
        grad_clip=jp.nn.ClipGradByGlobalNorm(case["clip"]), **kw)
    losses = []
    for _ in range(case["steps"]):
        loss = _jax_loss(case["model"])(model, tuple(jp.to_tensor(a)
                                                     for a in batch))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return {"losses": losses,
            "params": {k: _np(v) for k, v in model.state_dict().items()}}


def _jax_run(case, batch):
    if case.get("eager"):
        return _jax_eager(case, batch)
    model = _jax_model(case["model"])
    opt = _jax_opt(case["opt"], model.parameters())
    stage = case.get("stage") or {"os_g": 2, "p_g_os": 3}.get(
        case.get("level"), 0)
    bs = case.get("batch_spec")
    monitor = None
    if case.get("health"):
        from paddle_tpu.observability.health import TrainingHealthMonitor
        monitor = TrainingHealthMonitor()
    tr = JTrainer(model, opt, _jax_loss(case["model"]),
                  mesh=_jax_mesh(case["axes"]),
                  batch_spec=None if bs is None else tuple(JP(*s)
                                                           for s in bs),
                  sharding_stage=stage, grad_clip_norm=case.get("clip"),
                  health_monitor=monitor)
    losses, lrs, health = [], [], []
    for _ in range(case["steps"]):
        lrs.append(opt.get_lr())
        losses.append(float(tr.step(batch)))
        if monitor is not None:
            health.append(dict(monitor.last))
    tr.sync_model()
    return {"losses": losses, "lrs": lrs, "health": health,
            "params": {k: _np(v) for k, v in model.state_dict().items()},
            "state_specs": {n: {k: [str(e) for e in s] for k, s in d.items()}
                            for n, d in tr.state_specs.items()}}


def _jax_refusal(case):
    try:
        model = _jax_model("llama", case.get("dims", DIMS))
        opt = jp.optimizer.AdamW(LR, parameters=model.parameters())
        JTrainer(model, opt, _jax_loss("llama"),
                 mesh=_jax_mesh(case["axes"])).step(_llama_batch())
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def _sd(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


def _port_case(case, batch):
    return dict(case, sd=_sd(_jax_model(case["model"])), batch=batch)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("store"))
    batches = {"llama": _llama_batch(), "mlp": _mlp_batch()}
    cases = {n: _port_case(c, batches[c["model"]]) for n, c in CASES.items()}
    cases["uneven"] = _port_case(UNEVEN, _llama_batch(uneven=True))
    for name, c in dict(REFUSALS, **{k: v for k, (v, _, _) in
                                     PORT_LIMITS.items()}).items():
        dims = c.get("dims", DIMS)
        cases[name] = dict(c, refusal=True, dims=dims,
                           sd=_sd(_jax_model("llama", dims)),
                           batch=_llama_batch())
    with ThreadPoolExecutor(1) as pool:
        # the ranks run while the JAX side compiles
        fut = pool.submit(launch.spawn, R.trainer_cases, 2, "gloo", "cpu",
                          DEADLINE_S, args=({"cases": cases},), threads=1,
                          store_dir=store)
        jax_out = {n: _jax_run(c, batches[c["model"]])
                   for n, c in CASES.items()}
        jax_out.update({n: _jax_refusal(c) for n, c in REFUSALS.items()})
        port = fut.result()[0]
    return {"jax": jax_out, "port": port}


def _params_close(got, want):
    assert set(got) == set(want)
    for k, a in want.items():
        b = got[k]
        np.testing.assert_allclose(b, a, atol=PARAM_ATOL, rtol=0, err_msg=k)
        assert np.linalg.norm(b - a) <= 1e-5 * np.linalg.norm(a) + 1e-7, k


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax(results, name):
    want, got = results["jax"][name], results["port"][name]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_params_after_steps_match_jax(results, name):
    _params_close(results["port"][name]["params"],
                  results["jax"][name]["params"])


def test_lr_scheduler_steps_after_each_step(results):
    name = "llama_tp2_health_sched"
    assert results["port"][name]["lrs"] == results["jax"][name]["lrs"]
    assert results["port"][name]["lrs"] == [LR, LR, LR / 2]


def test_health_monitor_matches_jax(results):
    """loss, grad norm (after the clip's scale: the clipped gradients)
    and update ratio: whole-tensor norms from the ranks' blocks."""
    name = "llama_tp2_health_sched"
    want, got = results["jax"][name]["health"], \
        results["port"][name]["health"]
    assert len(got) == STEPS
    for w, g in zip(want, got):
        assert g["nonfinite"] == w["nonfinite"] == 0
        assert g["step"] == w["step"]
        for k in ("loss", "grad_norm", "update_ratio"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", ["mlp_zero1", "mlp_zero2", "mlp_zero3"])
def test_zero_slot_specs_match_jax(results, name):
    """The slots of the replicated weights are sliced over dp as JAX's
    (fsdp_spec); the biases (under its 1024 elements) stay whole; each
    rank holds its half of a sliced slot."""
    want = results["jax"][name]["state_specs"]
    got = results["port"][name]["state_specs"]
    assert got == want
    shapes = results["port"][name]["slot_shapes"]
    sliced = [n for n, d in want.items() if "dp" in d["moment1"]]
    assert len(sliced) == 2
    for n in sliced:
        dim = want[n]["moment1"].index("dp")
        full = results["jax"][name]["params"][n].shape
        assert shapes[n]["moment1"][dim] * 2 == full[dim]


def test_zero_stages_equal_plain_dp(results):
    """Every stage is plain dp's arithmetic (AdamW and the clip on the
    same gradients), to rounding."""
    base = results["port"]["mlp_zero1"]
    for name in ("mlp_zero2", "mlp_zero3"):
        got = results["port"][name]
        np.testing.assert_allclose(got["losses"], base["losses"], rtol=1e-6)
        for k, v in base["params"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=1e-6,
                                       err_msg=f"{name} {k}")


def test_uneven_labels_dp_mean_divergence(results):
    """Named divergence (ROADMAP.md Queue 3): under dp the port's loss is
    the mean of the ranks' means (Paddle's DataParallel); JAX's Trainer
    takes the global mean. With 14 of rank 0's 32 labels ignored the
    two differ by this much, and the port's equals the mean of JAX's
    losses of the two halves."""
    x, y = _llama_batch(uneven=True)
    model = _jax_model("llama")
    halves = [float(model(x[i:i + 2], labels=y[i:i + 2])[0])
              for i in (0, 2)]
    whole = float(model(x, labels=y)[0])
    got = results["port"]["uneven"]["losses"][0]
    np.testing.assert_allclose(got, np.mean(halves), rtol=LOSS_RTOL)
    gap = abs(got - whole)
    assert gap > 1e-4, gap          # measured: a few 1e-3 here
    print(f"dp mean of means {got:.6f} vs global mean {whole:.6f}: "
          f"gap {gap:.3e}")


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_jax(results, name):
    want, got = results["jax"][name], results["port"][name]
    assert want is not None and got is not None
    assert got[0] == want[0] == "ValueError"
    assert "tp" in got[1] and "not found in mesh" in got[1], got
    assert "not found in mesh" in want[1], want


@pytest.mark.parametrize("name", list(PORT_LIMITS))
def test_port_limits_raise(results, name):
    _, cls, words = PORT_LIMITS[name]
    got = results["port"][name]
    assert got is not None and got[0] == cls and words in got[1], got


# ------------------------------------------------ one process, no mesh
def _port_llama():
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM(LlamaConfig.tiny())
    model.set_state_dict(_sd(_jax_model("llama")))
    return model


def test_no_mesh_matches_jax():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.parallel import Trainer
    batch = _llama_batch()
    model = _jax_model("llama")
    jtr = JTrainer(model, jp.optimizer.AdamW(LR, parameters=model.
                                             parameters()),
                   _jax_loss("llama"), grad_clip_norm=1.0)
    want = [float(jtr.step(batch)) for _ in range(STEPS)]
    tm = _port_llama()
    tr = Trainer(tm, paddle.optimizer.AdamW(LR, parameters=tm.parameters()),
                 R.llama_loss, grad_clip_norm=1.0)
    got = [float(tr.step(batch)) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    jtr.sync_model()
    _params_close({k: v.numpy() for k, v in tm.state_dict().items()},
                  {k: _np(v) for k, v in model.state_dict().items()})


def test_step_key_is_jax_key():
    """Each step draws from fold_in(key(base_seed), step): a loss that
    adds a uniform draw gets the JAX Trainer's draws."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.parallel import Trainer

    def jloss(m, b):
        return (m(b[0]) ** 2).mean() + jp.rand([3]).sum()

    def tloss(m, b):
        return (m(b[0]) ** 2).mean() + paddle.rand([3]).sum()
    batch = _mlp_batch()
    jm = _jax_model("mlp")
    jtr = JTrainer(jm, jp.optimizer.SGD(0.0, parameters=jm.parameters()),
                   jloss, base_seed=77)
    want = [float(jtr.step(batch)) for _ in range(3)]
    tm = R._mlp(MLP, _sd(_jax_model("mlp")))
    tr = Trainer(tm, paddle.optimizer.SGD(0.0, parameters=tm.parameters()),
                 tloss, base_seed=77)
    got = [float(tr.step(batch)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(set(got)) == 3


def test_sync_model_writes_the_trained_params():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.parallel import Trainer
    tm = R._mlp(MLP, _sd(_jax_model("mlp")))
    before = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    tr = Trainer(tm, paddle.optimizer.SGD(0.1, parameters=tm.parameters()),
                 R.mlp_loss, donate=False)
    tr.step(_mlp_batch())
    unchanged = {k: v.numpy() for k, v in tm.state_dict().items()}
    for k in before:
        np.testing.assert_array_equal(unchanged[k], before[k])
    tr.sync_model()
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), tr.params[k].numpy())
        assert not np.array_equal(v.numpy(), before[k])


def test_compile_telemetry_counts_batch_signatures():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.observability import compile_telemetry as ct
    from paddle_tpu_torch.parallel import Trainer
    ct.REGISTRY.reset()
    tm = R._mlp(MLP, _sd(_jax_model("mlp")))
    tr = Trainer(tm, paddle.optimizer.SGD(0.1, parameters=tm.parameters()),
                 R.mlp_loss)
    x, y = _mlp_batch()
    for _ in range(3):
        tr.step((x, y))
    snap = ct.snapshot()["parallel.train_step"]
    assert snap["calls"] == 3 and snap["distinct_signatures"] == 1
    tr.step((x[:4], y[:4]))
    snap = ct.snapshot()["parallel.train_step"]
    assert snap["calls"] == 4 and snap["distinct_signatures"] == 2


def test_health_stats_and_monitor_match_jax():
    """One process: the fused stats of the same trees, and a non-finite
    step counted, recorded and (abort=True) raised."""
    import jax.numpy as jnp
    import torch
    from paddle_tpu.observability import health as JH
    from paddle_tpu_torch.observability import health as H
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}
    new = {k: v + 0.01 for k, v in tree.items()}
    grads = {"a": tree["a"] * 2, "b": np.array([1, np.nan, np.inf, 0, 0,
                                                0, 0], np.float32)}
    want = JH.health_stats(jnp.float32(1.5), {k: jnp.asarray(v) for k, v
                                              in grads.items()},
                           {k: jnp.asarray(v) for k, v in tree.items()},
                           {k: jnp.asarray(v) for k, v in new.items()})
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    got = H.health_stats(torch.tensor(1.5), t(grads), t(tree), t(new))
    assert int(got["nonfinite"]) == int(want["nonfinite"]) == 2
    np.testing.assert_allclose(float(got["update_ratio"]),
                               float(want["update_ratio"]), rtol=1e-5)
    assert not np.isfinite(float(got["grad_norm"]))
    assert H.nonfinite_report(t(grads), names=["a", "b"]) == \
        JH.nonfinite_report({k: jnp.asarray(v) for k, v in grads.items()},
                            names=["a", "b"]) == [("b", 2)]
    H.reset()
    mon = H.TrainingHealthMonitor(abort=True)
    with pytest.raises(FloatingPointError):
        mon.observe(got, step=4)
    snap = H.snapshot()
    assert snap["nonfinite_steps"] == 1 and snap["nonfinite_values"] == 2
    assert snap["last_loss"] == 1.5
    H.reset()
