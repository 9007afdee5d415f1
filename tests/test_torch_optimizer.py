"""The port's optimizers, clips, regularizers and LR schedulers held to the
JAX package's.

Every rule takes 5 steps from the same parameters on the same
gradients in both packages; parameters and slots agree within 1e-6
relative (plus 1e-7 absolute) at fp32. bf16 parameters with
multi_precision keep float32 masters that agree within 1e-6. Every
scheduler's 50-step sequence is equal, the functional
init_state / apply_gradients equals step(), and the state dicts load
across packages by name."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.nn.layer import layers as jlayers
from paddle_tpu_torch._core import state as tstate
from paddle_tpu_torch.nn.layer import layers as tlayers

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = [(4, 3), (3,), (2, 2, 2)]
STEPS = 5


@pytest.fixture(autouse=True)
def _cpu():
    prev = tstate._device
    tstate.set_device("cpu")
    yield
    tstate._device = prev


def _params(pt, dtype="float32"):
    rs = np.random.RandomState(0)
    out = []
    for i, s in enumerate(SHAPES):
        v = rs.randn(*s).astype(np.float32)
        out.append(pt.Parameter(pt.to_tensor(v, dtype=dtype)._value,
                                name=f"w{i}"))
    return out


def _grad(step, i, shape):
    rs = np.random.RandomState(100 + 10 * step + i)
    return (rs.randn(*shape) * 0.5).astype(np.float32)


def _np(v):
    return np.asarray(v.numpy() if hasattr(v, "numpy") else v)


RULES = {
    "SGD": lambda pt, ps: pt.optimizer.SGD(0.1, parameters=ps),
    "SGD_l2": lambda pt, ps: pt.optimizer.SGD(0.1, parameters=ps,
                                              weight_decay=0.01),
    "Momentum": lambda pt, ps: pt.optimizer.Momentum(0.1, 0.9,
                                                     parameters=ps),
    "Momentum_nesterov": lambda pt, ps: pt.optimizer.Momentum(
        0.1, 0.9, parameters=ps, use_nesterov=True),
    "Adam": lambda pt, ps: pt.optimizer.Adam(0.01, parameters=ps),
    "Adam_amsgrad": lambda pt, ps: pt.optimizer.Adam(0.01, parameters=ps,
                                                     amsgrad=True),
    "AdamW": lambda pt, ps: pt.optimizer.AdamW(0.01, parameters=ps,
                                               weight_decay=0.1),
    "Adamax": lambda pt, ps: pt.optimizer.Adamax(0.01, parameters=ps),
    "Adagrad": lambda pt, ps: pt.optimizer.Adagrad(
        0.1, parameters=ps, initial_accumulator_value=0.1),
    "Adadelta": lambda pt, ps: pt.optimizer.Adadelta(1.0, parameters=ps),
    "RMSProp": lambda pt, ps: pt.optimizer.RMSProp(0.01, parameters=ps,
                                                   momentum=0.5),
    "RMSProp_centered": lambda pt, ps: pt.optimizer.RMSProp(
        0.01, parameters=ps, centered=True),
    "Lamb": lambda pt, ps: pt.optimizer.Lamb(0.01, parameters=ps),
    "NAdam": lambda pt, ps: pt.optimizer.NAdam(0.01, parameters=ps),
    "RAdam": lambda pt, ps: pt.optimizer.RAdam(0.01, parameters=ps),
    "ASGD": lambda pt, ps: pt.optimizer.ASGD(0.1, batch_num=2,
                                             parameters=ps),
    "Rprop": lambda pt, ps: pt.optimizer.Rprop(0.01, parameters=ps),
    "Lion": lambda pt, ps: pt.optimizer.Lion(0.01, parameters=ps,
                                             weight_decay=0.1),
    "LarsMomentum": lambda pt, ps: pt.optimizer.LarsMomentum(
        0.1, parameters=ps),
    "AdamW_clip_global": lambda pt, ps: pt.optimizer.AdamW(
        0.01, parameters=ps,
        grad_clip=pt.nn.ClipGradByGlobalNorm(0.5)),
    "SGD_clip_norm": lambda pt, ps: pt.optimizer.SGD(
        0.1, parameters=ps, grad_clip=pt.nn.ClipGradByNorm(0.3)),
    "Momentum_clip_value": lambda pt, ps: pt.optimizer.Momentum(
        0.1, parameters=ps, grad_clip=pt.nn.ClipGradByValue(0.2)),
    "SGD_l1": lambda pt, ps: pt.optimizer.SGD(
        0.1, parameters=ps, weight_decay=pt.regularizer.L1Decay(0.05)),
    "Adam_l2": lambda pt, ps: pt.optimizer.Adam(
        0.01, parameters=ps, weight_decay=pt.regularizer.L2Decay(0.05)),
    "AdamW_lr_ratio": lambda pt, ps: pt.optimizer.AdamW(
        0.01, parameters=ps, lr_ratio=lambda p: 0.5,
        apply_decay_param_fun=lambda n: n != "w1"),
}


def _run(pt, make, steps=STEPS, dtype="float32"):
    ps = _params(pt, dtype)
    opt = make(pt, ps)
    for s in range(steps):
        for i, p in enumerate(ps):
            p.grad = pt.to_tensor(_grad(s, i, SHAPES[i]), dtype=dtype)
        opt.step()
        opt.clear_grad()
    return ps, opt


def _slots(pt, opt, ps):
    sd = opt.state_dict()
    return {k: _np(v).astype(np.float32) for k, v in sd.items()
            if k not in ("@global_step", "LR_Scheduler")}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_jax(rule):
    jps, jopt = _run(jp, RULES[rule])
    tps, topt = _run(tp, RULES[rule])
    for a, b in zip(jps, tps):
        np.testing.assert_allclose(b.numpy(), _np(a), err_msg=rule, **TOL)
    js, ts = _slots(jp, jopt, jps), _slots(tp, topt, tps)
    assert js.keys() == ts.keys()
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], err_msg=k, **TOL)


def test_lbfgs_matches_jax():
    outs = []
    for pt in (jp, tp):
        ps = _params(pt)
        opt = pt.optimizer.LBFGS(0.5, parameters=ps, history_size=3)
        c = [pt.to_tensor(_grad(9, i, s)) for i, s in enumerate(SHAPES)]

        def closure():
            opt.clear_grad()
            loss = sum(((p - ci) ** 2).sum() for p, ci in zip(ps, c))
            loss.backward()
            return loss
        losses = [float(opt.step(closure)) for _ in range(4)]
        outs.append((losses, [_np(p) for p in ps]))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-6)
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rule", ["Adam", "AdamW", "Momentum", "Lamb"])
def test_bf16_multi_precision_masters_match_jax(rule):
    def make(pt, ps):
        opt = RULES[rule](pt, ps)
        opt._multi_precision = True
        return opt
    jps, jopt = _run(jp, make, dtype="bfloat16")
    tps, topt = _run(tp, make, dtype="bfloat16")
    for a, b in zip(jps, tps):
        ja = jopt._accumulators[id(a)]
        ta = topt._accumulators[id(b)]
        np.testing.assert_allclose(ta["master"].numpy(),
                                   np.asarray(ja["master"]), **TOL)
        assert b.dtype == tp.bfloat16
        np.testing.assert_allclose(b.numpy().astype(np.float32),
                                   _np(a).astype(np.float32),
                                   rtol=1e-2, atol=1e-2)
        np.testing.assert_array_equal(
            b._value.detach().float().numpy(),
            ta["master"].to(b._value.dtype).float().numpy())


def test_init_state_and_apply_gradients_equal_step():
    ps = _params(tp)
    opt = tp.optimizer.AdamW(0.01, parameters=ps, weight_decay=0.1)
    raw = {f"w{i}": p._value.detach().clone() for i, p in enumerate(ps)}
    state = opt.init_state(raw)
    before = {k: v.clone() for k, v in raw.items()}
    for s in range(3):
        grads = {f"w{i}": tp.to_tensor(_grad(s, i, sh))._value
                 for i, sh in enumerate(SHAPES)}
        raw, state = opt.apply_gradients(raw, grads, state)
        for i, p in enumerate(ps):
            p.grad = tp.Tensor(grads[f"w{i}"])
        opt.step()
    for i, p in enumerate(ps):
        np.testing.assert_array_equal(raw[f"w{i}"].numpy(), p.numpy())
        np.testing.assert_array_equal(
            state[f"w{i}"]["moment1"].numpy(),
            opt._accumulators[id(p)]["moment1"].numpy())
    assert not any(np.array_equal(before[k].numpy(), raw[k].numpy())
                   for k in raw)


def test_apply_gradients_matches_jax():
    import jax.numpy as jnp
    outs = []
    for pt, arr in ((jp, jnp.asarray), (tp, lambda a: tp.to_tensor(a)._value)):
        opt = pt.optimizer.Adam(0.01)
        params = [arr(np.ones(s, np.float32)) for s in SHAPES]
        state = opt.init_state(params)
        for s in range(3):
            grads = [arr(_grad(s, i, sh)) for i, sh in enumerate(SHAPES)]
            params, state = opt.apply_gradients(params, grads, state)
        outs.append([np.asarray(p) for p in params])
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, **TOL)


def test_state_dict_round_trip_and_loads_jax_state():
    jlayers._name_counter.clear()
    tlayers._name_counter.clear()
    jp.seed(1)
    tp.seed(1)
    jnet = jp.nn.Linear(3, 2)
    tnet = tp.nn.Linear(3, 2)
    tnet.set_state_dict({k: _np(v) for k, v in jnet.state_dict().items()})
    x = np.random.RandomState(2).randn(4, 3).astype(np.float32)
    sched = lambda pt: pt.optimizer.lr.StepDecay(0.01, 2)
    jopt = jp.optimizer.AdamW(sched(jp), parameters=jnet.parameters())
    topt = tp.optimizer.AdamW(sched(tp), parameters=tnet.parameters())
    for net, opt, pt in ((jnet, jopt, jp), (tnet, topt, tp)):
        for _ in range(2):
            net(pt.to_tensor(x)).sum().backward()
            opt.step()
            opt.clear_grad()
            opt._learning_rate.step()
    jsd = jopt.state_dict()
    assert list(jsd) == list(topt.state_dict())
    # a fresh port optimizer loads the JAX one's state by name
    fresh = tp.optimizer.AdamW(sched(tp), parameters=tnet.parameters())
    fresh.set_state_dict({k: (v if k in ("LR_Scheduler", "@global_step")
                              else _np(v)) for k, v in jsd.items()})
    for k, v in topt.state_dict().items():
        got = fresh.state_dict()[k]
        if k == "LR_Scheduler":
            assert got == v
        elif k == "@global_step":
            assert got == v == 2
        else:
            np.testing.assert_allclose(got.numpy(), v.numpy(), **TOL)
    # the round trip within the port continues identically
    again = tp.optimizer.AdamW(sched(tp), parameters=tnet.parameters())
    again.set_state_dict(topt.state_dict())
    snap = [p.numpy().copy() for p in tnet.parameters()]
    for opt in (topt, again):
        for p, s in zip(tnet.parameters(), snap):
            with tp.no_grad():
                p.set_value(s)
        tnet(tp.to_tensor(x)).sum().backward()
        opt.step()
        opt.clear_grad()
        if opt is topt:
            first = [p.numpy().copy() for p in tnet.parameters()]
    for a, b in zip(first, [p.numpy() for p in tnet.parameters()]):
        np.testing.assert_array_equal(a, b)


SCHEDULERS = {
    "NoamDecay": lambda lr: lr.NoamDecay(64, 10, 2.0),
    "PiecewiseDecay": lambda lr: lr.PiecewiseDecay([5, 20], [0.1, 0.05,
                                                             0.01]),
    "NaturalExpDecay": lambda lr: lr.NaturalExpDecay(0.1, 0.05),
    "InverseTimeDecay": lambda lr: lr.InverseTimeDecay(0.1, 0.05),
    "PolynomialDecay": lambda lr: lr.PolynomialDecay(0.1, 20, 0.001, 2.0),
    "PolynomialDecay_cycle": lambda lr: lr.PolynomialDecay(0.1, 7,
                                                           cycle=True),
    "LinearWarmup": lambda lr: lr.LinearWarmup(0.1, 10, 0.0, 0.1),
    "LinearWarmup_nested": lambda lr: lr.LinearWarmup(
        lr.CosineAnnealingDecay(0.1, 20), 5, 0.0, 0.1),
    "ExponentialDecay": lambda lr: lr.ExponentialDecay(0.1, 0.9),
    "MultiStepDecay": lambda lr: lr.MultiStepDecay(0.1, [10, 30]),
    "StepDecay": lambda lr: lr.StepDecay(0.1, 7, 0.5),
    "LambdaDecay": lambda lr: lr.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda lr: lr.MultiplicativeDecay(
        0.1, lambda e: 0.97),
    "CosineAnnealingDecay": lambda lr: lr.CosineAnnealingDecay(0.1, 15,
                                                               0.001),
    "CosineAnnealingWarmRestarts": lambda lr: lr.CosineAnnealingWarmRestarts(
        0.1, 5, 2),
    "LinearLR": lambda lr: lr.LinearLR(0.1, 20),
    "ConstantLR": lambda lr: lr.ConstantLR(0.1, 0.5, 10),
    "OneCycleLR": lambda lr: lr.OneCycleLR(0.1, 50),
    "OneCycleLR_linear": lambda lr: lr.OneCycleLR(0.1, 50,
                                                  anneal_strategy="linear"),
    "CyclicLR": lambda lr: lr.CyclicLR(0.01, 0.1, 6),
    "CyclicLR_triangular2": lambda lr: lr.CyclicLR(0.01, 0.1, 6, 4,
                                                   mode="triangular2"),
    "CosineAnnealingWithWarmupDecay": lambda lr:
        lr.CosineAnnealingWithWarmupDecay(0.1, 0.001, 5, 40),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_sequence_matches_jax(name):
    seqs = []
    for pt in (jp, tp):
        s = SCHEDULERS[name](pt.optimizer.lr)
        seq = []
        for _ in range(50):
            seq.append(s())
            s.step()
        seqs.append(seq)
    assert seqs[0] == seqs[1]


def test_reduce_on_plateau_matches_jax():
    seqs = []
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.5, 0.6, 0.7, 0.8, 0.9]
    for pt in (jp, tp):
        s = pt.optimizer.lr.ReduceOnPlateau(0.1, patience=2, cooldown=1)
        seq = []
        for m in metrics * 3:
            s.step(m)
            seq.append(s())
        seqs.append(seq)
    assert seqs[0] == seqs[1]


def test_scheduler_drives_the_optimizer():
    ps = _params(tp)
    sched = tp.optimizer.lr.LinearWarmup(0.1, 4, 0.0, 0.1)
    opt = tp.optimizer.SGD(sched, parameters=ps)
    lrs = []
    for _ in range(5):
        lrs.append(opt.get_lr())
        sched.step()
    assert lrs == pytest.approx([0.0, 0.025, 0.05, 0.075, 0.1], abs=1e-15)
    with pytest.raises(RuntimeError):
        opt.set_lr(0.5)
