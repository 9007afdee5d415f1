"""The port's nn (Layer, the layers, nn.functional, the initializers,
state_dict / set_state_dict, functional_call and the attention entry
points) held to the JAX package's.

Each layer is built in both packages, the port's loaded from the JAX
layer's state dict by its structured names, and both run on the same
numpy inputs: outputs within 1e-5, and the gradients of the summed
output (every parameter's and the input's) within 1e-5. After the same
seed each initializer draws what the reference draws: uniform ones bit
for bit, normal ones within 1e-6. The attention entry points are in
tests/test_torch_nn_attention.py."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu._core import dtypes as jdt
from paddle_tpu_torch._core import dtypes as tdt
from paddle_tpu_torch._core import state as tstate

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = tstate._device
    tstate.set_device("cpu")
    yield
    tstate._device = prev


def _f(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _np(t):
    return np.asarray(t.numpy())


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [l for v in x for l in _leaves(v)]
    return [x]


def _run_layer(pt, make, inputs, train, seed, loaded=None):
    pt.seed(seed)
    layer = make(pt)
    if loaded is not None:
        missing, unexpected = layer.set_state_dict(loaded)
        assert not missing and not unexpected
    layer.train() if train else layer.eval()
    xs = [pt.to_tensor(a, stop_gradient=a.dtype != np.float32)
          for a in inputs]
    pt.seed(seed + 1)
    out = layer(*xs)
    leaves = [l for l in _leaves(out) if not l.stop_gradient]
    if leaves:
        total = leaves[0].sum()
        for l in leaves[1:]:
            total = total + l.sum()
        total.backward()
    grads = {n: None if p.grad is None else _np(p.grad)
             for n, p in layer.named_parameters()}
    in_grads = [None if x.stop_gradient or x.grad is None else _np(x.grad)
                for x in xs]
    bufs = {n: _np(b) for n, b in layer.named_buffers()}
    return layer, [_np(o) for o in _leaves(out)], grads, in_grads, bufs


def _check_layer(make, inputs, train=False, seed=0, tol=TOL):
    jl, jout, jg, jig, jb = _run_layer(jp, make, inputs, train, seed)
    sd = {k: _np(v) for k, v in jl.state_dict().items()}
    tl0 = make(tp)
    assert list(tl0.state_dict()) == list(sd)
    for k, v in tl0.state_dict().items():
        assert list(v.shape) == list(sd[k].shape), k
        assert tdt.dtype_name(v.dtype) == jdt.dtype_name(sd[k].dtype), k
    # load the JAX layer's values as they were before its forward
    jl2 = make(jp)
    sd0 = {k: _np(v) for k, v in jl2.state_dict().items()}
    jl, jout, jg, jig, jb = _run_layer(jp, make, inputs, train, seed,
                                       loaded=sd0)
    _, tout, tg, tig, tb = _run_layer(tp, make, inputs, train, seed,
                                      loaded=sd0)
    assert len(jout) == len(tout)
    for a, b in zip(jout, tout):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_allclose(b, a, **tol)
    assert jg.keys() == tg.keys()
    for k in jg:
        if jg[k] is None or tg[k] is None:
            assert jg[k] is None or not np.any(jg[k]), k
            assert tg[k] is None or not np.any(tg[k]), k
        else:
            np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **tol)
    for a, b in zip(jig, tig):
        if a is None or b is None:   # torch leaves an unused input's None
            assert a is None or not np.any(a)
            assert b is None or not np.any(b)
        else:
            np.testing.assert_allclose(b, a, **tol)
    for k in jb:
        np.testing.assert_allclose(tb[k], jb[k], err_msg=k, **tol)


X = _f(0, 4, 6)
X4 = _f(1, 2, 4, 5, 5)
IDS = np.random.RandomState(2).randint(0, 10, (3, 5)).astype(np.int64)
LAB = np.random.RandomState(3).randint(0, 6, (4,)).astype(np.int64)
SOFT = np.abs(_f(4, 4, 6))
SOFT = (SOFT / SOFT.sum(-1, keepdims=True)).astype(np.float32)
PROB = (1 / (1 + np.exp(-_f(5, 4, 6)))).astype(np.float32)
BIN = (np.random.RandomState(6).rand(4, 6) > 0.5).astype(np.float32)

LAYERS = {
    "linear": (lambda pt: pt.nn.Linear(6, 3), [X]),
    "linear_nobias": (lambda pt: pt.nn.Linear(6, 3, bias_attr=False), [X]),
    "bilinear": (lambda pt: pt.nn.Bilinear(6, 6, 2), [X, _f(7, 4, 6)]),
    "embedding": (lambda pt: pt.nn.Embedding(10, 4, padding_idx=2), [IDS]),
    "dropout_eval": (lambda pt: pt.nn.Dropout(0.3), [X]),
    "flatten": (lambda pt: pt.nn.Flatten(), [X4]),
    "layernorm": (lambda pt: pt.nn.LayerNorm(6), [X]),
    "rmsnorm": (lambda pt: pt.nn.RMSNorm(6, epsilon=1e-5), [X]),
    "groupnorm": (lambda pt: pt.nn.GroupNorm(2, 4), [X4]),
    "instancenorm": (lambda pt: pt.nn.InstanceNorm2D(4), [X4]),
    "batchnorm_eval": (lambda pt: pt.nn.BatchNorm1D(6), [X]),
    "localresponsenorm": (lambda pt: pt.nn.LocalResponseNorm(3), [X4]),
    "pad2d": (lambda pt: pt.nn.Pad2D([1, 2, 0, 1], value=0.5), [X4]),
    "pad2d_reflect": (lambda pt: pt.nn.Pad2D([1, 2, 2, 1], mode="reflect"),
                      [X4]),
    "pad2d_replicate": (lambda pt: pt.nn.Pad2D([1, 1, 2, 0],
                                               mode="replicate"), [X4]),
    "cosine_similarity": (lambda pt: pt.nn.CosineSimilarity(1),
                          [X, _f(8, 4, 6)]),
    "pairwise_distance": (lambda pt: pt.nn.PairwiseDistance(),
                          [X, _f(9, 4, 6)]),
    "unfold": (lambda pt: pt.nn.Unfold([2, 3], paddings=1), [X4]),
    "fold": (lambda pt: pt.nn.Fold([4, 5], [2, 2]), [_f(10, 2, 8, 12)]),
    "upsample_nearest": (lambda pt: pt.nn.Upsample(scale_factor=2), [X4]),
    "identity": (lambda pt: pt.nn.Identity(), [X]),
    "sequential": (lambda pt: pt.nn.Sequential(
        pt.nn.Linear(6, 8), pt.nn.GELU(), pt.nn.Linear(8, 2)), [X]),
    "prelu": (lambda pt: pt.nn.PReLU(), [X]),
    **{n.lower(): ((lambda n: lambda pt: getattr(pt.nn, n)())(n), [X])
       for n in ("ReLU", "ReLU6", "SiLU", "Swish", "Sigmoid", "LogSigmoid",
                 "Tanh", "Tanhshrink", "Softsign", "Mish", "Hardswish",
                 "ELU", "CELU", "SELU", "GELU", "Hardshrink", "Hardsigmoid",
                 "Hardtanh", "LeakyReLU", "Softplus", "Softshrink",
                 "ThresholdedReLU", "Softmax", "LogSoftmax", "GLU")},
    "gelu_tanh": (lambda pt: pt.nn.GELU(approximate=True), [X]),
    "maxout": (lambda pt: pt.nn.Maxout(2), [X4]),
    # losses
    "ce": (lambda pt: pt.nn.CrossEntropyLoss(), [X, LAB]),
    "ce_ignore_sum": (lambda pt: pt.nn.CrossEntropyLoss(
        ignore_index=1, reduction="sum"), [X, LAB]),
    "ce_none_smooth": (lambda pt: pt.nn.CrossEntropyLoss(
        reduction="none", label_smoothing=0.1), [X, LAB]),
    "ce_soft": (lambda pt: pt.nn.CrossEntropyLoss(soft_label=True),
                [X, SOFT]),
    "ce_label_dim": (lambda pt: pt.nn.CrossEntropyLoss(), [X, LAB[:, None]]),
    "mse": (lambda pt: pt.nn.MSELoss(), [X, SOFT]),
    "l1_sum": (lambda pt: pt.nn.L1Loss("sum"), [X, SOFT]),
    "smooth_l1": (lambda pt: pt.nn.SmoothL1Loss(delta=0.5), [X, SOFT]),
    "huber": (lambda pt: pt.nn.HuberLoss(delta=0.5), [X, SOFT]),
    "nll": (lambda pt: pt.nn.NLLLoss(ignore_index=2), [X, LAB]),
    "bce": (lambda pt: pt.nn.BCELoss(), [PROB, BIN]),
    "bce_logits": (lambda pt: pt.nn.BCEWithLogitsLoss(), [X, BIN]),
    "kldiv": (lambda pt: pt.nn.KLDivLoss("batchmean"), [X, SOFT]),
    "margin_ranking": (lambda pt: pt.nn.MarginRankingLoss(0.1),
                       [X, SOFT, np.sign(_f(11, 4, 6))]),
    "hinge_embedding": (lambda pt: pt.nn.HingeEmbeddingLoss(),
                        [X, np.sign(_f(12, 4, 6))]),
    "cosine_embedding": (lambda pt: pt.nn.CosineEmbeddingLoss(0.1),
                         [X, SOFT, np.sign(_f(13, 4))]),
    "triplet_margin": (lambda pt: pt.nn.TripletMarginLoss(),
                       [X, SOFT, PROB]),
    "multilabel_soft_margin": (lambda pt: pt.nn.MultiLabelSoftMarginLoss(),
                               [X, BIN]),
    "soft_margin": (lambda pt: pt.nn.SoftMarginLoss(),
                    [X, np.sign(_f(14, 4, 6))]),
    "multi_margin": (lambda pt: pt.nn.MultiMarginLoss(), [X, LAB]),
    "poisson_nll": (lambda pt: pt.nn.PoissonNLLLoss(), [X, PROB]),
    "gaussian_nll": (lambda pt: pt.nn.GaussianNLLLoss(), [X, SOFT, PROB]),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_jax(case):
    make, inputs = LAYERS[case]
    _check_layer(make, inputs)


def test_batchnorm_train_updates_running_stats_as_jax():
    _check_layer(lambda pt: pt.nn.BatchNorm2D(4), [X4], train=True)


@pytest.mark.parametrize("p", [0.3, 0.5])
def test_dropout_draws_the_reference_mask(p):
    """Training-mode dropout after the same seed keeps the same elements
    (the keep mask is the reference's bernoulli, bit for bit)."""
    _check_layer(lambda pt: pt.nn.Dropout(p), [X], train=True, seed=11)
    outs = []
    for pt in (jp, tp):
        pt.seed(3)
        x = pt.to_tensor(X)
        outs.append(_np(pt.nn.functional.dropout(x, p, axis=1)))
    np.testing.assert_array_equal(outs[1], outs[0])


INITS = {
    "constant": lambda pt: pt.nn.initializer.Constant(0.5),
    "normal": lambda pt: pt.nn.initializer.Normal(0.1, 0.02),
    "truncated_normal": lambda pt: pt.nn.initializer.TruncatedNormal(
        0.0, 0.5),
    "uniform": lambda pt: pt.nn.initializer.Uniform(-0.3, 0.7),
    "xavier_normal": lambda pt: pt.nn.initializer.XavierNormal(),
    "xavier_uniform": lambda pt: pt.nn.initializer.XavierUniform(),
    "kaiming_normal": lambda pt: pt.nn.initializer.KaimingNormal(),
    "kaiming_uniform": lambda pt: pt.nn.initializer.KaimingUniform(),
    "assign": lambda pt: pt.nn.initializer.Assign(
        np.arange(24, dtype=np.float32)),
    "dirac": lambda pt: pt.nn.initializer.Dirac(),
    "bilinear": lambda pt: pt.nn.initializer.Bilinear(),
}
UNIFORM_INITS = ("constant", "uniform", "xavier_uniform", "kaiming_uniform",
                 "assign", "dirac", "bilinear")


@pytest.mark.parametrize("name", sorted(INITS))
@pytest.mark.parametrize("seed", [0, 7])
def test_initializer_draws_match_jax(name, seed):
    shape = (3, 2, 2, 2) if name == "bilinear" else \
        (2, 3, 4) if name == "dirac" else (4, 6)
    if name == "bilinear":
        shape = (4, 4, 2, 2)
    outs = []
    for pt in (jp, tp):
        pt.seed(seed)
        init = INITS[name](pt)
        a = init._generate(shape, "float32")
        b = init._generate(shape, "float32")
        outs.append([np.asarray(a), np.asarray(b.cpu() if
                                               hasattr(b, "cpu") else b)])
    for r, g in zip(*outs):
        if name in UNIFORM_INITS:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)


def test_orthogonal_is_orthogonal():
    tp.seed(0)
    w = tp.nn.initializer.Orthogonal(gain=2.0)._generate((6, 4), "float32")
    q = w.reshape(6, 4).numpy() / 2.0
    np.testing.assert_allclose(q.T @ q, np.eye(4), atol=1e-5)


def test_parameters_of_a_layer_follow_the_key_stream():
    """Layers built after the same seed hold the reference's values."""
    jp.seed(4)
    tp.seed(4)
    jl = jp.nn.Sequential(jp.nn.Linear(5, 7), jp.nn.Embedding(9, 3))
    tl = tp.nn.Sequential(tp.nn.Linear(5, 7), tp.nn.Embedding(9, 3))
    for (jk, jv), (tk, tv) in zip(jl.state_dict().items(),
                                  tl.state_dict().items()):
        assert jk == tk
        np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=1e-6,
                                   atol=1e-6)


def test_set_state_dict_keeps_leaves_and_refuses_shapes():
    lin = tp.nn.Linear(3, 2)
    leaf = lin.weight._value
    opt = tp.optimizer.SGD(0.1, parameters=lin.parameters())
    lin.set_state_dict({"weight": np.ones((3, 2), np.float32),
                        "bias": np.zeros(2, np.float32)})
    assert lin.weight._value is leaf
    lin(tp.to_tensor(np.ones((1, 3), np.float32))).sum().backward()
    opt.step()
    np.testing.assert_allclose(lin.weight.numpy(), 0.9, atol=1e-7)
    with pytest.raises(ValueError, match="shape mismatch"):
        lin.set_state_dict({"weight": np.ones((2, 3), np.float32)})
    missing, unexpected = lin.set_state_dict({"nope": np.ones(1)})
    assert missing == ["weight", "bias"] and unexpected == ["nope"]


def test_functional_call_and_swapped_state_match_jax():
    outs = []
    for pt in (jp, tp):
        pt.seed(2)
        net = pt.nn.Sequential(pt.nn.Linear(6, 4), pt.nn.Tanh(),
                               pt.nn.Linear(4, 2))
        params, buffers = net.functional_state()
        assert list(params) == ["0.weight", "0.bias", "2.weight", "2.bias"]
        new = {k: v * 0.5 for k, v in params.items()}
        out = net.functional_call(new, buffers, pt.to_tensor(X))
        with net._swapped_state(new):
            swapped = net(pt.to_tensor(X))
        own = net(pt.to_tensor(X))
        if pt is tp:
            out = out.detach()
        outs.append([np.asarray(out), _np(swapped), _np(own)])
    for r, g in zip(*outs):
        np.testing.assert_allclose(g, r, **TOL)


def test_functional_call_is_differentiable_in_raw_params():
    tp.seed(2)
    net = tp.nn.Linear(6, 2)
    params, _ = net.functional_state()
    w = params["weight"].detach().clone().requires_grad_(True)
    out = net.functional_call({"weight": w}, {}, tp.to_tensor(X))
    out.sum().backward()
    np.testing.assert_allclose(w.grad.numpy(),
                               np.repeat(X.sum(0)[:, None], 2, 1), atol=1e-5)
    assert net.weight.grad is None


def test_layer_dtype_hooks_and_modes():
    net = tp.nn.Sequential(tp.nn.Linear(4, 4), tp.nn.Dropout(0.5))
    leaf = net[0].weight._value
    net.bfloat16()
    assert net[0].weight.dtype == tp.bfloat16 and net[0].weight._value is leaf
    net.float()
    seen = []
    h = net.register_forward_post_hook(lambda l, i, o: seen.append(o.shape))
    net.eval()
    assert not net[1].training
    net(tp.to_tensor(np.ones((2, 4), np.float32)))
    h.remove()
    net(tp.to_tensor(np.ones((2, 4), np.float32)))
    assert seen == [[2, 4]]
    net.train()
    assert net[1].training
    net.clear_gradients()


def test_containers_match_jax_names():
    for pt in (jp, tp):
        pt.seed(0)
    j = jp.nn.LayerDict({"a": jp.nn.Linear(2, 2),
                         "b": jp.nn.LayerList([jp.nn.Linear(2, 3)])})
    t = tp.nn.LayerDict({"a": tp.nn.Linear(2, 2),
                         "b": tp.nn.LayerList([tp.nn.Linear(2, 3)])})
    assert list(j.state_dict()) == list(t.state_dict())
    t["b"].append(tp.nn.Linear(3, 1))
    assert len(t["b"]) == 2 and "b.1.weight" in t.state_dict()
