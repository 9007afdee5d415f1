"""The port's Layer-tree LlamaForCausalLM held to the JAX package's, as
tests/test_models_llm.py trains it: LlamaConfig.tiny() (2 layers, 4
query / 2 KV heads), the port loaded from the JAX model's state dict by
its structured names. The logits agree within 1e-5; 3 AdamW steps
(loss.backward, step, clear_grad) give losses within 1e-5 and
parameters within 1e-5 (see the comment above that test for the
elements AdamW's first steps leave to rounding). On the CPU the port's
attention runs the flash kernels' plain versions, the JAX model its XLA
reference. Also the causality and GQA
shape checks, the kv_caches= options and their refusal, and the
README's opening snippet run as `import paddle_tpu_torch as paddle`."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch._core import state as tstate
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = tstate._device
    tstate.set_device("cpu")
    yield
    tstate._device = prev


def _ids(b, s, v, seed=0):
    return np.random.RandomState(seed).randint(0, v, (b, s)).astype(np.int64)


def _pair(**kw):
    jp.seed(0)
    jm = JaxLlama(JaxConfig.tiny(**kw))
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**kw))
    missing, unexpected = tm.set_state_dict(sd)
    assert not missing and not unexpected
    return jm, tm, sd


def test_state_dict_names_and_shapes_match_jax():
    jm, tm, sd = _pair()
    tsd = tm.state_dict()
    assert list(tsd) == list(sd)
    assert "llama.layers.0.self_attn.q_proj.weight" in tsd
    for k, v in tsd.items():
        assert tuple(v.shape) == sd[k].shape
        assert v.dtype == tp.float32


def test_logits_match_jax():
    jm, tm, _ = _pair()
    x = _ids(2, 16, 256)
    ref = np.asarray(jm(jp.to_tensor(x)).numpy())
    got = tm(tp.to_tensor(x)).numpy()
    assert got.shape == (2, 16, 256)
    np.testing.assert_allclose(got, ref, **TOL)


# AdamW moves an element by about lr * m / sqrt(v) whatever its gradient's
# size, so where a step-1 gradient is within rounding of zero (|g| < 1e-6;
# the two packages' gradients agree to 1e-7) the sign of that ratio is
# noise and the element may move by up to 2 lr a step differently: those
# elements are held to 2.5 lr per step, as chip_smoke's train_parity
# holds them; every other element to 1e-5, and each leaf to 1e-5 in
# relative norm
LR = 1e-3
STEPS = 3


def test_three_adamw_steps_match_jax():
    jm, tm, _ = _pair()
    x, y = _ids(2, 16, 256), _ids(2, 16, 256, seed=1)
    losses, first_grads = [], []
    for pt, m in ((jp, jm), (tp, tm)):
        opt = pt.optimizer.AdamW(LR, parameters=m.parameters())
        ls = []
        for i in range(STEPS):
            loss, _ = m(pt.to_tensor(x), labels=pt.to_tensor(y))
            loss.backward()
            if i == 0:
                first_grads.append({n: np.asarray(p.grad.numpy())
                                    for n, p in m.named_parameters()})
            opt.step()
            opt.clear_grad()
            ls.append(float(loss))
        losses.append(ls)
    np.testing.assert_allclose(losses[1], losses[0], **TOL)
    assert losses[1][-1] < losses[1][0]
    jg, tg = first_grads
    jsd = jm.state_dict()
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        got, ref = v.numpy(), np.asarray(jsd[k].numpy())
        allowed = 1e-5 + np.where(np.abs(jg[k]) < 1e-6, 2.5 * LR * STEPS,
                                  0.0)
        assert np.all(np.abs(got - ref) <= allowed), k
        assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref), k
        assert v.grad is None


def test_causality():
    cfg = LlamaConfig.tiny()
    tp.seed(0)
    model = LlamaForCausalLM(cfg)
    model.eval()
    x = _ids(1, 16, cfg.vocab_size)
    full = model(tp.to_tensor(x)).numpy()
    x2 = x.copy()
    x2[0, 8:] = 7  # change future tokens
    out2 = model(tp.to_tensor(x2)).numpy()
    np.testing.assert_allclose(full[0, :8], out2[0, :8], atol=1e-4)


def test_gqa_heads():
    cfg = LlamaConfig.tiny(heads=4, kv_heads=2)
    model = LlamaForCausalLM(cfg)
    assert model.llama.layers[0].self_attn.k_proj.weight.shape[1] == \
        cfg.hidden_size // 2


def test_parameters_follow_the_key_stream():
    """After the same seed the port draws the reference's weights."""
    jp.seed(3)
    tp.seed(3)
    jsd = JaxLlama(JaxConfig.tiny()).state_dict()
    tsd = LlamaForCausalLM(LlamaConfig.tiny()).state_dict()
    for k in jsd:
        np.testing.assert_allclose(tsd[k].numpy(), np.asarray(
            jsd[k].numpy()), rtol=1e-6, atol=1e-6, err_msg=k)


def test_kv_cache_and_generate_name_item_13():
    """The options item 13b part 1 ported: kv_caches= of no cache a layer
    is the plain forward, a one-token step over a cache runs (held to
    JAX's in tests/test_torch_models.py), generate runs the reference's
    eager loop; a causal step of more rows over a non-empty cache keeps
    its named refusal (ROADMAP.md Queue 3, causal alignment)."""
    tp.seed(0)
    model = LlamaForCausalLM(LlamaConfig.tiny())
    x = tp.to_tensor(_ids(1, 4, 256))
    np.testing.assert_array_equal(model(x, kv_caches=[None, None]).numpy(),
                                  model(x).numpy())
    cache = [(tp.zeros([1, 2, 3, 16]), tp.zeros([1, 2, 3, 16]))] * 2
    assert model(x[:, :1], position_offset=3,
                 kv_caches=cache).shape == [1, 1, 256]
    with pytest.raises(NotImplementedError, match="Queue 3"):
        model(x, position_offset=3, kv_caches=cache)
    out = model.generate(x, max_new_tokens=3, temperature=0.0)
    assert out.shape == [1, 7]
    np.testing.assert_array_equal(out.numpy()[:, :4], x.numpy())


def test_readme_snippet_runs_unchanged():
    import paddle_tpu_torch as paddle   # the API you know

    x = paddle.randn([8, 128])
    net = paddle.nn.Sequential(paddle.nn.Linear(128, 256), paddle.nn.GELU(),
                               paddle.nn.Linear(256, 10))
    loss = paddle.nn.functional.cross_entropy(net(x),
                                              paddle.randint(0, 10, [8]))
    loss.backward()                              # dygraph tape autograd
    opt = paddle.optimizer.AdamW(1e-3, parameters=net.parameters())
    before = net[0].weight.numpy().copy()
    opt.step()
    assert np.isfinite(float(loss))
    assert not np.array_equal(before, net[0].weight.numpy())


def test_readme_snippet_matches_jax():
    """The same snippet after the same seed: the same loss and update."""
    outs = []
    for pt in (jp, tp):
        pt.seed(0)
        x = pt.randn([8, 128])
        net = pt.nn.Sequential(pt.nn.Linear(128, 256), pt.nn.GELU(),
                               pt.nn.Linear(256, 10))
        loss = pt.nn.functional.cross_entropy(net(x),
                                              pt.randint(0, 10, [8]))
        loss.backward()
        pt.optimizer.AdamW(1e-3, parameters=net.parameters()).step()
        outs.append([float(loss)] + [np.asarray(p.numpy())
                                     for p in net.parameters()])
    np.testing.assert_allclose(outs[1][0], outs[0][0], **TOL)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        np.testing.assert_allclose(b, a, **TOL)
