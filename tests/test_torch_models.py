"""The port's decoder families held to the JAX package's, as
tests/test_models_llm.py builds them: Qwen2 (`Qwen2Config.tiny`, tied
and untied heads, random q/k/v biases), GPT-2 (`GPT2Config.tiny`), the
MoE LLM (`MoEConfig.tiny_moe`) and DeepSeek's MLA
(`DeepSeekConfig.tiny_mla`), each port model loaded from the JAX model's
state dict by its structured names; and `llama_decode` on
`llama_spmd.init_params` weights (`params_from_jax`).

On the CPU both packages' attention runs a dense reference: the port's
flash plain versions, the JAX package's `mha_reference`. Logits agree
within 1e-5, the gradients within 1e-4 relative, and the parameters
after an AdamW step under tests/test_torch_layer_llama.py's rule
(elements whose gradient is within rounding of zero may move 2.5 lr
apart; the others are held to 1e-5 each and in relative norm). Greedy
generation is token-identical: GPT-2's KV-cached decode, the eager loop
of Llama and Qwen2 (whose later steps see no cache, as the
reference's), and `make_generate`. The tests that only read a model
share one pair a family (`_pair`); the training step runs once a family
(`_steps`), JAX's side compiled (the file takes about 60 s alone)."""
import functools

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.models import deepseek as j_ds
from paddle_tpu.models import gpt2 as j_gpt2
from paddle_tpu.models import llama as j_llama
from paddle_tpu.models import llama_decode as j_dec
from paddle_tpu.models import llama_spmd as j_spmd
from paddle_tpu.models import moe_llm as j_moe
from paddle_tpu.models import qwen2 as j_qwen2
from paddle_tpu_torch._core import state as tstate
from paddle_tpu_torch.models import deepseek as t_ds
from paddle_tpu_torch.models import gpt2 as t_gpt2
from paddle_tpu_torch.models import llama as t_llama
from paddle_tpu_torch.models import llama_decode as t_dec
from paddle_tpu_torch.models import llama_spmd as t_spmd
from paddle_tpu_torch.models import moe_llm as t_moe
from paddle_tpu_torch.models import qwen2 as t_qwen2

TOL = dict(rtol=1e-5, atol=1e-5)
LR = 1e-3


@pytest.fixture(autouse=True)
def _cpu():
    prev = tstate._device
    tstate.set_device("cpu")
    yield
    tstate._device = prev


def _untied(cfg):
    cfg.tie_word_embeddings = False
    return cfg


# name -> (JAX config, JAX model class, port config, port model class)
FAMILIES = {
    "qwen2": (j_qwen2.Qwen2Config.tiny(), j_qwen2.Qwen2ForCausalLM,
              t_qwen2.Qwen2Config.tiny(), t_qwen2.Qwen2ForCausalLM),
    "qwen2_untied": (_untied(j_qwen2.Qwen2Config.tiny()),
                     j_qwen2.Qwen2ForCausalLM,
                     _untied(t_qwen2.Qwen2Config.tiny()),
                     t_qwen2.Qwen2ForCausalLM),
    "gpt2": (j_gpt2.GPT2Config.tiny(), j_gpt2.GPT2LMHeadModel,
             t_gpt2.GPT2Config.tiny(), t_gpt2.GPT2LMHeadModel),
    "moe": (j_moe.MoEConfig.tiny_moe(), j_moe.MoEForCausalLM,
            t_moe.MoEConfig.tiny_moe(), t_moe.MoEForCausalLM),
    "deepseek": (j_ds.DeepSeekConfig.tiny_mla(), j_ds.DeepSeekForCausalLM,
                 t_ds.DeepSeekConfig.tiny_mla(), t_ds.DeepSeekForCausalLM),
    "llama": (j_llama.LlamaConfig.tiny(), j_llama.LlamaForCausalLM,
              t_llama.LlamaConfig.tiny(), t_llama.LlamaForCausalLM),
}


def _ids(b, s, v, seed=0):
    return np.random.RandomState(seed).randint(0, v, (b, s)).astype(np.int64)


def _fresh_pair(name):
    """(JAX model, port model, state dict): the JAX model from seed 0,
    its q/k/v biases (Qwen2) redrawn so that they are not zero, and the
    port loaded from it."""
    jcfg, jcls, tcfg, tcls = FAMILIES[name]
    jp.seed(0)
    jm = jcls(jcfg)
    sd = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    rng = np.random.default_rng(1)
    biases = {k: (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
              for k, v in sd.items() if k.endswith("_proj.bias")}
    if biases:
        sd.update(biases)
        jm.set_state_dict({k: jp.to_tensor(v) for k, v in sd.items()})
    tm = tcls(tcfg)
    missing, unexpected = tm.set_state_dict(sd)
    assert not missing and not unexpected
    return jm, tm, sd


@functools.cache
def _pair(name):
    return _fresh_pair(name)


def _vocab(name):
    return FAMILIES[name][0].vocab_size


@pytest.mark.parametrize("name", list(FAMILIES))
def test_state_dict_names_and_shapes_match_jax(name):
    jm, tm, sd = _pair(name)
    tsd = tm.state_dict()
    assert list(tsd) == list(sd)
    for k, v in tsd.items():
        assert tuple(v.shape) == sd[k].shape, k
        assert v.dtype == tp.float32, k
    if name == "qwen2":
        assert tm.lm_head is None
        assert "llama.layers.0.self_attn.k_proj.bias" in tsd
    if name == "qwen2_untied":
        assert "lm_head.weight" in tsd


@pytest.mark.parametrize("name", list(FAMILIES))
def test_logits_match_jax(name):
    """The port's forward without labels; JAX's eager forward, or for the
    families that train below the logits of its compiled step (the same
    batch)."""
    jm, tm, _ = _pair(name)
    x = _ids(2, 12, _vocab(name))
    if name in STEP_FAMILIES:
        ref = _steps(name)["jax"][1]
    else:
        ref = np.asarray(jm(jp.to_tensor(x)).numpy())
    got = tm(tp.to_tensor(x)).numpy()
    assert got.shape == (2, 12, _vocab(name))
    np.testing.assert_allclose(got, ref, **TOL)


STEP_FAMILIES = ["qwen2", "gpt2", "moe", "deepseek"]


def _moe_aux(model):
    return [layer.mlp.aux_loss for layer in getattr(model, "layers", ())
            if hasattr(layer.mlp, "aux_loss")]


@functools.cache
def _steps(name):
    """One training step a family from the same weights and batch (2 x 12
    tokens). The port runs `loss.backward()` and `AdamW.step()` on a fresh
    model. JAX runs the same model and update rule through its functional
    bridge, `functional_call` under `jax.value_and_grad` and then
    `AdamW.apply_gradients`, compiled as one program: its eager tape
    compiles every op alone, which took this file minutes. The JAX model
    is a throwaway, since tracing leaves tracers in its rope cache and in
    its MoE layers' `aux_loss`. Returns each side's loss, logits, MoE aux
    losses, gradients and parameters after the step."""
    jm, tm, _ = _fresh_pair(name)
    v = _vocab(name)
    x, y = _ids(2, 12, v), _ids(2, 12, v, seed=1)
    params, buffers = jm.functional_state()
    jopt = jp.optimizer.AdamW(LR, parameters=jm.parameters())

    def loss_fn(p):
        loss, logits = jm.functional_call(p, buffers, jp.to_tensor(x),
                                          labels=jp.to_tensor(y))
        return loss, (logits, [a._value for a in _moe_aux(jm)])

    @jax.jit
    def step(p):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        after, _ = jopt.apply_gradients(p, grads, jopt.init_state(p))
        return loss, aux, grads, after

    jloss, (jlogits, jaux), jgrads, jafter = jax.tree.map(np.asarray,
                                                          step(params))
    topt = tp.optimizer.AdamW(LR, parameters=tm.parameters())
    tloss, tlogits = tm(tp.to_tensor(x), labels=tp.to_tensor(y))
    taux = [float(a) for a in _moe_aux(tm)]
    tloss.backward()
    tgrads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    topt.step()
    tafter = {k: v.numpy() for k, v in tm.state_dict().items()}
    return dict(jax=(float(jloss), jlogits, [float(a) for a in jaux], jgrads,
                     jafter),
                port=(float(tloss), tlogits.numpy(), taux, tgrads, tafter))


@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_loss_and_gradients_match_jax(name):
    jloss, jlogits, _, jg, _ = _steps(name)["jax"]
    tloss, tlogits, _, tg, _ = _steps(name)["port"]
    np.testing.assert_allclose(tlogits, jlogits, **TOL)
    np.testing.assert_allclose(tloss, jloss, **TOL)
    assert sorted(tg) == sorted(jg)
    for k in tg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_adamw_step_matches_jax(name):
    """The parameters after an AdamW step, under
    tests/test_torch_layer_llama.py's rule."""
    jg, jafter = _steps(name)["jax"][3:]
    tafter = _steps(name)["port"][4]
    assert sorted(tafter) == sorted(jafter)
    for k, got in tafter.items():
        ref = jafter[k]
        allowed = 1e-5 + np.where(np.abs(jg[k]) < 1e-6, 2.5 * LR, 0.0)
        assert np.all(np.abs(got - ref) <= allowed), k
        kept = np.abs(jg[k]) >= 1e-6
        assert np.linalg.norm((got - ref)[kept]) <= \
            1e-5 * np.linalg.norm(ref), k


@pytest.mark.parametrize("name", ["moe", "deepseek"])
def test_moe_aux_loss_matches_jax(name):
    """Each MoE layer's load-balance loss after a forward; the MoE LLM
    adds aux_loss_weight times their sum to its loss, DeepSeek none."""
    jaux = _steps(name)["jax"][2]
    tloss, tlogits, taux, _, _ = _steps(name)["port"]
    assert len(taux) == len(jaux) > 0
    np.testing.assert_allclose(taux, jaux, **TOL)
    y = tp.to_tensor(_ids(2, 12, _vocab(name), seed=1))
    ce = float(tp.nn.functional.cross_entropy(tp.to_tensor(tlogits), y))
    weight = FAMILIES[name][2].aux_loss_weight if name == "moe" else 0.0
    np.testing.assert_allclose(tloss, ce + weight * sum(taux), **TOL)


def test_mla_latent_width_and_causality():
    """The latent (kv_down's output) is narrower than the per-head K/V
    it expands to, and a token's logits do not see later tokens."""
    cfg = t_ds.DeepSeekConfig.tiny_mla(layers=1)
    tp.seed(0)
    m = t_ds.DeepSeekForCausalLM(cfg)
    att = m.layers[0].self_attn
    latent = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    assert att.kv_down.weight.shape == [cfg.hidden_size, latent]
    assert latent < cfg.num_attention_heads * (
        cfg.qk_nope_head_dim + cfg.v_head_dim) / 2
    ids = _ids(1, 8, cfg.vocab_size)
    ids2 = ids.copy()
    ids2[0, -1] = (ids2[0, -1] + 1) % cfg.vocab_size
    a, b = (m(tp.to_tensor(i)).numpy() for i in (ids, ids2))
    np.testing.assert_allclose(a[0, :-1], b[0, :-1], atol=1e-6)
    assert not np.allclose(a[0, -1], b[0, -1], atol=1e-5)


@pytest.mark.parametrize("name", ["gpt2", "qwen2", "llama"])
def test_greedy_generate_matches_jax(name):
    """GPT-2's KV-cached decode (prefill at position_offset=1, then one
    non-causal token a step over the caches); Qwen2's and Llama's eager
    loop, whose steps after the first see no cache."""
    jm, tm, _ = _pair(name)
    x = _ids(2, 12, _vocab(name), seed=2)
    new = 3 if name == "gpt2" else 4    # GPT-2 compiles a cache shape a step
    jp.seed(3)
    tp.seed(3)
    ref = np.asarray(jm.generate(jp.to_tensor(x), max_new_tokens=new,
                                 temperature=0.0).numpy())
    got = tm.generate(tp.to_tensor(x), max_new_tokens=new,
                      temperature=0.0).numpy()
    assert got.shape == (2, 12 + new)
    np.testing.assert_array_equal(got, ref)


def test_sampled_generate_draws_jax_tokens():
    """A seeded temperature draw through the key stream: the same tokens
    as JAX's (the Gumbel noise's last bits may differ, ROADMAP.md Queue
    3; no tie within them shows here)."""
    jm, tm, _ = _pair("qwen2")
    x = _ids(2, 12, _vocab("qwen2"), seed=4)
    jp.seed(5)
    tp.seed(5)
    ref = np.asarray(jm.generate(jp.to_tensor(x), max_new_tokens=4,
                                 temperature=0.8, top_k=20,
                                 top_p=0.9).numpy())
    got = tm.generate(tp.to_tensor(x), max_new_tokens=4, temperature=0.8,
                      top_k=20, top_p=0.9).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["llama", "qwen2"])
def test_layer_tree_one_token_cached_step_matches_jax(name):
    """kv_caches= of (B, KVH, S_cache, D) keys and values a layer and a
    one-token step at position S_cache: the port runs it non-causal,
    which is what the reference's bottom-right mask gives."""
    jm, tm, _ = _pair(name)
    cfg = FAMILIES[name][2]
    hd = cfg.hidden_size // cfg.num_attention_heads
    rng = np.random.default_rng(6)
    caches = [tuple(rng.standard_normal(
        (2, cfg.num_key_value_heads, 7, hd)).astype(np.float32)
        for _ in range(2)) for _ in range(cfg.num_hidden_layers)]
    x = _ids(2, 1, cfg.vocab_size, seed=7)
    ref = np.asarray(jm(jp.to_tensor(x), position_offset=7, kv_caches=[
        tuple(jp.to_tensor(a) for a in c) for c in caches]).numpy())
    got = tm(tp.to_tensor(x), position_offset=7, kv_caches=[
        tuple(tp.to_tensor(a) for a in c) for c in caches]).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


DEC_CFG = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2,
               ffn=128, seq=64)


def _decode_params():
    jcfg = j_llama.LlamaConfig.tiny(**DEC_CFG)
    tcfg = t_llama.LlamaConfig.tiny(**DEC_CFG)
    jparams = j_spmd.init_params(jcfg, seed=0)
    tparams = t_spmd.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    return jcfg, tcfg, jparams, tparams


def test_forward_with_cache_matches_jax():
    """A prefill at index 0 then one token at index 6, logits and the
    written cache; JAX's compiled as make_generate compiles its prefill."""
    jcfg, tcfg, jparams, tparams = _decode_params()
    ids = _ids(2, 6, 128, seed=8)
    jcache = j_dec.init_cache(jcfg, 2, 16)
    tcache = t_dec.init_cache(tcfg, 2, 16, device="cpu")
    jfwd = jax.jit(functools.partial(j_dec.forward_with_cache, config=jcfg))
    for tok, index in ((ids, 0), (ids[:, -1:], 6)):
        jl, jcache = jfwd(jparams, tok, jcache, index)
        tl, tcache = t_dec.forward_with_cache(tparams, torch.from_numpy(tok),
                                              tcache, index, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache), **TOL)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_make_generate_matches_jax(temperature):
    jcfg, tcfg, jparams, tparams = _decode_params()
    ids = _ids(2, 5, 128, seed=9)
    ref = np.asarray(j_dec.make_generate(jcfg, 24, 8, temperature, top_k=10)(
        jparams, ids, seed=3))
    got = t_dec.make_generate(tcfg, 24, 8, temperature, top_k=10)(
        tparams, torch.from_numpy(ids), seed=3).numpy()
    assert got.shape == (2, 13)
    np.testing.assert_array_equal(got, ref)
