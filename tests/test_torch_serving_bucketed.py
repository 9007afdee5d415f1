"""paddle_tpu_torch's bucketed serving path held to the JAX package's on
the CPU, at LlamaConfig.tiny widths, with the JAX package's weights
loaded through `params_from_jax`:

  * `prefill`, `prefill_varlen` and `decode_step`: logits (1e-4), the
    K/V they return or the pools they update in place, and the sampled
    record, against JAX's;
  * `ServingEngine(ragged=False, device="cpu")` against JAX's
    `ragged=False` engine on a mix of greedy and seeded requests: tokens
    identical, logprobs within 1e-4, under `run` and `run_pipelined`,
    fp32 and int8 pools, both preemption policies, the page pool
    conserved and the padding counted alike;
  * with fp32 pools the port's bucketed and ragged engines give the
    same tokens. With int8 pools they need not: the bucketed prefill
    attends to K/V before it is quantized, the ragged one to quantized
    pages (in JAX as well).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import llama_serving as J
from paddle_tpu.models import llama_spmd as JM
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu_torch.models import llama_serving as P
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.llama_spmd import params_from_jax

DIMS = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64,
            seq=128)
JCFG = JConfig.tiny(**DIMS)
CFG = LlamaConfig.tiny(**DIMS)
LOGIT_ATOL = 1e-4   # fp32 model; matmul and softmax sums in another order
LP_ATOL = 1e-4
KV_ATOL = 1e-5


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(JCFG, seed=0, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------
def test_prefill_matches_jax(jparams, tparams):
    rng = np.random.default_rng(0)
    ids = np.zeros((1, 16), np.int32)
    ids[0, :11] = rng.integers(0, DIMS["vocab"], 11)
    jl, jk, jv = J.prefill(jparams, jnp.asarray(ids), jnp.asarray(11), JCFG,
                           use_pallas=False)
    tl, tk, tv = P.prefill(tparams, torch.from_numpy(ids), 11, CFG)
    assert tuple(tk.shape) == jk.shape == (2, 2, 16, 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=KV_ATOL,
                               rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=KV_ATOL,
                               rtol=0)


@pytest.mark.parametrize("lens", [[5, 9, 3], [12, 1, 0, 7]],
                         ids=["three", "zero_len"])
def test_prefill_varlen_matches_jax(jparams, tparams, lens):
    rng = np.random.default_rng(1)
    total = 32
    ids = np.zeros((total,), np.int32)
    ids[:sum(lens)] = rng.integers(0, DIMS["vocab"], sum(lens))
    cu = np.zeros((5,), np.int32)
    cu[1:len(lens) + 1] = np.cumsum(lens)
    cu[len(lens) + 1:] = sum(lens)
    jl, jk, jv = J.prefill_varlen(jparams, jnp.asarray(ids), jnp.asarray(cu),
                                  JCFG, use_pallas=False)
    tl, tk, tv = P.prefill_varlen(tparams, torch.from_numpy(ids),
                                  torch.from_numpy(cu), CFG)
    assert tl.shape == (4, DIMS["vocab"]) and tuple(tk.shape) == jk.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=KV_ATOL,
                               rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=KV_ATOL,
                               rtol=0)


def _decode_case(quant, seed=0):
    """Pools with random KV, 4 slots: two decoding, one live but not
    launched (finishing in flight), one free (length 0)."""
    rng = np.random.default_rng(seed)
    L, KVH, PG, PPS, B = 2, 2, 8, 4, 4
    D = DIMS["hidden"] // DIMS["heads"]
    NP = B * PPS + 1
    shape = (L, KVH, NP, PG, D)
    if quant:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, shape[:-1] + (1,)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, shape[:-1] + (1,)).astype(np.float32)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    ptab = rng.permutation(NP - 1)[:B * PPS].reshape(B, PPS).astype(np.int32)
    ptab[3] = NP - 1                        # the free slot: the trash page
    lengths = np.array([9, 17, 5, 0], np.int32)
    active = np.array([True, True, False, False])
    tokens = rng.integers(0, DIMS["vocab"], B).astype(np.int32)
    sample = {"temp": np.array([0.0, 0.9, 0.0, 0.0], np.float32),
              "top_k": np.array([0, 8, 0, 0], np.int32),
              "top_p": np.array([1.0, 0.9, 1.0, 1.0], np.float32),
              "key": np.array([[0, 0], [0, 77], [0, 0], [0, 0]], np.uint32),
              "eos": np.array([-1, -1, -1, -1], np.int32),
              "remaining": np.array([1, 5, 1, 1], np.int32)}
    return dict(kp=kp, vp=vp, ks=ks, vs=vs, ptab=ptab, lengths=lengths,
                active=active, tokens=tokens, sample=sample, page=PG)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_decode_step_matches_jax(jparams, tparams, quant):
    w = _decode_case(quant)
    jn = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    jk, jv, jks, jvs, jl, jrec = J.decode_step(
        jparams, jn(w["kp"]), jn(w["vp"]), jn(w["ptab"]), jn(w["lengths"]),
        jn(w["tokens"]), jn(w["active"]), JCFG, w["page"], use_pallas=False,
        k_scale=jn(w["ks"]), v_scale=jn(w["vs"]),
        sample={k: jnp.asarray(v) for k, v in w["sample"].items()})
    t = lambda a: None if a is None else torch.from_numpy(a.copy())  # noqa
    pools = [t(w["kp"]), t(w["vp"]), t(w["ks"]), t(w["vs"])]
    sample = {k: torch.from_numpy(v.astype(np.int64) if k == "key" else v)
              for k, v in w["sample"].items()}
    tl, trec = P.decode_step(
        tparams, pools[0], pools[1], t(w["ptab"]), t(w["lengths"]),
        t(w["tokens"]), t(w["active"]), CFG, w["page"], k_scale=pools[2],
        v_scale=pools[3], sample=sample)
    # rows with a cache to read; the free slot's row differs by design
    # (zeros here, the mean of V in JAX's reference) and is discarded
    seen = w["lengths"] > 0
    np.testing.assert_allclose(tl.numpy()[seen], np.asarray(jl)[seen],
                               atol=LOGIT_ATOL, rtol=0)
    for got, want in zip(pools, (jk, jv, jks, jvs)):
        if got is None:
            continue
        # every page but the trash page, which the free slot's row
        # writes after attending differently
        d = np.abs(got.numpy()[:, :, :-1].astype(np.float64)
                   - np.asarray(want)[:, :, :-1].astype(np.float64))
        # int8 codes: a value at a rounding edge may land one code apart
        assert d.max() <= (1 if got.dtype == torch.int8 else KV_ATOL)
    jt, jd, jlp = (np.asarray(x) for x in jrec)
    tt, td, tlp = (x.numpy() for x in trec)
    act = w["active"]
    np.testing.assert_array_equal(tt[act], jt[act].astype(np.int64))
    np.testing.assert_array_equal(td, jd)
    assert td[0] and not td[1]              # remaining 1 finishes slot 0
    np.testing.assert_allclose(tlp[act], jlp[act], atol=LP_ATOL)


def test_decode_step_carry_operands(tparams):
    """carry_tok replaces slot s's token where carry_mask is set: the
    same step as feeding that token directly."""
    w = _decode_case(False, seed=3)
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731

    def run(tokens, **kw):
        return P.decode_step(tparams, t(w["kp"]), t(w["vp"]), t(w["ptab"]),
                             t(w["lengths"]), t(tokens), t(w["active"]), CFG,
                             w["page"], **kw)
    direct = run(w["tokens"])
    toks = w["tokens"].copy()
    want = int(toks[1])
    toks[1] = 0
    mask = torch.tensor([False, True, False, False])
    carry = torch.tensor([9, want, 9, 9], dtype=torch.int64)
    np.testing.assert_array_equal(
        run(toks, carry_tok=carry, carry_mask=mask).numpy(), direct.numpy())


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
MIX = [("g0", [1, 5, 9, 3, 7], {}),
       ("s0", [2, 4, 6], dict(temperature=0.8, top_k=8, top_p=0.9, seed=123)),
       ("g1", [9, 9, 2], dict(logprobs=True)),
       ("s1", [7, 1], dict(temperature=1.1, seed=7, logprobs=True)),
       ("g2", [3, 3, 3, 8, 1, 4, 4, 2, 6], dict(logprobs=True)),
       ("s2", [6, 2, 8, 4], dict(temperature=0.7, top_p=0.8, seed=99))]

ENGINE_MODES = {
    "fp32": ({}, 10, 64),
    "int8": ({"cache_dtype": "int8"}, 10, 64),
    "preempt_offload": ({"num_pages": 6, "preempt_policy": "offload"},
                        20, 32),
    "preempt_recompute": ({"num_pages": 6, "preempt_policy": "recompute"},
                          20, 32),
    "preempt_int8": ({"num_pages": 6, "cache_dtype": "int8"}, 20, 32),
}


def _submit(eng, R, max_new):
    for rid, prompt, kw in MIX:
        eng.submit(R(rid, prompt, max_new_tokens=max_new, **kw))


def _serve_torch(tparams, kw, max_new, max_seq_len, pipelined, ragged=False):
    eng = P.ServingEngine(tparams, CFG, max_seqs=3, max_seq_len=max_seq_len,
                          page_size=8, ragged=ragged, device="cpu", **kw)
    _submit(eng, P.Request, max_new)
    done = eng.run_pipelined() if pipelined else eng.run()
    assert eng.pool.conserved(drained=True)
    assert not eng._live and not eng._waiting
    return {r.rid: (list(r.output), r.logprobs) for r in done}, eng


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
def test_engine_matches_jax_bucketed_engine(jparams, tparams, mode):
    kw, max_new, msl = ENGINE_MODES[mode]
    jeng = J.ServingEngine(jparams, JCFG, max_seqs=3, max_seq_len=msl,
                           page_size=8, use_pallas=False, ragged=False, **kw)
    _submit(jeng, J.Request, max_new)
    want = {r.rid: ([int(t) for t in r.output], r.logprobs)
            for r in jeng.run()}
    for pipelined in (False, True):
        got, eng = _serve_torch(tparams, kw, max_new, msl, pipelined)
        assert set(got) == set(want) == {m[0] for m in MIX}
        for rid, (toks, lps) in want.items():
            assert got[rid][0] == toks, (rid, pipelined)
            if lps is None:
                assert got[rid][1] is None
            else:
                np.testing.assert_allclose(got[rid][1], lps, atol=LP_ATOL)
        assert eng.tok_buf is None
        assert eng.preemptions == jeng.preemptions
        assert eng.pad_tokens == jeng.pad_tokens > 0
        assert eng.prefill_tokens == jeng.prefill_tokens
        assert eng.device_steps == jeng.device_steps or pipelined
        if "num_pages" in kw:
            assert eng.preemptions > 0
            assert eng.host_tier.host_bytes == 0    # every stash taken back


def test_engine_admits_through_both_prefills(tparams, monkeypatch):
    """Three requests fill the slots in one packed prefill_varlen wave;
    later admissions of one request go through prefill."""
    calls = {"varlen": [], "single": []}
    varlen, single = P.prefill_varlen, P.prefill

    def count_varlen(params, ids, cu, config):
        calls["varlen"].append(int((cu[1:] > cu[:-1]).sum()))
        return varlen(params, ids, cu, config)

    def count_single(params, ids, length, config):
        calls["single"].append(int(length))
        return single(params, ids, length, config)
    monkeypatch.setattr(P, "prefill_varlen", count_varlen)
    monkeypatch.setattr(P, "prefill", count_single)
    eng = P.ServingEngine(tparams, CFG, max_seqs=3, max_seq_len=64,
                          page_size=8, ragged=False, device="cpu")
    # staggered budgets: slots free one at a time after the first wave
    for i, (rid, prompt, _) in enumerate(MIX):
        eng.submit(P.Request(rid, prompt, max_new_tokens=4 + 3 * i))
    done = eng.run_pipelined()
    assert len(done) == len(MIX) and eng.pool.conserved(drained=True)
    assert calls["varlen"] == [3]
    assert calls["single"] == [len(p) for _, p, _ in MIX[3:]]


def test_bucketed_and_ragged_engines_agree_with_fp32_pools(tparams):
    for mode in ("fp32", "preempt_recompute"):
        kw, max_new, msl = ENGINE_MODES[mode]
        bucketed, _ = _serve_torch(tparams, kw, max_new, msl, True)
        ragged, _ = _serve_torch(tparams, kw, max_new, msl, True, ragged=True)
        assert {r: v[0] for r, v in bucketed.items()} == \
            {r: v[0] for r, v in ragged.items()}
        for rid, (_, lps) in ragged.items():
            if lps is not None:
                np.testing.assert_allclose(bucketed[rid][1], lps,
                                           atol=LP_ATOL)


def test_eos_finish_rolls_back_overrun(tparams):
    """The pipelined loop runs an eos-finishing slot one zombie step past
    its end and rolls its length back: the same output as `run()`, and
    nothing left behind."""
    prompt = [2, 4, 2, 4, 2]
    probe = P.ServingEngine(tparams, CFG, max_seqs=1, max_seq_len=64,
                            page_size=8, ragged=False, device="cpu")
    probe.submit(P.Request("p", prompt, max_new_tokens=12))
    ref = probe.run()[0].output
    idx = next(i for i in range(2, len(ref)) if ref[i] not in ref[:i])
    outs = []
    for pipelined in (False, True):
        eng = P.ServingEngine(tparams, CFG, max_seqs=2, max_seq_len=64,
                              page_size=8, ragged=False, device="cpu")
        eng.submit(P.Request("e", prompt, max_new_tokens=12,
                             eos_id=ref[idx]))
        eng.submit(P.Request("g", [9, 8, 7], max_new_tokens=9))
        done = eng.run_pipelined() if pipelined else eng.run()
        outs.append({r.rid: r.output for r in done})
        assert eng.pool.conserved(drained=True)
        assert eng.lengths.sum() == 0
    assert outs[0] == outs[1]
    assert outs[0]["e"] == ref[:idx + 1] and len(outs[0]["g"]) == 9


def test_cancel_queued_and_active(tparams):
    eng = P.ServingEngine(tparams, CFG, max_seqs=1, max_seq_len=64,
                          page_size=8, ragged=False, device="cpu")
    a = P.Request("a", [1, 2, 3], max_new_tokens=20)
    b = P.Request("b", [4, 5], max_new_tokens=5)
    eng.submit(a)
    eng.submit(b)
    eng.step()
    eng.step()
    assert eng.cancel(b) and b in eng.finished      # queued: leaves now
    assert eng.cancel(a)                            # active: next boundary
    eng.step()
    assert a in eng.finished and a.slot is None
    assert eng.pool.conserved(drained=True)
