"""paddle_tpu_torch's speculative decoding and chunked prefill held to the
JAX package's on the CPU, at LlamaConfig.tiny widths, with the JAX
package's weights loaded through `params_from_jax` (JAX side with
`use_pallas=False`):

  * `verify_step`: logits, the pools it updates in place and its record
    (grid tokens, logprobs, candidate probabilities) against JAX's, on
    the real rows (active slots, positions < n_tok: padded positions
    write the trash page and read through table entries nobody owns),
    fp32 and int8 pools; its lean `need_rows` logits; logits 1e-4,
    logprobs 1e-4, probabilities 1e-5 (an fp32 model, sums in another
    order);
  * `unified_step(cand_tok=...)` against JAX's;
  * `speculative_sample` and `prompt_lookup_draft` equal to JAX's on the
    same inputs and RandomState seed;
  * `ServingEngine(spec_decode=4, device="cpu")` against JAX's engine,
    bucketed and ragged: tokens identical, logprobs within 1e-4 and the
    counters (spec_drafted, spec_accepted, device_steps, prefill_tokens,
    logit_rows, preemptions) equal, over greedy and seeded requests with
    an eos, int8 pools, spec_sample, chunked prefill, and a small pool
    that evicts a slot in the middle of its chunked prefill;
  * greedy spec decoding gives plain decoding's tokens.
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
PROB_ATOL = 1e-5
KV_ATOL = 1e-5


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(JCFG, seed=0, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def _jn(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _sample_np(B):
    """Per-slot sampling tables: slot 0 greedy, 1 and 3 sampled with a
    top_k/top_p filter, 2 inactive."""
    return {"temp": np.array([0.0, 0.9, 0.0, 1.2][:B], np.float32),
            "top_k": np.array([0, 8, 0, 0][:B], np.int32),
            "top_p": np.array([1.0, 0.9, 1.0, 0.8][:B], np.float32),
            "key": np.array([[0, 0], [0, 77], [0, 0], [1, 5]][:B],
                            np.uint32)}


def _torch_sample(sample):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "key" else v)
            for k, v in sample.items()}


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------
def _verify_case(quant, seed=0, G=4):
    """4 slots, pools with random KV: slot 0 verifies a full chunk, slot 1
    a chunk of 2 (positions 2-3 padded), slot 2 is inactive, slot 3
    verifies 3 tokens crossing a page boundary."""
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
    ptab[2] = NP - 1                        # the inactive slot: trash page
    lengths = np.array([9, 17, 0, 6], np.int32)
    n_tok = np.array([G, 2, 1, 3], np.int32)
    active = np.array([True, True, False, True])
    tokens = rng.integers(0, DIMS["vocab"], (B, G)).astype(np.int32)
    cand = rng.integers(0, DIMS["vocab"], (B, G)).astype(np.int32)
    real = active[:, None] & (np.arange(G)[None] < n_tok[:, None])
    return dict(kp=kp, vp=vp, ks=ks, vs=vs, ptab=ptab, lengths=lengths,
                n_tok=n_tok, active=active, tokens=tokens, cand=cand,
                page=PG, real=real, sample=_sample_np(B))


def _run_verify(jparams, tparams, w, **kw):
    jout = J.verify_step(
        jparams, _jn(w["kp"]), _jn(w["vp"]), _jn(w["ptab"]),
        _jn(w["lengths"]), _jn(w["tokens"]), _jn(w["n_tok"]),
        _jn(w["active"]), JCFG, w["page"], use_pallas=False,
        k_scale=_jn(w["ks"]), v_scale=_jn(w["vs"]),
        **{k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
               if k == "sample" else _jn(v)) for k, v in kw.items()})
    pools = [_t(w[k]) for k in ("kp", "vp", "ks", "vs")]
    tout = P.verify_step(
        tparams, pools[0], pools[1], _t(w["ptab"]), _t(w["lengths"]),
        _t(w["tokens"]), _t(w["n_tok"]), _t(w["active"]), CFG, w["page"],
        k_scale=pools[2], v_scale=pools[3],
        **{k: (_torch_sample(v) if k == "sample" else _t(v))
           for k, v in kw.items()})
    return jout, tout, pools


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_verify_step_matches_jax(jparams, tparams, quant):
    w = _verify_case(quant)
    jout, (tl, trec), pools = _run_verify(jparams, tparams, w,
                                          sample=w["sample"],
                                          cand_tok=w["cand"])
    jk, jv, jks, jvs, jl, jrec = jout
    real = w["real"]
    assert tuple(tl.shape) == jl.shape == (4, 4, DIMS["vocab"])
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                               atol=LOGIT_ATOL, rtol=0)
    for got, want in zip(pools, (jk, jv, jks, jvs)):
        if got is None:
            continue
        # every page but the trash page, which padded positions write
        d = np.abs(got.numpy()[:, :, :-1].astype(np.float64)
                   - np.asarray(want)[:, :, :-1].astype(np.float64))
        # int8 codes: a value at a rounding edge may land one code apart
        assert d.max() <= (1 if got.dtype == torch.int8 else KV_ATOL)
    jt, jlp, jc = (np.asarray(x) for x in jrec)
    tt, tlp, tc = (x.numpy() for x in trec)
    assert tt.dtype == np.int64 and tlp.dtype == tc.dtype == np.float32
    np.testing.assert_array_equal(tt[real], jt[real].astype(np.int64))
    np.testing.assert_allclose(tlp[real], jlp[real], atol=LP_ATOL, rtol=0)
    np.testing.assert_allclose(tc[real], jc[real], atol=PROB_ATOL, rtol=0)
    assert tc[real][w["sample"]["temp"][np.nonzero(real)[0]] > 0].max() > 0


def test_verify_step_need_rows_matches_jax(jparams, tparams):
    w = _verify_case(False, seed=1)
    need = np.array([0, 3, 5, 12, 14, -1], np.int32)   # flat (B * G) rows
    jout, tl, _ = _run_verify(jparams, tparams, w, need_rows=need)
    assert tuple(tl.shape) == (6, DIMS["vocab"])
    np.testing.assert_allclose(tl.numpy()[:5], np.asarray(jout[4])[:5],
                               atol=LOGIT_ATOL, rtol=0)
    full = P.verify_step(tparams, *(_t(w[k]) for k in (
        "kp", "vp", "ptab", "lengths", "tokens", "n_tok", "active")), CFG,
        w["page"])
    np.testing.assert_allclose(tl.numpy()[:5],
                               full.reshape(16, -1).numpy()[need[:5]],
                               atol=LOGIT_ATOL, rtol=0)


def test_unified_step_cand_tok_matches_jax(jparams, tparams):
    """A wave of two verify chunks and a decode row, lean: the record's
    candidate probabilities are in need-row space."""
    rng = np.random.default_rng(2)
    L, KVH, PG, PPS, B = 2, 2, 8, 4, 4
    D = DIMS["hidden"] // DIMS["heads"]
    NP = B * PPS + 1
    kp = rng.standard_normal((L, KVH, NP, PG, D)).astype(np.float32)
    vp = rng.standard_normal((L, KVH, NP, PG, D)).astype(np.float32)
    ptab = rng.permutation(NP - 1)[:B * PPS].reshape(B, PPS).astype(np.int32)
    T, N = 16, 12
    slot = np.zeros((T,), np.int32)
    pos = np.full((T,), -1, np.int32)
    slot[:4], pos[:4] = 0, np.arange(9, 13)
    slot[4:7], pos[4:7] = 1, np.arange(17, 20)
    slot[7], pos[7] = 3, 5
    toks = rng.integers(0, DIMS["vocab"], T).astype(np.int32)
    need = np.full((N,), -1, np.int32)
    need[:8] = np.arange(8)
    cand = rng.integers(0, DIMS["vocab"], N).astype(np.int32)
    sample = _sample_np(B)
    jk, jv, _, _, jl, jrec = J.unified_step(
        jparams, _jn(kp), _jn(vp), _jn(ptab), _jn(toks), _jn(slot),
        _jn(pos), JCFG, PG, use_pallas=False,
        sample={k: jnp.asarray(v) for k, v in sample.items()},
        need_rows=_jn(need), cand_tok=_jn(cand))
    tl, trec = P.unified_step(
        tparams, _t(kp), _t(vp), _t(ptab), _t(toks), _t(slot), _t(pos), CFG,
        PG, sample=_torch_sample(sample), need_rows=_t(need),
        cand_tok=_t(cand))
    assert len(trec) == len(jrec) == 4
    live = need >= 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(trec[0].numpy()[live],
                                  np.asarray(jrec[0])[live])
    np.testing.assert_array_equal(trec[1].numpy(), np.asarray(jrec[1]))
    assert not trec[1].numpy().any()                # no eos/remaining
    np.testing.assert_allclose(trec[2].numpy()[live],
                               np.asarray(jrec[2])[live], atol=LP_ATOL)
    np.testing.assert_allclose(trec[3].numpy()[live],
                               np.asarray(jrec[3])[live], atol=PROB_ATOL)


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_cand", [False, True], ids=["rows", "cand"])
def test_speculative_sample_equals_jax(with_cand):
    rng = np.random.default_rng(3)
    V, n = 12, 5
    for trial in range(20):
        logits = rng.standard_normal((n, V)) * (0.5 + trial % 4)
        rows = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        drafts = [int(np.argmax(rows[g])) if trial % 3 else
                  int(rng.integers(V)) for g in range(n - 1)]
        cand = [rows[g][d] for g, d in enumerate(drafts)] \
            if with_cand else None
        got = P.speculative_sample(lambda g: rows[g], drafts,
                                   np.random.RandomState(trial), cand)
        want = J.speculative_sample(lambda g: rows[g], drafts,
                                    np.random.RandomState(trial), cand)
        assert got == want
    # a point mass on the draft is accepted without a draw
    mass = np.zeros((2, V))
    mass[:, 4] = 1.0
    assert P.speculative_sample(mass, [4], np.random.RandomState(0)) == \
        J.speculative_sample(mass, [4], np.random.RandomState(0))


def test_prompt_lookup_draft_equals_jax():
    rng = np.random.default_rng(4)
    for _ in range(50):
        ctx = rng.integers(0, 4, int(rng.integers(0, 20))).tolist()
        for G in (1, 3, 6):
            for ngram in (1, 2, 3):
                assert P.prompt_lookup_draft(ctx, G, ngram) == \
                    J.prompt_lookup_draft(ctx, G, ngram)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------
# ngram-repetitive prompts (a short motif repeated), so prompt lookup
# finds drafts; r1 stops at an eos, s0/s1 are seeded samples
MIX = [("g0", [1, 5, 9] * 3, {}),
       ("s0", [2, 4, 6] * 2, dict(temperature=0.8, top_k=8, top_p=0.9,
                                 seed=123)),
       ("g1", [9, 9, 2] * 3, dict(logprobs=True)),
       ("s1", [7, 1] * 3, dict(temperature=0.3, top_k=2, seed=7,
                               logprobs=True)),
       ("g2", [3, 3, 8, 1] * 3, dict(logprobs=True)),
       ("r1", [4, 2, 4, 2, 4], dict(eos_id=None))]

ENGINE_MODES = {
    "bucketed": ({"ragged": False}, 20, 64),
    "bucketed_int8": ({"ragged": False, "cache_dtype": "int8"}, 20, 64),
    "bucketed_spec_sample": ({"ragged": False, "spec_sample": True,
                              "spec_ngram": 1}, 20, 64),
    "bucketed_chunked": ({"ragged": False, "chunked_prefill": True}, 20, 64),
    "bucketed_chunked_lean_off": ({"ragged": False, "chunked_prefill": True,
                                   "spec_sample": True, "spec_ngram": 1,
                                   "lean": False}, 20, 64),
    "ragged": ({}, 20, 64),
    "ragged_int8": ({"cache_dtype": "int8"}, 20, 64),
    "ragged_spec_sample": ({"spec_sample": True, "spec_ngram": 1}, 20, 64),
    "ragged_spec_sample_lean_off": ({"spec_sample": True, "spec_ngram": 1,
                                     "lean": False}, 20, 64),
    "bucketed_preempt": ({"ragged": False, "num_pages": 6}, 24, 40),
}


def _requests(R, max_new, eos):
    out = []
    for rid, prompt, kw in MIX:
        kw = dict(kw)
        if "eos_id" in kw:
            kw["eos_id"] = eos
        out.append(R(rid, prompt, max_new_tokens=max_new, **kw))
    return out


def _serve(mod, params, cfg, kw, max_new, msl, eos, spec=4):
    extra = {"use_pallas": False} if mod is J else {"device": "cpu"}
    eng = mod.ServingEngine(params, cfg, max_seqs=3, max_seq_len=msl,
                            page_size=8, spec_decode=spec, **extra, **kw)
    for r in _requests(mod.Request, max_new, eos):
        eng.submit(r)
    done = eng.run()
    assert eng.pool.conserved(drained=True)
    assert not eng._live and not eng._waiting
    return {r.rid: ([int(t) for t in r.output], r.logprobs) for r in done}, \
        eng


def _counters(eng):
    return {k: getattr(eng, k) for k in (
        "spec_drafted", "spec_accepted", "device_steps", "prefill_tokens",
        "logit_rows", "logit_rows_skipped", "preemptions")}


@pytest.fixture(scope="module")
def eos_token(tparams):
    """An eos for request r1: the plain engine's token at output index
    3, chosen where it first occurs, so r1 stops early."""
    eng = P.ServingEngine(tparams, CFG, max_seqs=1, max_seq_len=64,
                          page_size=8, ragged=False, device="cpu")
    eng.submit(P.Request("p", MIX[5][1], max_new_tokens=12))
    out = eng.run()[0].output
    return next(t for i, t in enumerate(out) if i >= 3 and
                t not in out[:i])


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
def test_spec_engine_matches_jax(jparams, tparams, eos_token, mode):
    kw, max_new, msl = ENGINE_MODES[mode]
    want, jeng = _serve(J, jparams, JCFG, kw, max_new, msl, eos_token)
    got, eng = _serve(P, tparams, CFG, kw, max_new, msl, eos_token)
    assert set(got) == set(want) == {m[0] for m in MIX}
    for rid, (toks, lps) in want.items():
        assert got[rid][0] == toks, rid
        if lps is None:
            assert got[rid][1] is None
        else:
            np.testing.assert_allclose(got[rid][1], lps, atol=LP_ATOL)
    assert _counters(eng) == _counters(jeng)
    assert eng.spec_drafted > 0 and eng.spec_accepted > 0
    assert eng.tok_buf is None
    assert len(got["r1"][0]) < max_new and got["r1"][0][-1] == eos_token
    if "num_pages" in kw:
        assert eng.preemptions > 0
        assert eng.host_tier.host_bytes == 0    # every stash taken back


def test_spec_sample_drafts_for_sampled_requests(tparams):
    """spec_sample drafts for the sampled requests too (more drafts than
    without it), and rejection sampling both accepts and rejects some."""
    kw, max_new, msl = ENGINE_MODES["ragged_spec_sample"]
    _, plain = _serve(P, tparams, CFG, dict(kw, spec_sample=False), max_new,
                      msl, None)
    calls = []
    orig = P.speculative_sample

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append((len(a[1]), out[1]))
        return out
    P.speculative_sample = spy
    try:
        _, samp = _serve(P, tparams, CFG, kw, max_new, msl, None)
    finally:
        P.speculative_sample = orig
    assert samp.spec_drafted > plain.spec_drafted
    assert any(a > 0 for _, a in calls)             # a draft accepted
    assert any(a < n for n, a in calls)             # a draft rejected


@pytest.mark.parametrize("policy", ["offload", "recompute"])
def test_chunked_prefill_evicts_mid_prefill(jparams, tparams, policy):
    """A short prompt that decodes long and a 36-token prompt fed 4
    tokens a step, in a pool of 6 pages: the decoding slot's growth
    evicts the later admission in the middle of its prefill, which
    resumes; both engines agree token for token and on every counter,
    and the pool is conserved."""
    res = []
    for mod, params, cfg in ((J, jparams, JCFG), (P, tparams, CFG)):
        extra = {"use_pallas": False} if mod is J else {"device": "cpu"}
        eng = mod.ServingEngine(params, cfg, max_seqs=2, max_seq_len=48,
                                page_size=8, num_pages=7, spec_decode=4,
                                chunked_prefill=True, ragged=False,
                                preempt_policy=policy, **extra)
        eng.submit(mod.Request("a", [1, 5, 9] * 2, max_new_tokens=42))
        eng.submit(mod.Request("b", [(7 * j) % 60 + 2 for j in range(36)],
                               max_new_tokens=12))
        evicted_mid = []
        orig = eng._preempt_one

        def spy(exclude, _orig=orig, _eng=eng):
            victims = [s for s, r in enumerate(_eng._slots)
                       if r is not None and s != exclude]
            if victims:
                s = max(victims, key=lambda v: _eng._slots[v]._admit_order)
                evicted_mid.append(_eng._prefilling(_eng._slots[s]))
            return _orig(exclude)
        eng._preempt_one = spy
        done = eng.run()
        assert eng.pool.conserved(drained=True)
        assert evicted_mid == [True]
        res.append(({r.rid: [int(t) for t in r.output] for r in done},
                    _counters(eng)))
    assert res[0] == res[1]
    assert [len(res[1][0][r]) for r in "ab"] == [42, 12]


@pytest.mark.parametrize("ragged", [False, True], ids=["bucketed", "ragged"])
def test_greedy_spec_equals_plain_decode(tparams, ragged):
    greedy = [m for m in MIX if "temperature" not in m[2]]
    outs, steps = [], []
    for spec in (0, 4):
        eng = P.ServingEngine(tparams, CFG, max_seqs=3, max_seq_len=64,
                              page_size=8, spec_decode=spec, ragged=ragged,
                              device="cpu")
        for rid, prompt, _ in greedy:
            eng.submit(P.Request(rid, prompt, max_new_tokens=20))
        outs.append({r.rid: list(r.output) for r in eng.run_pipelined()})
        steps.append(eng.device_steps)
    assert outs[0] == outs[1]
    assert eng.spec_accepted > 0 and steps[1] < steps[0]


@pytest.mark.parametrize("kw,match", [
    ({"spec_decode": -1}, "want >= 0"),
    ({"chunked_prefill": True}, "chunked_prefill rides"),
    ({"chunked_prefill": True, "spec_decode": 1}, "chunked_prefill rides"),
    ({"spec_sample": True}, "spec_sample needs"),
    ({"spec_decode": 4, "ragged_tokens": 8}, "chunk width 4")])
def test_spec_options_raise_value_errors(tparams, kw, match):
    with pytest.raises(ValueError, match=match):
        P.ServingEngine(tparams, CFG, max_seqs=3, max_seq_len=64,
                        page_size=8, device="cpu", **kw)
