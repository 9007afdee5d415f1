"""paddle_tpu_torch's serving step and engine held to the JAX package's
on the CPU, at LlamaConfig.tiny widths, with the JAX package's weights
loaded through `params_from_jax`.

  * `unified_step`: logits at the need rows, the in-place pool and token
    ring updates, and the sampled record against JAX's;
  * the sampler: `_filtered_logits` equal to JAX's, and the threefry
    draw (`_prng`) bit-equal to `jax.random.categorical(fold_in(...))`;
  * `ServingEngine(device="cpu")` against the JAX ragged engine on a mix
    of greedy and seeded requests: tokens identical, logprobs within
    1e-4, under `run` and `run_pipelined`, fp32 and int8 pools, both
    preemption policies, and the page pool conserved.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import llama_serving as J
from paddle_tpu.models import llama_spmd as JM
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu_torch import _prng
from paddle_tpu_torch.models import llama_serving as P
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.llama_spmd import init_params, params_from_jax
from paddle_tpu_torch.parallel.mesh import RankMesh

DIMS = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64,
            seq=128)
JCFG = JConfig.tiny(**DIMS)
CFG = LlamaConfig.tiny(**DIMS)
LOGIT_ATOL = 1e-4   # fp32 model; matmul and softmax sums in another order
LP_ATOL = 1e-4


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(JCFG, seed=0, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def test_params_from_jax_keeps_layout_and_values(jparams, tparams):
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == 12
    for path, a in flat_j:
        t = tparams
        for p in path:
            t = t[p.key]
        assert t.dtype == torch.float32 and tuple(t.shape) == a.shape
        assert np.array_equal(t.numpy(), np.asarray(a))


def test_init_params_layout_and_seed():
    a = init_params(CFG, seed=3, device="cpu")
    b = init_params(CFG, seed=3, device="cpu")
    j = JM.init_params(JCFG, seed=3)
    assert set(a) == set(j) and set(a["layers"]) == set(j["layers"])
    for k in a["layers"]:
        assert tuple(a["layers"][k].shape) == j["layers"][k].shape
        assert torch.equal(a["layers"][k], b["layers"][k])
    assert tuple(a["lm_head"].shape) == j["lm_head"].shape
    bf = init_params(CFG, seed=3, dtype=torch.bfloat16, device="cpu")
    assert bf["embed"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------
def _sample_rows(n=12, v=64, seed=0):
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal((n, v)) * 3).astype(np.float32)
    temp = np.where(np.arange(n) % 3 == 0, 0.0,
                    rng.uniform(0.5, 1.5, n)).astype(np.float32)
    top_k = np.array([0, 5, 0, 64, 100, 1] * (n // 6), np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 1.0, 0.3, 0.95] * (n // 6), np.float32)
    keys = rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    fold = rng.integers(0, 4000, n).astype(np.int32)
    return lg, temp, top_k, top_p, keys, fold


def test_filtered_logits_equal_jax():
    lg, temp, top_k, top_p, _, _ = _sample_rows()
    want = np.asarray(J._filtered_logits(
        jnp.asarray(lg), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p)))
    got = P._filtered_logits(torch.from_numpy(lg), torch.from_numpy(temp),
                             torch.from_numpy(top_k), torch.from_numpy(top_p))
    assert np.array_equal(got.numpy(), want)


def test_prng_bits_equal_jax():
    _, _, _, _, keys, fold = _sample_rows(n=24)
    jk = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(fold))
    tk = _prng.fold_in(torch.from_numpy(keys.astype(np.int64)),
                       torch.from_numpy(fold))
    assert np.array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    n = 1001   # odd: no even-size assumption in the counter layout
    jb = jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(jk)
    assert np.array_equal(_prng.random_bits(tk, n).numpy(),
                          np.asarray(jb).astype(np.int64))
    tiny = np.finfo(np.float32).tiny
    ju = jax.vmap(lambda k: jax.random.uniform(
        k, (n,), jnp.float32, minval=tiny, maxval=1.0))(jk)
    assert np.array_equal(_prng.uniform(tk, n).numpy(), np.asarray(ju))


def test_prng_draw_equal_jax_categorical():
    """Bits are exact; the Gumbel noise goes through log, whose last
    bit may differ between libraries, so the draws are compared."""
    lg, _, _, _, keys, fold = _sample_rows(n=60, v=300)
    jk = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(fold))
    want = np.asarray(jax.vmap(jax.random.categorical)(jk, jnp.asarray(lg)))
    tk = _prng.fold_in(torch.from_numpy(keys.astype(np.int64)),
                       torch.from_numpy(fold))
    got = _prng.categorical(tk, torch.from_numpy(lg))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_filter_draw_equal_jax():
    lg, temp, top_k, top_p, keys, fold = _sample_rows(n=18)
    jt, jlp = J._filter_draw(jnp.asarray(lg), jnp.asarray(temp),
                             jnp.asarray(top_k), jnp.asarray(top_p),
                             jnp.asarray(keys), jnp.asarray(fold))
    tt, tlp = P._filter_draw(torch.from_numpy(lg), torch.from_numpy(temp),
                             torch.from_numpy(top_k), torch.from_numpy(top_p),
                             torch.from_numpy(keys.astype(np.int64)),
                             torch.from_numpy(fold))
    assert np.array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-6)


# ---------------------------------------------------------------------------
# unified_step
# ---------------------------------------------------------------------------
def _wave(quant, seed=0):
    """Pools filled with random KV, a page table, and one mixed wave: a
    5-token prefill on slot 0, decodes on slots 1 and 2, 3 slack rows."""
    rng = np.random.default_rng(seed)
    L, KVH, PG, PPS, B = 2, 2, 8, 4, 3
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
    tokens = rng.integers(0, DIMS["vocab"], 10).astype(np.int32)
    tok_slot = np.array([0, 0, 0, 0, 0, 1, 2, 0, 0, 0], np.int32)
    tok_pos = np.array([0, 1, 2, 3, 4, 15, 9, -1, -1, -1], np.int32)
    sample = {"temp": np.array([0.0, 0.8, 1.1], np.float32),
              "top_k": np.array([0, 8, 0], np.int32),
              "top_p": np.array([1.0, 0.9, 1.0], np.float32),
              "key": np.array([[0, 0], [0, 123], [0, 7]], np.uint32),
              "eos": np.array([-1, -1, 5], np.int32),
              "remaining": np.array([3, 1, 5], np.int32)}
    tok_buf = rng.integers(0, DIMS["vocab"], (B, 33)).astype(np.int32)
    return dict(kp=kp, vp=vp, ks=ks, vs=vs, ptab=ptab, tokens=tokens,
                tok_slot=tok_slot, tok_pos=tok_pos, sample=sample,
                tok_buf=tok_buf, page=PG)


def _run_jax(jparams, w, need=None, tok_buf=False):
    jn = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    kw = {}
    if tok_buf:
        e = len(need) if need is not None else len(w["tokens"])
        bw = np.zeros(e, bool)
        bw[:2] = True
        kw = {"tok_buf": jnp.asarray(w["tok_buf"]),
              "buf_write": jnp.asarray(bw)}
    out = J.unified_step(
        jparams, jn(w["kp"]), jn(w["vp"]), jn(w["ptab"]), jn(w["tokens"]),
        jn(w["tok_slot"]), jn(w["tok_pos"]), JCFG, w["page"],
        use_pallas=False, k_scale=jn(w["ks"]), v_scale=jn(w["vs"]),
        sample={k: jnp.asarray(v) for k, v in w["sample"].items()},
        need_rows=jn(need), **kw)
    return [None if a is None else np.asarray(a) for a in out[:5]] + \
        [tuple(np.asarray(x) for x in out[5])] + \
        ([np.asarray(out[6])] if tok_buf else [])


def _run_torch(tparams, w, need=None, tok_buf=False):
    t = lambda a: None if a is None else torch.from_numpy(a.copy())  # noqa
    pools = [t(w["kp"]), t(w["vp"]), t(w["ks"]), t(w["vs"])]
    sample = {k: torch.from_numpy(v.astype(np.int64) if k == "key" else v)
              for k, v in w["sample"].items()}
    kw = {}
    buf = None
    if tok_buf:
        e = len(need) if need is not None else len(w["tokens"])
        bw = torch.zeros(e, dtype=torch.bool)
        bw[:2] = True
        buf = t(w["tok_buf"])
        kw = {"tok_buf": buf, "buf_write": bw}
    logits, rec = P.unified_step(
        tparams, pools[0], pools[1], t(w["ptab"]), t(w["tokens"]),
        t(w["tok_slot"]), t(w["tok_pos"]), CFG, w["page"],
        k_scale=pools[2], v_scale=pools[3], sample=sample,
        need_rows=t(need), **kw)
    out = [None if a is None else a.numpy() for a in pools] + \
        [logits.numpy(), tuple(x.numpy() for x in rec)]
    return out + ([buf.numpy()] if tok_buf else [])


NEED = np.array([5, 6, 4, -1], np.int32)   # two decodes, the seed row, pad


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "full"])
def test_unified_step_matches_jax(jparams, tparams, quant, lean):
    w = _wave(quant)
    need = NEED if lean else None
    jo = _run_jax(jparams, w, need)
    to = _run_torch(tparams, w, need)
    assert to[4].shape == jo[4].shape
    np.testing.assert_allclose(to[4], jo[4], atol=LOGIT_ATOL, rtol=0)
    # the pools the port updated in place equal JAX's returned ones
    if quant:
        for i in range(4):
            # int8 codes: a K/V value at a rounding edge may land one
            # code apart; scales agree to fp32 rounding
            d = np.abs(to[i].astype(np.float64) - jo[i].astype(np.float64))
            assert d.max() <= (1 if i < 2 else 1e-6), i
    else:
        np.testing.assert_allclose(to[0], jo[0], atol=1e-5, rtol=0)
        np.testing.assert_allclose(to[1], jo[1], atol=1e-5, rtol=0)
    jt, jd, jlp = jo[5]
    tt, td, tlp = to[5]
    assert np.array_equal(tt, jt.astype(np.int64))
    assert np.array_equal(td, jd)
    np.testing.assert_allclose(tlp, jlp, atol=LP_ATOL)


def test_unified_step_tok_buf_matches_jax(jparams, tparams):
    w = _wave(False, seed=1)
    jo = _run_jax(jparams, w, NEED, tok_buf=True)
    to = _run_torch(tparams, w, NEED, tok_buf=True)
    np.testing.assert_allclose(to[4], jo[4], atol=LOGIT_ATOL, rtol=0)
    assert np.array_equal(to[5][0], jo[5][0].astype(np.int64))
    # JAX drops the writes of unmarked rows; the port parks them on the
    # never-consumed last column — every consumed column must agree
    assert np.array_equal(to[6][:, :-1], jo[6][:, :-1])
    assert not np.array_equal(to[6][:, :-1], w["tok_buf"][:, :-1])


def test_lean_and_full_epilogues_give_equal_tokens(tparams):
    w = _wave(False, seed=2)
    lean = _run_torch(tparams, w, NEED)
    full = _run_torch(tparams, w, None)
    rows = NEED[NEED >= 0]
    for a, b in zip(lean[5], full[5]):
        np.testing.assert_array_equal(a[:len(rows)], b[rows])


def test_unified_step_carry_operands(tparams):
    """carry_tok[carry_gather[i]] replaces row i's token where
    carry_mask is set — the same step as feeding that token directly."""
    w = _wave(False, seed=3)
    direct = _run_torch(tparams, w, NEED)
    t = torch.from_numpy
    sample = {k: t(v.astype(np.int64) if k == "key" else v)
              for k, v in w["sample"].items()}
    toks = w["tokens"].copy()
    want_tok = int(toks[5])
    toks[5] = 0
    mask = torch.zeros(10, dtype=torch.bool)
    mask[5] = True
    gather = torch.zeros(10, dtype=torch.int32)
    gather[5] = 2
    carry = torch.tensor([9, 9, want_tok, 9], dtype=torch.int64)
    kp, vp = t(w["kp"].copy()), t(w["vp"].copy())
    logits, _ = P.unified_step(
        tparams, kp, vp, t(w["ptab"]), t(toks), t(w["tok_slot"]),
        t(w["tok_pos"]), CFG, w["page"], sample=sample, carry_tok=carry,
        carry_gather=gather, carry_mask=mask, need_rows=t(NEED))
    np.testing.assert_array_equal(logits.numpy(), direct[4])


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
MIX = [("g0", [1, 5, 9, 3, 7], {}),
       ("s0", [2, 4, 6], dict(temperature=0.8, top_k=8, top_p=0.9, seed=123)),
       ("g1", [9, 9, 2], dict(logprobs=True)),
       ("s1", [7, 1], dict(temperature=1.1, seed=7, logprobs=True)),
       ("g2", [3, 3, 3, 8, 1, 4, 4, 2, 6], dict(logprobs=True)),
       ("s2", [6, 2, 8, 4], dict(temperature=0.7, top_p=0.8, seed=99))]


def _submit(eng, R, max_new):
    for rid, prompt, kw in MIX:
        eng.submit(R(rid, prompt, max_new_tokens=max_new, **kw))


def _serve_jax(jparams, kw, max_new, max_seq_len):
    eng = J.ServingEngine(jparams, JCFG, max_seqs=3, max_seq_len=max_seq_len,
                          page_size=8, use_pallas=False, ragged=True, **kw)
    _submit(eng, J.Request, max_new)
    done = eng.run()
    return {r.rid: (list(r.output), r.logprobs) for r in done}, eng


def _serve_torch(tparams, kw, max_new, max_seq_len, pipelined):
    eng = P.ServingEngine(tparams, CFG, max_seqs=3, max_seq_len=max_seq_len,
                          page_size=8, device="cpu", **kw)
    _submit(eng, P.Request, max_new)
    done = eng.run_pipelined() if pipelined else eng.run()
    assert eng.pool.conserved(drained=True)
    assert not eng._live and not eng._waiting
    return {r.rid: (list(r.output), r.logprobs) for r in done}, eng


def _assert_same(got, want):
    assert set(got) == set(want) == {m[0] for m in MIX}
    for rid, (toks, lps) in want.items():
        assert got[rid][0] == [int(t) for t in toks], rid
        if lps is None:
            assert got[rid][1] is None
        else:
            np.testing.assert_allclose(got[rid][1], lps, atol=LP_ATOL)


ENGINE_MODES = {
    "fp32": ({}, 10, 64),
    "int8": ({"cache_dtype": "int8"}, 10, 64),
    "host_tokens": ({"tokbuf": False}, 10, 64),
    "full_epilogue": ({"lean": False}, 10, 64),
    "preempt_offload": ({"num_pages": 6, "preempt_policy": "offload"},
                        20, 32),
    "preempt_recompute": ({"num_pages": 6, "preempt_policy": "recompute"},
                          20, 32),
    "preempt_int8": ({"num_pages": 6, "cache_dtype": "int8"}, 20, 32),
}


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
def test_engine_matches_jax_engine(jparams, tparams, mode):
    kw, max_new, msl = ENGINE_MODES[mode]
    want, jeng = _serve_jax(jparams, kw, max_new, msl)
    for pipelined in (False, True):
        got, eng = _serve_torch(tparams, kw, max_new, msl, pipelined)
        _assert_same(got, want)
        assert eng.preemptions == jeng.preemptions
        if "num_pages" in kw:
            assert eng.preemptions > 0
            assert eng.host_tier.host_bytes == 0    # every stash taken back


def test_eos_finish_rolls_back_overrun(tparams, jparams):
    """An eos finish is not host-predictable: the pipelined loop runs
    the slot one zombie step past its end and rolls it back. The eos is
    chosen where it first occurs in the probe's output, so the request
    must stop right there."""
    prompt = [2, 4, 2, 4, 2]
    probe = P.ServingEngine(tparams, CFG, max_seqs=1, max_seq_len=64,
                            page_size=8, device="cpu")
    probe.submit(P.Request("p", prompt, max_new_tokens=12))
    ref = probe.run()[0].output
    idx = next(i for i in range(2, len(ref)) if ref[i] not in ref[:i])
    eos = ref[idx]
    outs = []
    for pipelined in (False, True):
        eng = P.ServingEngine(tparams, CFG, max_seqs=2, max_seq_len=64,
                              page_size=8, device="cpu")
        eng.submit(P.Request("e", prompt, max_new_tokens=12, eos_id=eos))
        eng.submit(P.Request("g", [9, 8, 7], max_new_tokens=9))
        done = eng.run_pipelined() if pipelined else eng.run()
        outs.append({r.rid: r.output for r in done})
        assert eng.pool.conserved(drained=True)
        assert eng.lengths.sum() == 0
    assert outs[0] == outs[1]
    assert outs[0]["e"] == ref[:idx + 1]
    jeng = J.ServingEngine(jparams, JCFG, max_seqs=2, max_seq_len=64,
                           page_size=8, use_pallas=False, ragged=True)
    jeng.submit(J.Request("e", prompt, max_new_tokens=12, eos_id=eos))
    jeng.submit(J.Request("g", [9, 8, 7], max_new_tokens=9))
    assert {r.rid: [int(t) for t in r.output]
            for r in jeng.run_pipelined()} == outs[0]


def test_cancel_queued_and_active(tparams):
    eng = P.ServingEngine(tparams, CFG, max_seqs=1, max_seq_len=64,
                          page_size=8, device="cpu")
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


def _tp_mesh(n):
    """A tp mesh of n ranks seen from rank 0, without process groups:
    what the engine's constructor checks before it needs them."""
    return RankMesh(np.arange(n), ("tp",), rank=0)


@pytest.mark.parametrize("kw,item", [
    pytest.param({"mesh": _tp_mesh(2), "prefix_cache": True,
                  "host_tier_bytes": 1 << 20}, "10c", id="kw3-10c")])
def test_unported_options_name_their_roadmap_item(tparams, kw, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        P.ServingEngine(tparams, CFG, device="cpu", **kw)


@pytest.mark.parametrize("axes", [{"tp": 1}, {"dp": 2}], ids=["tp1", "dp"])
def test_mesh_option_builds(tparams, axes):
    """`mesh=`, which raised naming Queue 1 item 10b, builds: a mesh of
    one tp rank or without a tp axis serves unsharded, as without a
    mesh (tp meshes of two ranks: tests/test_torch_serving_tp.py)."""
    sizes = list(axes.values())
    mesh = RankMesh(np.arange(int(np.prod(sizes))).reshape(sizes),
                    list(axes), rank=0)
    outs = []
    for m in (mesh, None):
        eng = P.ServingEngine(tparams, CFG, max_seqs=2, max_seq_len=64,
                              page_size=8, mesh=m, device="cpu")
        assert eng._par is None and eng.ragged
        eng.submit(P.Request("a", [1, 5, 9, 3], max_new_tokens=6))
        outs.append(eng.run()[0].output)
    assert outs[0] == outs[1]


def test_faults_option_builds_and_fires(tparams, monkeypatch):
    """`faults=`, which raised naming Queue 1 item 7, arms a FaultPlan
    at the engine's and the tier's failure sites; crash_reset leaves the
    engine empty and servable. Without it the plan comes from
    PT_FAULTS."""
    from paddle_tpu_torch.serving.faults import FaultPlan, InjectedFault
    plan = FaultPlan("step_launch:raise@2")
    eng = P.ServingEngine(tparams, CFG, max_seq_len=64, page_size=8,
                          prefix_cache=True, host_tier_bytes=1 << 20,
                          faults=plan, device="cpu")
    assert eng.faults is plan and eng.host_tier.faults is plan
    eng.submit(P.Request("a", [1, 2, 3], max_new_tokens=4))
    eng.submit(P.Request("b", [4, 5], max_new_tokens=4))
    eng.step()
    with pytest.raises(InjectedFault, match="step_launch"):
        eng.step()
    assert plan.hits["step_launch"] == 2 and len(plan.fired) == 1
    assert eng.crash_reset() == [] and eng.restarts == 1
    assert not eng._live and eng.pool.conserved(drained=True)
    eng.submit(P.Request("c", [1, 2, 3], max_new_tokens=4))
    assert len(eng.run()[-1].output) == 4
    monkeypatch.setenv("PT_FAULTS", "suffix_prefill:delay@1")
    env = P.ServingEngine(tparams, CFG, max_seq_len=64, page_size=8,
                          device="cpu")
    assert "suffix_prefill:delay@1x1" in repr(env.faults)
    monkeypatch.delenv("PT_FAULTS")
    assert P.ServingEngine(tparams, CFG, max_seq_len=64, page_size=8,
                           device="cpu").faults is None


@pytest.mark.parametrize("kw", [
    {"prefix_cache": True},
    {"prefix_cache": True, "host_tier_bytes": 1 << 20}],
    ids=["prefix_cache", "host_tier_bytes"])
def test_item_6_options_are_ported(tparams, kw):
    """The two options that raised naming Queue 1 item 6 build an engine
    whose second request maps the first one's full pages."""
    eng = P.ServingEngine(tparams, CFG, max_seq_len=64, page_size=8,
                          device="cpu", **kw)
    assert eng.pool.cache is eng.prefix_cache is not None
    assert eng.host_tier.enabled == ("host_tier_bytes" in kw)
    assert (eng.prefix_cache.on_spill is not None) == eng.host_tier.enabled
    header = list(range(1, 17))
    for rid, tail in (("a", [20, 21]), ("b", [22])):
        eng.submit(P.Request(rid, header + tail, max_new_tokens=3))
        eng.run()
    got = {r.rid: r for r in eng.finished}
    assert (got["a"].cached_tokens, got["b"].cached_tokens) == (0, 16)
    assert eng.prefill_tokens == 18 + 1
    assert eng.pool.conserved(drained=True)
    if "host_tier_bytes" in kw:
        with pytest.raises(ValueError, match="needs prefix_cache"):
            P.ServingEngine(tparams, CFG, device="cpu",
                            host_tier_bytes=1 << 20)


def test_metrics_hook_counts_a_short_run(tparams):
    """The `metrics` hook, which raised naming Queue 1 item 7, takes an
    EngineMetrics that counts submits, tokens, finishes, steps, TTFT and
    TPOT of a short run."""
    from paddle_tpu_torch.serving.metrics import EngineMetrics, \
        MetricsRegistry
    eng = P.ServingEngine(tparams, CFG, max_seq_len=64, page_size=8,
                          device="cpu")
    reg = MetricsRegistry()
    eng.metrics = m = EngineMetrics(reg)
    for rid, prompt in (("a", [1, 2, 3]), ("b", [4, 5, 6, 7, 8, 9, 10])):
        eng.submit(P.Request(rid, prompt, max_new_tokens=5))
    done = eng.run()
    assert m.accepted.value == 2 and m.completed.value == 2
    assert m.tokens.value == sum(len(r.output) for r in done) == 10
    assert m.ttft.count == 2 and m.tpot.count == 8
    assert m.steps.value == eng.device_steps > 0
    assert m.page_allocs.value > 0
    text = reg.render_prometheus()
    assert "pt_serving_generated_tokens_total 10" in text


def test_handoff_flags_are_ported(tparams):
    """A request flagged for export, which raised naming item 6, leaves
    with its KV as a KVHandoff once its prompt is seeded."""
    eng = P.ServingEngine(tparams, CFG, max_seq_len=64, page_size=8,
                          device="cpu")
    req = P.Request("h", [1, 2], max_new_tokens=2)
    req._handoff_export = True
    eng.submit(req)
    eng.run()
    h = req._handoff_done
    assert req in eng.finished and eng.handoff_exports == 1
    assert (h.length, h.pages, h.output) == (2, 1, req.output)
    assert eng.handoff_bytes == h.nbytes > 0
    assert eng.pool.conserved(drained=True)


def test_kvcache_copy_matches_reference():
    """The port's PagePool/PrefixCache copy takes the reference's
    decisions on one script of allocations, sharing, parking and
    eviction, and calls its eviction hooks (`on_spill` with the evicted
    block's parent, tokens and depth, then `on_evict`) in the same
    order."""
    from paddle_tpu.serving import kvcache as jkv
    from paddle_tpu_torch.serving import kvcache as tkv
    trace = []
    for kv in (jkv, tkv):
        cache = kv.PrefixCache(4)
        pool = kv.PagePool(6, cache=cache)
        log = []
        cache.on_spill = lambda *a, log=log: log.append(("spill",) + a)
        cache.on_evict = lambda page, log=log: log.append(("evict", page))
        a = pool.alloc(3)
        cache.insert(list(range(12)), a, 12)
        log.append(cache.match(list(range(13))))
        pool.incref(a[:2])
        pool.decref(reversed(a))
        log.append((pool.counts(), cache.cached_pages))
        b = pool.alloc(4)                      # reclaims one parked page
        log.append((b, pool.counts(), cache.evictions, cache.stats()))
        pool.decref(a[:2])
        pool.decref(b)
        log.append((pool.counts(), pool.conserved(drained=True)))
        with pytest.raises(RuntimeError, match="underflow"):
            pool.decref([b[0]])
        # a second chain, released tail first, then reclaimed whole: the
        # LRU gives back its deepest block first
        c = pool.alloc(3)
        cache.insert(list(range(50, 62)), c, 12)
        pool.decref(reversed(c))
        log.append((pool.alloc(6), pool.counts(), cache.evictions))
        trace.append(log)
    assert trace[0] == trace[1]
    spills = [e for e in trace[1] if isinstance(e, tuple) and
              e[0] == "spill"]
    # depths (1-based) in eviction order: the first chain's leaf, its
    # parked root and middle (least recently released first), then the
    # second chain leaf first
    assert [e[4] for e in spills] == [3, 1, 2, 3, 2, 1]


def test_validate_rejects_oversize(tparams):
    eng = P.ServingEngine(tparams, CFG, max_seq_len=16, page_size=8,
                          device="cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(P.Request("x", list(range(10)), max_new_tokens=10))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(P.Request("y", [], max_new_tokens=1))
