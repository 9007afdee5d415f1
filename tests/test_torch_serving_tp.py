"""paddle_tpu_torch's tensor-parallel serving held to the JAX package's
`ServingEngine(..., mesh=)` on the CPU.

Both engines start from the JAX package's weights at LlamaConfig.tiny
widths (4 query heads over 2 KV heads, vocabulary 64). The JAX side
runs its tp engine (`use_pallas=False`, and once with the Pallas kernels
in interpret mode) on 2 of conftest's CPU devices; the port's runs in 2
gloo ranks on a tp mesh, spawned once for the module
(`tests/_torch_ranks.serve_tp_cases`, a deadline) while JAX computes.
Each case mirrors a test of the JAX package's `TestTensorParallelServing`
(`tests/test_serving.py`) or `TestPrefixTensorParallel`
(`tests/test_kvcache.py`): greedy, int8 pools, speculative decoding at
G = 4, chunked prefill with spec and int8 together, offload preemption
and a prefix-cache hit. On both ranks the tokens equal JAX's tp
engine's, the logprobs agree within LP_ATOL (fp32 model; the tp sums
run in another order), and each rank's page pool is conserved. The
refusals (tp not dividing the KV heads, ragged=True under a tp mesh,
the host tier and handoffs under one) and the dp-only mesh run in this
process; `launch.serve` drives a tp engine in lockstep and raises when
ranks finish other tokens."""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import _torch_ranks as R
from paddle_tpu.models import llama_serving as J
from paddle_tpu.models import llama_spmd as JM
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu_torch.distributed import launch
from paddle_tpu_torch.models import llama_serving as P
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.llama_spmd import params_from_jax
from paddle_tpu_torch.parallel.mesh import RankMesh

DIMS = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64,
            seq=128)
JCFG = JConfig.tiny(**DIMS)
CFG = LlamaConfig.tiny(**DIMS)
TP = 2
DEADLINE_S = 240
LP_ATOL = 1e-4          # fp32 logprobs, as tests/test_torch_serving_bucketed
STEP_ATOL = 1e-5        # fp32 logits and K/V of one step, tp 2 against tp 1
PAGE = 8

PROMPTS = [[3, 7, 2, 9, 11], [5, 1, 4], [8, 8, 2, 6, 7, 1]]
SPEC_PROMPT = [3, 9, 4, 3, 9, 4, 3, 9, 4, 3, 9]
CHUNK_PROMPT = [int(t) for t in np.random.RandomState(3).randint(1, 64, 21)]
PREFIX = list(range(1, 17))


def _reqs(prompts, new, **kw):
    return [dict(rid=f"r{i}", prompt_ids=p, max_new_tokens=new,
                 logprobs=True, **kw) for i, p in enumerate(prompts)]


# name -> (engine options, request batches: each submitted, then run)
CASES = {
    "greedy": (dict(max_seqs=3, max_seq_len=64), [_reqs(PROMPTS, 10)]),
    "int8": (dict(max_seqs=3, max_seq_len=64, cache_dtype="int8"),
             [_reqs(PROMPTS, 10)]),
    "spec": (dict(max_seqs=2, max_seq_len=128, spec_decode=4),
             [_reqs([SPEC_PROMPT], 16)]),
    "chunked_spec_int8": (dict(max_seqs=2, max_seq_len=64, spec_decode=4,
                               chunked_prefill=True, cache_dtype="int8"),
                          [_reqs([CHUNK_PROMPT], 10)]),
    "offload": (dict(max_seqs=2, max_seq_len=32, num_pages=5,
                     preempt_policy="offload"),
                [_reqs([[3, 7, 2, 9], [1, 4, 6, 2]], 20)]),
    "prefix": (dict(max_seqs=2, max_seq_len=64, prefix_cache=True),
               [_reqs([PREFIX + [20, 21]], 8),
                [dict(rid="b", prompt_ids=PREFIX + [30, 31, 32],
                      max_new_tokens=8, logprobs=True)]]),
}


def _steps_inputs():
    """One decode step's and one verify chunk's inputs (3 slots, one
    inactive; one sampled slot) over pools of random K/V."""
    rng = np.random.default_rng(5)
    B, L, kvh, hd = 3, DIMS["layers"], DIMS["kv_heads"], 8
    n_pages = 3 * 4 + 1
    pool = (L, kvh, n_pages, PAGE, hd)
    return {"k_pool": rng.standard_normal(pool, np.float32),
            "v_pool": rng.standard_normal(pool, np.float32),
            "page_table": np.arange(12, dtype=np.int32).reshape(3, 4),
            "lengths": np.array([9, 17, 0], np.int32),
            "tokens": np.array([5, 60, 0], np.int32),
            "active": np.array([True, True, False]),
            "chunk": rng.integers(0, 64, (B, 4)).astype(np.int32),
            "n_tok": np.array([4, 2, 0], np.int32),
            "temp": np.array([0.0, 0.8, 0.0], np.float32),
            "top_k": np.array([0, 8, 0], np.int32),
            "top_p": np.array([1.0, 0.9, 1.0], np.float32),
            "key": np.array([[0, 0], [0, 7], [0, 0]], np.int64),
            "eos": np.full((B,), -1, np.int32),
            "remaining": np.full((B,), 4, np.int32)}


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(JCFG, seed=0, dtype=jnp.float32)


def _np_params(jparams):
    return jax.tree.map(np.asarray, jparams)


def _jax_mesh(axis="tp"):
    return Mesh(np.asarray(jax.devices()[:TP]).reshape(TP), (axis,))


def _jax_case(jparams, case, mesh, **extra):
    kw, batches = case
    eng = J.ServingEngine(jparams, JCFG, page_size=PAGE, mesh=mesh,
                          **{**kw, "use_pallas": False, **extra})
    for batch in batches:
        for spec in batch:
            spec = dict(spec)
            eng.submit(J.Request(spec.pop("rid"), spec.pop("prompt_ids"),
                                 **spec))
        eng.run(max_steps=500)
    return eng


def _jax_out(eng):
    return ({r.rid: [int(t) for t in r.output] for r in eng.finished},
            {r.rid: list(r.logprobs) for r in eng.finished})


@pytest.fixture(scope="module")
def results(jparams, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("store"))
    data = {"params": _np_params(jparams), "dims": DIMS,
            "page_size": PAGE, "steps": _steps_inputs(),
            "cases": {name: {"engine": dict(kw, page_size=PAGE),
                             "batches": batches}
                      for name, (kw, batches) in CASES.items()}}
    with ThreadPoolExecutor(1) as pool:
        # the ranks serve while the JAX side compiles
        fut = pool.submit(launch.spawn, R.serve_tp_cases, TP, "gloo", "cpu",
                          DEADLINE_S, args=(data,), threads=1,
                          store_dir=store)
        mesh = _jax_mesh()
        jax_out = {}
        for name, case in CASES.items():
            eng = _jax_case(jparams, case, mesh)
            jax_out[name] = _jax_out(eng) + (eng,)
        eng = _jax_case(jparams, CASES["greedy"], mesh,
                        **{"use_pallas": True, "interpret": True})
        jax_out["greedy_pallas"] = _jax_out(eng) + (eng,)
        ranks = fut.result()
    return {"jax": jax_out, "ranks": ranks}


@pytest.mark.parametrize("name", list(CASES))
def test_tp2_engine_matches_jax_tp2_engine(results, name):
    """Tokens identical to JAX's tp engine on both ranks, logprobs
    within LP_ATOL, and each rank's pool conserved and cut over its KV
    heads."""
    want_out, want_lp, jeng = results["jax"][name]
    for rank, res in enumerate(results["ranks"]):
        got = res[name]
        assert got["out"] == want_out, (rank, got["out"], want_out)
        for rid, lps in want_lp.items():
            np.testing.assert_allclose(got["lp"][rid], lps, atol=LP_ATOL,
                                       rtol=0, err_msg=f"{rank} {rid}")
        assert got["conserved"], rank
        assert got["pool_shape"][1] == DIMS["kv_heads"] // TP
        assert got["calls"] > 0                 # the collectives ran
    assert results["ranks"][0][name] == results["ranks"][1][name]
    first = results["ranks"][0][name]
    if name == "offload":
        assert first["preemptions"] > 0
        assert first["preemptions"] == jeng.preemptions
    if name.startswith("spec"):
        assert first["spec_accepted"] > 0
        assert first["spec_accepted"] == jeng.spec_accepted
    if name == "prefix":
        assert first["prefix_hits"] >= 1
        assert first["prefix_hits"] == jeng.prefix_cache.hits
        assert first["cached"]["b"] == len(PREFIX)


def test_tp2_engine_matches_jax_pallas_interpret(results):
    """JAX's tp engine with its Pallas kernels in interpret mode (per
    rank under shard_map) gives the port's tp tokens too."""
    want_out, want_lp, _ = results["jax"]["greedy_pallas"]
    for res in results["ranks"]:
        assert res["greedy"]["out"] == want_out
        for rid, lps in want_lp.items():
            np.testing.assert_allclose(res["greedy"]["lp"][rid], lps,
                                       atol=LP_ATOL, rtol=0)


@pytest.mark.parametrize("pools", ["float", "int8"])
@pytest.mark.parametrize("step", ["decode", "verify"])
def test_sharded_step_functions_match_one_rank(results, step, pools):
    """decode_step and verify_step on a rank's shard (tp 2: its heads,
    its pool shard, the sums and the vocabulary gather over the tp
    group) against the full model (tp 1) on the same inputs, on both
    ranks: logits within STEP_ATOL, the same sampled tokens, and the
    K/V each wrote into its pools (this rank's heads) alike."""
    for res in results["ranks"]:
        got = res["steps"][pools]
        one, two = got["tp1"][step], got["tp2"][step]
        np.testing.assert_allclose(two[0], one[0], atol=STEP_ATOL, rtol=0)
        np.testing.assert_array_equal(two[1], one[1])        # tokens
        for a, b in zip(two[2:], one[2:]):
            np.testing.assert_allclose(a, b, atol=STEP_ATOL, rtol=0)
        for a, b in zip(got["tp2"]["pools"], got["tp1"]["pools"]):
            np.testing.assert_allclose(a, b, atol=STEP_ATOL, rtol=0)


def test_init_params_on_a_mesh_draws_each_rank_its_shard(results):
    """`init_params(..., mesh=)` cuts each leaf as it is drawn: the
    shards `place_params` cuts from the whole tree of the same seed."""
    for res in results["ranks"]:
        assert res["init_shards"] and all(res["init_shards"])


@pytest.mark.parametrize("flag", ["export", "import"])
def test_handoff_under_tp_names_its_roadmap_item(results, flag):
    for res in results["ranks"]:
        kind, text = res["refusals"][flag]
        assert kind == "NotImplementedError"
        assert "Queue 1 item 10c" in text


def _local_mesh(axes):
    """A rank mesh of this process as rank 0, without process groups:
    what the constructor checks before it needs them."""
    sizes = list(axes.values())
    return RankMesh(np.arange(int(np.prod(sizes))).reshape(sizes),
                    list(axes), rank=0)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(_np_params(jparams), "cpu")


def test_degenerate_gqa_sharding_rejected(jparams, tparams):
    """tp 4 over 2 KV heads: the JAX engine's ValueError, in its words."""
    with pytest.raises(ValueError, match="num_key_value_heads") as port:
        P.ServingEngine(tparams, CFG, max_seqs=2, mesh=_local_mesh(
            {"tp": 4}), device="cpu")
    jm = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("tp",))
    with pytest.raises(ValueError) as ref:
        J.ServingEngine(jparams, JCFG, max_seqs=2, mesh=jm)
    assert str(port.value) == str(ref.value)


def test_ragged_under_tp_mesh_rejected(jparams, tparams):
    with pytest.raises(ValueError, match="ragged=True does not run under "
                       "tensor parallelism"):
        P.ServingEngine(tparams, CFG, mesh=_local_mesh({"tp": TP}),
                        ragged=True, device="cpu")
    with pytest.raises(ValueError, match="ragged=True does not run under "
                       "tensor parallelism"):
        J.ServingEngine(jparams, JCFG, mesh=_jax_mesh(), ragged=True,
                        use_pallas=False)


def test_host_tier_under_tp_names_its_roadmap_item(tparams):
    with pytest.raises(NotImplementedError, match="Queue 1 item 10c"):
        P.ServingEngine(tparams, CFG, mesh=_local_mesh({"tp": TP}),
                        prefix_cache=True, host_tier_bytes=1 << 20,
                        device="cpu")


def test_dp_only_mesh_is_single_device(jparams, tparams):
    """A mesh without a tp axis builds the unsharded engine, ragged by
    default as without a mesh: the tokens of the engine without a mesh,
    and of JAX's dp-only engine."""
    kw, batches = CASES["greedy"]
    outs = []
    for mesh in (_local_mesh({"dp": 2}), None):
        eng = P.ServingEngine(tparams, CFG, page_size=PAGE, mesh=mesh,
                              device="cpu", **kw)
        assert eng.ragged and eng._par is None
        assert eng.k_pool.shape[1] == DIMS["kv_heads"]
        for spec in batches[0]:
            eng.submit(P.Request(**spec))
        outs.append({r.rid: list(r.output) for r in eng.run()})
        assert eng.pool.conserved(drained=True)
    assert outs[0] == outs[1]
    jeng = _jax_case(jparams, CASES["greedy"], _jax_mesh("dp"))
    assert outs[0] == _jax_out(jeng)[0]


def test_serve_runs_ranks_in_lockstep(results, jparams, tmp_path):
    """`launch.serve` builds a tp engine on each rank, submits the same
    requests and returns rank 0's finished requests: the module's greedy
    tokens."""
    kw, batches = CASES["greedy"]
    data = {"params": _np_params(jparams), "dims": DIMS,
            "engine": dict(kw, page_size=PAGE)}
    done = launch.serve(R.tp_engine, [P.Request(**s) for s in batches[0]],
                        TP, "gloo", "cpu", DEADLINE_S, args=(data,),
                        threads=1, store_dir=str(tmp_path))
    assert {r.rid: list(r.output) for r in done} == \
        results["ranks"][0]["greedy"]["out"]


def test_serve_raises_when_ranks_part(tmp_path):
    """Ranks whose engines draw other tokens (here each rank's own
    unsharded engine from other weights) fail `launch.serve`."""
    data = {"dims": DIMS, "unsharded": True,
            "engine": dict(max_seqs=2, max_seq_len=32, page_size=PAGE)}
    with pytest.raises(RuntimeError, match="left lockstep"):
        launch.serve(R.tp_engine, [P.Request("a", [1, 2, 3],
                                             max_new_tokens=6)],
                     TP, "gloo", "cpu", DEADLINE_S, args=(data,), threads=1,
                     store_dir=str(tmp_path))
