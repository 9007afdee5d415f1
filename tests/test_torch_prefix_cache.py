"""paddle_tpu_torch's prefix KV cache and host tier in the serving engine,
held to the JAX package's engine (`use_pallas=False`) with the same
options on the CPU, at LlamaConfig.tiny widths.

One conversation script per engine (ragged under `run` and
`run_pipelined`, bucketed, bucketed chunked spec) and pool
(fp32, int8): shared-header prompts (the later two map the first one's
pages), a first turn, a burst of distinct prompts that evicts it (the
tier takes the evicted pages), and the returning turn (restored from the
tier). Tokens, `cached_tokens`, `prefill_tokens`, `pool.counts()` and
`host_tier.stats()` must equal the JAX engine's after every phase; the
tier off must give the same tokens; the ragged token ring must hold the
token the feed's cursor points at.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

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
HEADER = [7, 3, 7, 3, 7, 3, 7, 3, 9, 1, 9, 1, 9, 1, 9, 1]   # two pages
TURN1 = list(range(1, 13))           # with 6 generated: 2 full pages
ENGINES = {
    "ragged": {},
    "ragged_pipelined": {"pipelined": True},
    "bucketed": {"ragged": False},
    "chunked": {"ragged": False, "spec_decode": 4, "chunked_prefill": True},
}


@pytest.fixture(scope="module")
def params():
    jp = JM.init_params(JCFG, seed=0, dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _engine(mod, params, pipelined=False, **kw):
    cfg, extra = (JCFG, {"use_pallas": False}) if mod is J else \
        (CFG, {"device": "cpu"})
    kw = {"max_seqs": 2, "max_seq_len": 64, "page_size": 8,
          "num_pages": 11, "prefix_cache": True, **extra, **kw}
    eng = mod.ServingEngine(params, cfg, **kw)
    return eng, (eng.run_pipelined if pipelined else eng.run)


def _conversation(mod, params, pipelined=False, **kw):
    """The script; returns ({rid: (tokens, cached_tokens)}, log of
    (phase, prefill_tokens, pool counts, tier stats))."""
    eng, run = _engine(mod, params, pipelined, **kw)
    log = []

    def phase(tag, reqs):
        for r in reqs:
            eng.submit(r)
        run()
        eng.host_tier.flush(timeout=30)
        log.append((tag, eng.prefill_tokens, eng.pool.counts(),
                    eng.host_tier.stats()))
    R = mod.Request
    phase("header", [R("a", HEADER + [11, 12], max_new_tokens=6)])
    phase("shared", [R("b", HEADER + [13], max_new_tokens=6),
                     R("c", HEADER + [2, 5], max_new_tokens=6)])
    phase("turn1", [R("t1", TURN1, max_new_tokens=6)])
    rng = np.random.RandomState(7)
    for i in range(5):   # distinct leading tokens: nothing shared
        p = [40 + 2 * i] + list(map(int, rng.randint(1, 64, 16)))
        phase(f"burst{i}", [R(f"burst{i}", p, max_new_tokens=6)])
    out1 = [int(t) for t in
            next(r for r in eng.finished if r.rid == "t1").output]
    phase("turn2", [R("t2", TURN1 + out1 + [50, 51], max_new_tokens=6)])
    assert eng.pool.conserved(drained=True)
    return ({r.rid: ([int(t) for t in r.output], r.cached_tokens)
             for r in eng.finished}, log)


@pytest.fixture(scope="module")
def port_run(params):
    """The port's conversation by (engine, pool, tier bytes, quantize),
    each run once for the module."""
    runs = {}

    def run(engine, cache, tier, quantize=True):
        key = (engine, cache, tier, quantize)
        if key not in runs:
            runs[key] = _conversation(
                P, params[1], cache_dtype=cache, host_tier_bytes=tier,
                tier_quantize=quantize, **ENGINES[engine])
        return runs[key]
    return run


@pytest.mark.parametrize("cache", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_prefix_cache_and_tier_match_jax(params, port_run, engine, cache):
    want = _conversation(J, params[0], cache_dtype=cache,
                         host_tier_bytes=1 << 20, **ENGINES[engine])
    got = port_run(engine, cache, 1 << 20)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        assert a == b, a[0]
    reqs, log = got
    # the shared header and the returning turn were served from cache,
    # the latter from the tier; prefill counted only the suffixes
    assert [reqs[r][1] for r in ("a", "b", "c", "t1", "t2")] == \
        [0, 16, 16, 0, 16]
    assert log[1][1] - log[0][1] == (17 - 16) + (18 - 16)
    assert log[-1][1] - log[-2][1] == len(TURN1) + 6 + 2 - 16
    st = log[-1][3]
    assert st["hits"] == 1 and st["restores"] == 2 and st["spills"] > 0
    assert st["copy_errors"] == 0


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_tier_on_equals_tier_off(port_run, engine):
    """Evictions discard (tier off) or demote (tier on, int8 or
    verbatim): the tokens are the same, and only the tier's returning
    turn skips its prefix."""
    off = port_run(engine, None, 0)
    on = port_run(engine, None, 1 << 20)
    verbatim = port_run(engine, None, 1 << 20, quantize=False)
    tokens = {rid: out for rid, (out, _) in off[0].items()}
    for run in (on, verbatim):
        assert {rid: out for rid, (out, _) in run[0].items()} == tokens
        assert run[0]["t2"][1] == 16
    assert off[0]["t2"][1] == 0
    assert off[1][-1][3]["spills"] == 0
    assert verbatim[1][-1][3]["host_bytes"] > on[1][-1][3]["host_bytes"]


def test_tight_tier_budget_drops_and_matches_jax(params):
    """A tier that holds two int8 pages drops the deepest ones first; the
    returning turn then restores what is left, as JAX's does."""
    jp, tp = params
    want = _conversation(J, jp, host_tier_bytes=1600)
    got = _conversation(P, tp, host_tier_bytes=1600)
    assert got == want
    assert got[1][-1][3]["drops"] > 0


@pytest.mark.parametrize("pipelined", [False, True], ids=["run", "pipelined"])
def test_ragged_ring_row_agrees_with_the_cursor(params, pipelined):
    """A prefix hit on the ragged engine starts its feed at the cached
    count: the device token ring holds the whole feed from position 0,
    so the first row fed reads token `cached`, and lengths equal the
    cursor."""
    _, tp = params
    eng, run = _engine(P, tp, pipelined)
    assert eng.tok_buf is not None
    eng.submit(P.Request("a", HEADER + [11, 12], max_new_tokens=4))
    run()
    seen = []
    admit = eng._admit

    def spy():
        admit()
        for s in sorted(eng._live):
            r = eng._slots[s]
            if r.rid == "b" and not seen:
                seen.append((s, r._pf_cursor, int(eng.lengths[s]),
                             eng.tok_buf[s].tolist(), list(r._pf_feed)))
    eng._admit = spy
    eng.submit(P.Request("b", HEADER + [13, 14, 15], max_new_tokens=4))
    run()
    s, cursor, length, ring, feed = seen[0]
    assert cursor == length == 16
    assert ring[:len(feed)] == feed and ring[cursor] == 13
    b = next(r for r in eng.finished if r.rid == "b")
    ref, _ = _engine(P, tp, pipelined, prefix_cache=False)
    ref.submit(P.Request("b", HEADER + [13, 14, 15], max_new_tokens=4))
    assert b.output == ref.run()[0].output and b.cached_tokens == 16
