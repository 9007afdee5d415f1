"""KV handoff (`serving/handoff.py` and the engine's export and import)
held to the JAX package's engine (`use_pallas=False`) on the CPU, at
LlamaConfig.tiny widths.

A prefill engine exports each flagged request once its prompt is seeded;
a decode engine imports the payload (as the JAX scheduler re-submits
it: output, next_token and cached_tokens carried over) and decodes on.
The pair must give the single engine's tokens:

  * port to port, per engine (ragged and bucketed, each under `run` and
    `run_pipelined`, and bucketed chunked spec), pool (fp32, int8) and tier
    encoding (int8 or verbatim), with shared-header prompts on the
    prefix cache; equal `handoff_bytes` on both sides, both pools
    drained and conserved;
  * JAX export, port import, and port export, JAX import
    (`handoff_from_jax` / `handoff_to_jax`, bytes unchanged);
  * a failed export leaves the request to decode locally, a failed
    import falls back to recomputing prompt + output (both made to fail
    by monkeypatching), each counted in `handoff_failures`.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import llama_serving as J
from paddle_tpu.models import llama_spmd as JM
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.serving.handoff import KVHandoff as JKVHandoff
from paddle_tpu_torch.models import llama_serving as P
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.llama_spmd import params_from_jax
from paddle_tpu_torch.serving.handoff import (KVHandoff, handoff_from_jax,
                                              handoff_to_jax)

DIMS = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64,
            seq=128)
JCFG = JConfig.tiny(**DIMS)
CFG = LlamaConfig.tiny(**DIMS)
HEADER = [7, 3, 7, 3, 7, 3, 7, 3, 9, 1, 9, 1, 9, 1, 9, 1]
PROMPTS = [HEADER + [11, 12], [2, 4, 6, 8, 10, 12, 14], HEADER + [13],
           [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]]
NEW = 6
ENGINES = {
    "ragged": {},
    "ragged_pipelined": {"pipelined": True},
    "bucketed": {"ragged": False},
    "bucketed_pipelined": {"ragged": False, "pipelined": True},
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
          "prefix_cache": True, "host_tier_bytes": 1 << 20, **extra, **kw}
    eng = mod.ServingEngine(params, cfg, **kw)
    return eng, (eng.run_pipelined if pipelined else eng.run)


def _single(mod, params, pipelined=False, **kw):
    eng, run = _engine(mod, params, pipelined, **kw)
    for i, p in enumerate(PROMPTS):
        eng.submit(mod.Request(i, p, max_new_tokens=NEW))
    return {r.rid: [int(t) for t in r.output] for r in run()}


def _export(mod, params, pipelined=False, **kw):
    """Run every prompt flagged for export; returns (engine, the
    KVHandoffs by rid)."""
    eng, run = _engine(mod, params, pipelined, **kw)
    for i, p in enumerate(PROMPTS):
        r = mod.Request(i, p, max_new_tokens=NEW)
        r._handoff_export = True
        eng.submit(r)
    run()
    return eng, {r.rid: r._handoff_done for r in eng.finished
                 if getattr(r, "_handoff_done", None) is not None}


def _import(mod, params, handoffs, pipelined=False, **kw):
    """Re-submit each payload as the JAX scheduler does; returns (engine,
    tokens by rid)."""
    eng, run = _engine(mod, params, pipelined, **kw)
    for rid in sorted(handoffs):
        h = handoffs[rid]
        r = mod.Request(rid, h.prompt, max_new_tokens=NEW)
        r.output = [int(t) for t in h.output]
        r.next_token = int(h.next_token)
        r.cached_tokens = int(h.cached_tokens)
        r._kv_import = h
        eng.submit(r)
    return eng, {r.rid: [int(t) for t in r.output] for r in run()}


def _drained(eng):
    assert eng.pool.conserved(drained=True), eng.pool.counts()
    assert not eng._live


@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "verbatim"])
@pytest.mark.parametrize("cache", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_port_to_port(params, engine, cache, quantize):
    _, tp = params
    kw = dict(ENGINES[engine], cache_dtype=cache, tier_quantize=quantize)
    want = _single(P, tp, **kw)
    pre, hs = _export(P, tp, **kw)
    assert sorted(hs) == list(range(len(PROMPTS)))
    assert pre.handoff_exports == len(PROMPTS) and pre.handoff_failures == 0
    for h in hs.values():
        assert isinstance(h, KVHandoff)
        assert h.length == len(h.prompt) + len(h.output) - 1
        assert h.quantized == (quantize or cache == "int8")
    dec, got = _import(P, tp, hs, **kw)
    assert got == want
    assert dec.handoff_imports == len(PROMPTS)
    assert pre.handoff_bytes == dec.handoff_bytes > 0
    # the prefix cache served the shared header on the prefill side; a
    # chunked feed is indexed only at its release, and prompt 2 takes
    # prompt 1's slot while prompt 0 is still feeding
    assert hs[2].cached_tokens == (0 if engine == "chunked" else 16)
    _drained(pre)
    _drained(dec)


@pytest.mark.parametrize("cache", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("engine", ["ragged", "bucketed"])
def test_jax_export_port_import(params, engine, cache):
    jp, tp = params
    kw = dict(ENGINES[engine], cache_dtype=cache)
    want = _single(J, jp, **kw)
    pre, jh = _export(J, jp, **kw)
    hs = {rid: handoff_from_jax(h) for rid, h in jh.items()}
    for rid, h in hs.items():
        for name in ("k", "v", "ks", "vs"):
            a, b = getattr(jh[rid], name), getattr(h, name)
            assert (a is None) == (b is None)
            if a is not None:
                assert np.asarray(a).tobytes() == b.numpy().tobytes()
        assert h.nbytes == jh[rid].nbytes
    dec, got = _import(P, tp, hs, **kw)
    assert got == want
    assert dec.handoff_bytes == pre.handoff_bytes
    _drained(dec)
    # the engine also takes the JAX payload as it stands
    _, direct = _import(P, tp, jh, **kw)
    assert direct == want


@pytest.mark.parametrize("cache", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("engine", ["ragged", "bucketed"])
def test_port_export_jax_import(params, engine, cache):
    jp, tp = params
    kw = dict(ENGINES[engine], cache_dtype=cache)
    want = _single(J, jp, **kw)
    pre, hs = _export(P, tp, **kw)
    jh = {rid: handoff_to_jax(h, JKVHandoff) for rid, h in hs.items()}
    for rid, h in jh.items():
        assert isinstance(h, JKVHandoff) and h.nbytes == hs[rid].nbytes
        assert h.k.tobytes() == hs[rid].k.numpy().tobytes()
    dec, got = _import(J, jp, jh, **kw)
    assert got == want
    assert dec.handoff_imports == len(PROMPTS)
    assert dec.handoff_bytes == pre.handoff_bytes


def test_bf16_payload_keeps_its_bytes_both_ways():
    """numpy has no bfloat16: a bf16 payload crosses as ml_dtypes'
    bfloat16 array and back with the same 16-bit patterns."""
    k = torch.randn(2, 2, 3, 8, 4).to(torch.bfloat16)
    h = KVHandoff("r", [1, 2], [3], 3, 2, 3, k, k.clone())
    j = handoff_to_jax(h, JKVHandoff)
    assert j.k.dtype.name == "bfloat16" and j.nbytes == h.nbytes
    back = handoff_from_jax(j)
    assert back.k.dtype == torch.bfloat16 and torch.equal(back.k, k)
    assert (back.prompt, back.output, back.length) == ([1, 2], [3], 2)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_failed_export_decodes_locally(params, monkeypatch, engine):
    _, tp = params
    want = _single(P, tp, **ENGINES[engine])
    eng, run = _engine(P, tp, **ENGINES[engine])

    def broken(*a, **k):
        raise RuntimeError("export failed")
    monkeypatch.setattr(eng.host_tier, "export_pages", broken)
    for i, p in enumerate(PROMPTS):
        r = P.Request(i, p, max_new_tokens=NEW)
        r._handoff_export = True
        eng.submit(r)
    done = run()
    assert {r.rid: r.output for r in done} == want
    assert all(r._handoff_done is None for r in done)
    assert eng.handoff_failures == len(PROMPTS)
    assert eng.handoff_exports == 0 and eng._handoff_pending == 0
    _drained(eng)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_failed_import_recomputes(params, monkeypatch, engine):
    _, tp = params
    want = _single(P, tp, **ENGINES[engine])
    _, hs = _export(P, tp, **ENGINES[engine])
    eng, run = _engine(P, tp, **ENGINES[engine])

    def broken(*a, **k):
        raise RuntimeError("scatter failed")
    monkeypatch.setattr(eng, "_scatter_host_kv", broken)
    for rid in sorted(hs):
        h = hs[rid]
        r = P.Request(rid, h.prompt, max_new_tokens=NEW)
        r.output, r.next_token = list(h.output), h.next_token
        r._kv_import = h
        eng.submit(r)
    done = run()
    assert {r.rid: r.output for r in done} == want
    assert eng.handoff_failures == len(PROMPTS)
    assert eng.handoff_imports == 0 and eng.handoff_bytes == 0
    _drained(eng)
