"""paddle_tpu_torch's host KV tier (`serving/kvtier.py`) held to the JAX
package's on the CPU.

  * `_quantize_host` / `_dequantize_host` bit for bit against the
    reference (numpy's half-to-even rounding against torch's), on pages
    with ties, all-zero tokens and bf16-widened values;
  * one script of spills, matches (device-matched skip, the one-token
    cap, a hash collision), budget drops (deepest block first), stash
    use, direct inserts, peeks and exports: payloads, `stats()`,
    `pages`, `hit_rate` and `host_bytes` equal after every step (the
    port's tier takes pages already encoded, here by `_quantize_host`);
  * the snapshot contract: `spill_async` / `export_pages` wait on the
    `ready` object before they read the page.
"""
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.serving import kvcache as jkv
from paddle_tpu.serving import kvtier as JT
from paddle_tpu_torch.serving import kvtier as PT

PS = 2                               # tokens a page
SHAPE = (2, 2, PS, 4)                # (L, KVH, page, D)


def _page(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                                  # an all-zero token
    # ties: absmax 127 makes the scale 1, so x.5 rounds half to even
    x[1, 1, 1, :4] = np.array([127.0, 63.5, -0.5, 1.5], np.float32)
    return x


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_host_quantization_bit_for_bit(seed, bf16):
    x = _page(seed, (3, 4, 8, 16))
    t = torch.from_numpy(x)
    if bf16:
        # a bf16 pool's page: both sides widen the same bf16 values
        t = t.to(torch.bfloat16)
        x = t.to(torch.float32).numpy()
    qj, sj = JT._quantize_host(x)
    qt, st = PT._quantize_host(t)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), qj)
    assert np.array_equal(st.numpy().view(np.int32), sj.view(np.int32))
    dj = JT._dequantize_host(qj, sj)
    dt = PT._dequantize_host(qt, st)
    assert np.array_equal(dt.numpy().view(np.int32), dj.view(np.int32))
    # the engine's int8 pool and tier pages are encoded the same way
    from paddle_tpu_torch.ops.paged_attention import (dequantize_kv,
                                                      quantize_kv)
    qp, sp = quantize_kv(t)
    assert torch.equal(qp, qt) and torch.equal(sp, st)
    assert torch.equal(dequantize_kv(qp, sp), dt)


def _np(a):
    return None if a is None else np.asarray(a)


def _payload(p):
    return {k: _np(v) for k, v in p.items()}


def _same_payload(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k


class _Ready:
    """A `ready` event stand-in: records that the worker waited."""

    def __init__(self):
        self.waited = threading.Event()

    def synchronize(self):
        self.waited.set()


def _script(mod, quantize, budget, host):
    """One script against either tier; returns the log of what it saw.
    `host` turns a numpy page into what that package's tier takes. The
    reference's tier encodes float pages itself; the port's takes them
    in its encoding, which the engine makes on the device and this
    script makes with `_quantize_host`, its plain twin."""
    tier = mod.HostTier(PS, tier_bytes=budget, quantize=quantize)
    log = []

    def encoded(*pages):
        """(k, v) float pages as the tier takes them: (k, v, ks, vs)."""
        if mod is JT:
            return tuple(host(a) for a in pages)
        if not quantize:
            return tuple(host(a) for a in pages) + (None, None)
        (k, ks), (v, vs) = (PT._quantize_host(host(a)) for a in pages)
        return k, v, ks, vs

    def note(tag, out=None):
        log.append((tag, tier.stats(), tier.pages, tier.hit_rate,
                    tier.host_bytes,
                    None if out is None else [_payload(p) for p in out]))
    toks = list(range(1, 12))                         # 5 full blocks + 1
    parent, chain = jkv._SEED, []
    for b in range(5):
        block = tuple(toks[b * PS:(b + 1) * PS])
        chain.append((parent, block))
        parent = jkv.block_hash(parent, block)
    note("empty", tier.match(toks, 0))
    for depth in (0, 1, 2, 3):
        p, blk = chain[depth]
        kw = {}
        if mod is PT:
            kw["ready"] = _Ready()
        tier.spill_async(p, blk, depth,
                         *encoded(_page(depth), _page(10 + depth)), **kw)
        if mod is PT:
            assert tier.flush(timeout=30)
            assert kw["ready"].waited.is_set()
    assert tier.flush(timeout=30)
    note("spilled")
    note("match", tier.match(toks, 0))
    note("skip", tier.match(toks, 2 * PS))             # device had 2 blocks
    note("cap", tier.match(toks[:2 * PS + 1], 0))     # one token short
    note("miss", tier.match([99] + toks[1:], 0))
    # a re-spill of a held block keeps the stored entry
    tier.spill_async(*chain[1], 1, *encoded(_page(50), _page(51)))
    assert tier.flush(timeout=30)
    note("respill", tier.match(toks, 0))
    tier.note_lookup(0)
    tier.note_lookup(3)
    note("lookups")
    # an int8 pool's page rides verbatim with its scales
    q, s = JT._quantize_host(_page(60))
    kw = {"prequantized": True} if mod is JT else {}
    tier.spill_async(*chain[4], 4, host(q), host(q), host(s), host(s), **kw)
    assert tier.flush(timeout=30)
    note("prequantized", tier.match(toks, 0))
    big = {"k": host(np.zeros((2, 2, 3, PS, 4), np.float32)),
           "v": host(np.zeros((2, 2, 3, PS, 4), np.float32)),
           "ks": None, "vs": None}
    tier.stash_put("r0", big, pages=3)                 # pushes spills out
    note("stash")
    with pytest.raises(RuntimeError, match="already held"):
        tier.stash_put("r0", big, pages=3)
    assert tier.stash_take("r0")["k"] is big["k"]
    tier.stash_discard("r0")                           # idempotent
    note("taken")
    other = (jkv._SEED, (20, 21))
    assert tier.insert(*other, 0, {"k": host(_page(70)),
                                   "v": host(_page(71)),
                                   "ks": None, "vs": None})
    assert not tier.insert(*other, 0, {"k": host(_page(72)),
                                       "v": host(_page(73)),
                                       "ks": None, "vs": None})
    e = tier.peek(jkv.block_hash(*other))
    note("peek", [e["payload"]])
    assert tier.peek(12345) is None
    exp = tier.export_pages(*encoded(np.stack([_page(80), _page(81)], 2),
                                     np.stack([_page(82), _page(83)], 2)))
    note("export", [exp])
    return log


@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "verbatim"])
@pytest.mark.parametrize("budget", [1 << 20, 700], ids=["roomy", "tight"])
def test_tier_script_matches_reference(quantize, budget):
    """Spills, matches, drops, stash, inserts, peeks and exports take
    the reference's decisions and hold its bytes: the tight budget
    drops the deepest blocks first (and the stash pushes every spill
    out)."""
    ref = _script(JT, quantize, budget, lambda a: a)
    got = _script(PT, quantize, budget, torch.from_numpy)
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert a[:5] == b[:5], a[0]
        if a[5] is None:
            assert b[5] is None
            continue
        assert len(a[5]) == len(b[5]), a[0]
        for pa, pb in zip(a[5], b[5]):
            _same_payload(pa, pb)
    drops = ref[-1][1]["drops"]
    assert (drops > 0) == (budget == 700)


def test_tier_off_spills_nothing_and_starts_no_thread():
    tier = PT.HostTier(PS)
    assert not tier.enabled
    assert not tier.spill_async(jkv._SEED, (1, 2), 0, torch.zeros(SHAPE),
                                torch.zeros(SHAPE))
    assert tier._worker is None and tier.flush()
    with pytest.raises(ValueError, match="tier_bytes"):
        PT.HostTier(PS, tier_bytes=-1)


def test_a_failed_spill_costs_one_page_and_a_failed_export_raises():
    """A page whose snapshot never arrives is a copy error and a miss;
    the thread lives on. An export's failure goes to its caller."""
    class Broken:
        def synchronize(self):
            raise RuntimeError("copy failed")
    tier = PT.HostTier(PS, tier_bytes=1 << 20)
    toks = [1, 2, 3, 4, 5]
    b0, b1 = (1, 2), (3, 4)
    h0 = jkv.block_hash(jkv._SEED, b0)
    tier.spill_async(jkv._SEED, b0, 0, torch.zeros(SHAPE),
                     torch.zeros(SHAPE), ready=Broken())
    tier.spill_async(h0, b1, 1, torch.zeros(SHAPE), torch.zeros(SHAPE))
    assert tier.flush(timeout=30)
    st = tier.stats()
    assert (st["copy_errors"], st["spills"], st["spilled_pages"]) == (1, 1, 1)
    assert tier.match(toks, 0) == []            # block 0 was lost
    assert len(tier.match(toks, PS)) == 1       # the device had block 0
    with pytest.raises(RuntimeError, match="copy failed"):
        tier.export_pages(torch.zeros(SHAPE), torch.zeros(SHAPE),
                          ready=Broken())
    assert tier.stats()["copy_errors"] == 1


def _hooked(mod, host, hooks):
    """Budget drops and a short match on a tier with the fleet hooks
    attached (`hooks`) or not: what the tier kept, matched and handed to
    the hooks, which must run with the tier's lock released."""
    tier = mod.HostTier(PS, tier_bytes=700, quantize=False)
    assert tier.on_drop is None and tier.fetch_missing is None
    calls = []

    def on_drop(entries):
        assert not tier._lock.locked()
        calls.append(("drop", [(k, e["depth"]) for k, e in entries]))

    def fetch_missing(parent, block_idx, tokens):
        assert not tier._lock.locked()
        calls.append(("fetch", parent, block_idx, list(tokens)))
        return [{"k": host(_page(90)), "v": host(_page(91)),
                 "ks": None, "vs": None}]
    if hooks:
        tier.on_drop, tier.fetch_missing = on_drop, fetch_missing
    toks = list(range(1, 8))
    parent, keys = jkv._SEED, []
    for b in range(3):                       # the third overflows 700 B
        block = tuple(toks[b * PS:(b + 1) * PS])
        tier.insert(parent, block, b, {"k": host(_page(b)),
                                       "v": host(_page(b + 5)),
                                       "ks": None, "vs": None})
        parent = jkv.block_hash(parent, block)
        keys.append(parent)
    # a peer's page, dropped under the budget without a spill
    tier.insert(jkv._SEED, (40, 41), 5, {"k": host(_page(7)),
                                         "v": host(_page(8)),
                                         "ks": None, "vs": None}, fleet=True)
    kept = [tier.peek(k) is not None for k in keys]
    short = len(tier.match(toks, 0))
    capped = len(tier.match(toks[:2 * PS + 1], 0))
    return kept, short, capped, tier.stats()["drops"], calls


@pytest.mark.parametrize("hooks", [False, True], ids=["no_hooks", "hooks"])
def test_fleet_hooks_match_reference(hooks):
    """With both hooks None a drop is final and a short match stays
    short, as the reference's; with them, budget drops (a peer's pages
    excepted) reach `on_drop` and a short walk asks `fetch_missing`,
    outside the lock, with the reference's arguments."""
    ref = _hooked(JT, lambda a: a, hooks)
    got = _hooked(PT, torch.from_numpy, hooks)
    assert got == ref
    kept, short, capped, drops, calls = got
    assert kept == [True, True, False] and drops == 2 and capped == 2
    if hooks:
        assert short == 3
        assert [c[0] for c in calls] == ["drop", "fetch"]
        assert calls[1][1:3] == (jkv.block_hash(jkv.block_hash(
            jkv._SEED, (1, 2)), (3, 4)), 2)
    else:
        assert short == 2 and calls == []


def test_fleet_pages_take_their_hooks_off_the_tier_when_they_stop():
    """The tier's copy thread lives as long as the process: a stopped
    FleetPages takes its hooks off the tier, so nothing running keeps
    its worker, replica and engine alive; hooks that are not its own
    stay."""
    from types import SimpleNamespace
    from paddle_tpu_torch.serving.fleet import FleetPages
    from paddle_tpu_torch.serving.metrics import MetricsRegistry
    for other in (False, True):
        tier = PT.HostTier(PS, tier_bytes=1 << 20)
        worker = SimpleNamespace(replica=SimpleNamespace(
            engine=SimpleNamespace(host_tier=tier), replica_id="w",
            registry=MetricsRegistry()))
        pages = FleetPages(worker)
        assert tier.on_drop == pages.on_drop
        assert tier.fetch_missing == pages.fetch_missing
        if other:
            tier.on_drop = print
        pages.stop()
        assert tier.fetch_missing is None
        assert tier.on_drop is (print if other else None)
