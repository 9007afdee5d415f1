"""The port's fleet plane (`paddle_tpu_torch.serving.fleet`) held to the
JAX package's on the CPU: an in-process harness for each package (N
`FleetWorker`s and a `FleetPlane` on loopback, every control call and
token byte over a real socket) takes the same traffic, and the two give
the same streamed tokens (equal to a greedy reference), the same
`RemoteReplica.stats()` less times, the same router metric names, types
and labels (`host=` beside `replica=`), the same exception types across
the wire, the same handoff and page counters, the same outcomes under
failover, drain and heartbeat loss, and the same `/debug/fleet/*` key
structure.

Across the packages only the data plane is shared (the control plane
pickles functions by reference, so each router drives its own package's
workers): a handoff one package's prefill worker exports is fetched by
the other's `RemoteHandoffRef` and continued on the other's decode
engine with the same tokens, and each package's `_fetch_page` reads the
other's page server, byte for byte.

One subprocess drill spawns port workers (`python -m
paddle_tpu_torch.serving.fleet`, "device": "cpu") and finds neither
`jax` nor `paddle_tpu` in their modules. Every socket binds port 0 on
127.0.0.1; waits are on a condition with a deadline, never a fixed
sleep; durations are never compared."""
import http.client
import json
import os
import re
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.serving as JSV
import paddle_tpu_torch.serving as PSV
from paddle_tpu.models import llama_serving as JS
from paddle_tpu.models import llama_spmd as JM
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.observability import flight_recorder as JFR
from paddle_tpu.serving import fleet as JFL
from paddle_tpu_torch.models import llama_serving as PS
from paddle_tpu_torch.models import llama_spmd as PM
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.observability import flight_recorder as PFR
from paddle_tpu_torch.serving import fleet as PFL
from paddle_tpu_torch.serving.kvcache import _SEED, block_hash

DIMS = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64,
            seq=128)
JCFG, CFG = JConfig.tiny(**DIMS), LlamaConfig.tiny(**DIMS)
PAGE = 8
WAIT_S = 60
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMES = re.compile(r"seconds|_s$|timestamp|time|uptime")


@pytest.fixture(scope="module")
def stacks():
    jp = JM.init_params(JCFG, seed=0, dtype=jnp.float32)
    tp = PM.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return {"jax": (jp, JS, JSV, JFL, JFR), "torch": (tp, PS, PSV, PFL, PFR)}


def _engine(stacks, stack, **kw):
    params, S = stacks[stack][:2]
    kw = {"max_seqs": 2, "max_seq_len": 64, "page_size": PAGE,
          "prefix_cache": True, **kw}
    if stack == "jax":
        return S.ServingEngine(params, JCFG, use_pallas=False, **kw)
    return S.ServingEngine(params, CFG, device="cpu", **kw)


@torch.no_grad()
def greedy(stacks, prompt, n_new):
    """The greedy reference: the port's full forward, one token at a time
    (the parity tests hold it to the JAX package's)."""
    params = stacks["torch"][0]
    ids, out = list(prompt), []
    for _ in range(n_new):
        logits = PM.forward(params, torch.tensor([ids]), CFG, remat=False)
        out.append(int(torch.argmax(logits[0, -1])))
        ids.append(out[-1])
    return out


def header(seed, blocks=2):
    return [(seed * 31 + i) % 60 + 1 for i in range(blocks * PAGE)]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for(cond, what, deadline_s=WAIT_S):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < deadline_s, f"timed out: {what}"
        time.sleep(0.01)


class FleetHarness:
    """N FleetWorkers of one package + its FleetPlane on loopback in one
    process (the reference's test harness, for either package)."""

    def __init__(self, stacks, stack, roles, max_queue=16,
                 hb_timeout_s=None, **engine_kw):
        SV = stacks[stack][2]
        self.stack = stack
        endpoint = f"127.0.0.1:{free_port()}"
        names = [f"w{i}" for i in range(len(roles))]
        self.workers = [None] * len(roles)
        errors = []

        def build(i):
            try:
                rep = SV.Replica(f"fr{i}", _engine(stacks, stack, **engine_kw),
                                 max_queue=max_queue, role=roles[i])
                self.workers[i] = SV.FleetWorker(
                    names[i], rep, master_endpoint=endpoint, rank=i + 1,
                    world_size=len(roles) + 1, host=f"host{i}")
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)

        threads = [threading.Thread(target=build, args=(i,), daemon=True)
                   for i in range(len(roles))]
        for t in threads:
            t.start()
        self.plane = SV.FleetPlane(endpoint, names, hb_timeout_s=hb_timeout_s)
        for t in threads:
            t.join(timeout=WAIT_S)
        if errors:
            self.close()
            raise errors[0]
        self.replicas = self.plane.replicas

    def worker_for(self, rep):
        return self.workers[self.replicas.index(rep)]

    def close(self):
        for w in self.workers:
            if w is None:
                continue
            w.replica.shutdown(drain=False, timeout=10)
            w.close()
        self.plane.close()


@pytest.fixture()
def make_fleet(stacks):
    made = []

    def _make(stack, roles, **kw):
        made.append(FleetHarness(stacks, stack, list(roles), **kw))
        return made[-1]

    yield _make
    for h in made:
        h.close()


def _both(make_fleet, roles, **kw):
    return {s: make_fleet(s, roles, **kw) for s in ("jax", "torch")}


# ---------------------------------------------------------------------------
# router over the fleet: tokens, stats, metrics, /debug/fleet/*


def _types_and_labels(text):
    """{family: type} and {series name: sorted label-name tuples}."""
    types, labels = {}, {}
    for ln in text.splitlines():
        if ln.startswith("# TYPE"):
            _, _, name, kind = ln.split()
            types[name] = kind
        elif ln and not ln.startswith("#"):
            m = re.match(r"([A-Za-z_:][\w:]*)(\{([^}]*)\})?", ln)
            names = tuple(sorted(re.findall(r'(\w+)="', m.group(3) or "")))
            labels.setdefault(m.group(1), set()).add(names)
    return types, labels


def _no_times(d):
    if isinstance(d, dict):
        return {k: _no_times(v) for k, v in d.items() if not TIMES.search(k)}
    return d


def _shape(x, depth=0):
    """The key structure of a JSON document (a list by its first item)."""
    if isinstance(x, dict):
        return {k: _shape(v, depth + 1) for k, v in x.items()}
    if isinstance(x, list):
        return [_shape(x[0], depth + 1)] if x else []
    return type(x).__name__


def _get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, json.loads(r.read().decode())
    finally:
        c.close()


def _route(stacks, fl):
    SV, FR = stacks[fl.stack][2], stacks[fl.stack][4]
    FR.RECORDER.clear()
    router = SV.Router(fl.replicas, fleet=fl.plane)
    srv = SV.ServingServer(router, port=0).start()
    try:
        h = header(3)
        prompts = [h + [40 + t] for t in range(4)]
        toks = []
        for t, p in enumerate(prompts):
            rr = router.submit(p, max_new_tokens=4)
            if t % 2:
                toks.append([x for c in rr.stream(timeout=WAIT_S) for x in c])
                assert rr._sr._streamed and rr._sr.t_first_token is not None
            else:
                toks.append(rr.result(timeout=WAIT_S))
            assert rr.state == "done"
        snap = router.registry.snapshot()
        stats = {rep.replica_id: _no_times(rep.stats())
                 for rep in fl.replicas}
        text = router.render_prometheus()
        recent = router.recent_requests(10)
        routes = {p: _get(srv.port, p) for p in
                  ("/debug/fleet/trace", "/debug/fleet/flightrecorder")}
        return {"tokens": toks, "prompts": prompts,
                "affinity_hits": snap["pt_router_affinity_hits"]["value"],
                "stats": stats, "metrics": _types_and_labels(text),
                "text": text, "recent_hosts": sorted(
                    {e["host"] for e in recent}), "routes": routes}
    finally:
        srv.stop(drain=False, timeout=30)
        router.shutdown(drain=True, timeout=30)


def test_router_over_the_fleet_matches_the_reference(stacks, make_fleet):
    got = {s: _route(stacks, fl) for s, fl in
           _both(make_fleet, ("both", "both")).items()}
    ref, port = got["jax"], got["torch"]
    assert port["tokens"] == ref["tokens"]
    for p, toks in zip(port["prompts"], port["tokens"]):
        assert toks == greedy(stacks, p, 4)
    assert port["affinity_hits"] == ref["affinity_hits"] == 4
    assert port["stats"] == ref["stats"]
    assert port["stats"]["fr0"]["host"] == "host0"
    assert port["metrics"] == ref["metrics"]
    for i in (0, 1):
        assert f'replica="fr{i}",host="host{i}"' in port["text"]
    assert port["recent_hosts"] == ref["recent_hosts"]
    for path, (status, doc) in port["routes"].items():
        ref_status, ref_doc = ref["routes"][path]
        assert status == ref_status == 200, path
        assert sorted(doc) == sorted(ref_doc)
    (_, trace), (_, rtrace) = (got[s]["routes"]["/debug/fleet/trace"]
                               for s in ("torch", "jax"))
    names = [{e["args"]["name"] for e in t["traceEvents"]
              if e["name"] == "process_name"} for t in (trace, rtrace)]
    assert names[0] == names[1] == {"router", "fr0@host0", "fr1@host1"}
    assert trace["fleet"] == rtrace["fleet"]
    for ph in ("M", "X", "s", "f"):
        keys = [{k for e in t["traceEvents"] if e["ph"] == ph for k in e}
                for t in (trace, rtrace)]
        assert keys[0] == keys[1], ph
    (_, fr), (_, rfr) = (got[s]["routes"]["/debug/fleet/flightrecorder"]
                         for s in ("torch", "jax"))
    assert sorted(fr["sections"]) == sorted(rfr["sections"])
    for label, sec in fr["sections"].items():
        assert _shape({k: v for k, v in sec.items() if k != "events"}) == \
            _shape({k: v for k, v in rfr["sections"][label].items()
                    if k != "events"})
    kinds = [{e["kind"] for e in doc["events"]} for doc in (fr, rfr)]
    assert {k for k in kinds[1] if k.startswith(("fleet.", "span"))} <= \
        kinds[0]
    assert all({"source", "ts_fleet", "kind"} <= set(e)
               for e in fr["events"])


def _errors(stacks, fl):
    SV = stacks[fl.stack][2]
    rep = fl.replicas[0]
    out = {}
    try:
        rep.submit([], max_new_tokens=2)
    except Exception as e:  # noqa: BLE001 — compared below
        out["empty"] = type(e).__name__
    rep.pause()
    out["paused_ready"] = rep.ready()
    held = [rep.submit(header(4) + [t], max_new_tokens=2) for t in range(2)]
    with pytest.raises(SV.BackpressureError) as info:
        rep.submit(header(4) + [9], max_new_tokens=2)
    out["full"] = type(info.value).__name__
    rep.resume()
    out["ready"] = rep.ready()
    out["held"] = [r.result(timeout=WAIT_S) for r in held]
    rep._mark_dead("test")
    with pytest.raises(SV.SchedulerClosedError):
        rep.submit([1, 2, 3], max_new_tokens=1)
    st = rep.stats()
    out["dead"] = (rep.load() == stacks[fl.stack][3]._DEAD_LOAD,
                   rep.ready(), st["ready"], st["closed"])
    return out


def test_backpressure_and_errors_cross_the_wire(stacks, make_fleet):
    got = {s: _errors(stacks, fl) for s, fl in
           _both(make_fleet, ("both",), max_queue=2).items()}
    assert got["torch"] == got["jax"]
    assert got["torch"]["empty"] == "ValueError"
    assert got["torch"]["full"] == "BackpressureError"
    assert got["torch"]["dead"] == (True, False, False, True)


# ---------------------------------------------------------------------------
# disaggregated prefill -> decode over the bulk socket, within and across
# the packages


def _migrate(stacks, fl, routers):
    """3 prompts through a Router over (prefill, decode); the router is
    left open (its shutdown stops the workers' bulk servers)."""
    routers.append(stacks[fl.stack][2].Router(fl.replicas))
    prompts = [header(7) + [30 + t] for t in range(3)]
    held = [routers[-1].submit(p, max_new_tokens=4) for p in prompts]
    outs = [r.result(timeout=WAIT_S) for r in held]
    assert all(r.state == "done" for r in held)
    src = fl.workers[0]
    reg = src.replica.registry.snapshot()
    return {"tokens": outs, "prompts": prompts,
            "served": [r.replica_id for r in held],
            "handoffs": routers[-1].registry.snapshot()[
                "pt_router_handoffs"]["value"],
            "serves": src.handoff_serves.value,
            "wire_bytes": src.handoff_wire_bytes.value,
            "seconds_count": reg["pt_handoff_seconds"]["count"],
            "handoff_bytes": reg["pt_handoff_bytes"]["value"]}


def _continue(stacks, stack, h):
    """`h` (this package's KVHandoff) continued on a fresh decode engine
    of `stack`, re-submitted as the scheduler re-submits it."""
    S = stacks[stack][1]
    eng = _engine(stacks, stack, host_tier_bytes=8 << 20)
    r = S.Request(h.rid, h.prompt, max_new_tokens=4)
    r.output = [int(t) for t in h.output]
    r.next_token = int(h.next_token)
    r.cached_tokens = int(h.cached_tokens)
    r._kv_import = h
    eng.submit(r)
    eng.run()
    assert eng.handoff_imports == 1
    return [int(t) for t in r.output]


def test_migration_matches_and_crosses_the_packages(stacks, make_fleet):
    fls = _both(make_fleet, ("prefill", "decode"), host_tier_bytes=8 << 20)
    routers = []
    try:
        _migrate_and_cross(stacks, fls, routers)
    finally:
        for r in routers:
            r.shutdown(drain=True, timeout=30)


def _migrate_and_cross(stacks, fls, routers):
    got = {s: _migrate(stacks, fl, routers) for s, fl in fls.items()}
    ref, port = got["jax"], got["torch"]
    assert port == ref
    for p, toks in zip(port["prompts"], port["tokens"]):
        assert toks == greedy(stacks, p, 4)
    assert port["served"] == ["fr1"] * 3
    assert port["handoffs"] == 3 and port["serves"] == 3
    assert port["seconds_count"] == 6 and port["wire_bytes"] > 0
    by_prompt = {tuple(p): t for p, t in zip(port["prompts"],
                                             port["tokens"])}
    # each package's prefill worker still holds its exports: the other
    # package fetches them over the bulk socket and decodes on
    for src, dst in (("jax", "torch"), ("torch", "jax")):
        w = fls[src].workers[0]
        with w._req_lock:
            rids = sorted(w._handoffs)
        assert len(rids) == 3
        for rid in rids:
            if dst == "torch":
                h = PFL.RemoteHandoffRef(w.bulk_addr, rid).resolve()
                assert isinstance(h, PSV.KVHandoff)
                assert isinstance(h.k, torch.Tensor)
            else:
                h = JFL._fetch_handoff(w.bulk_addr, rid)
                assert isinstance(h, JSV.KVHandoff)
            ours = w._handoffs[rid]
            for part in ("k", "v", "ks", "vs"):
                a, b = getattr(ours, part), getattr(h, part)
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
            assert _continue(stacks, dst, h) == by_prompt[tuple(h.prompt)]


def test_remote_handoff_ref_fetches_caches_and_misses(stacks, make_fleet):
    fl = make_fleet("torch", ("both",), host_tier_bytes=8 << 20)
    w = fl.workers[0]
    k = torch.ones((2, 2, 1, PAGE, 8), dtype=torch.int8)
    h = PSV.KVHandoff("hand-1", [1, 2], [3], 4, 3, 1, k, k.clone(),
                      quantized=True)
    with w._req_lock:
        w._handoffs["hand-1"] = h
    ref = PFL.RemoteHandoffRef(w.bulk_addr, "hand-1", nbytes=h.nbytes,
                               pages=1)
    got = ref.resolve()
    assert torch.equal(got.k, k) and got.k.dtype == torch.int8
    # lazy attribute access delegates to the payload; a repeat fetch
    # hits the worker's cache (not popped)
    assert ref.next_token == 4 and ref.resolve() is got
    assert PFL.RemoteHandoffRef(w.bulk_addr, "hand-1").resolve().length == 3
    with pytest.raises(PSV.WireError):
        PFL.RemoteHandoffRef(w.bulk_addr, "nope").resolve()


# ---------------------------------------------------------------------------
# global prefix-page cache


def _payload(stack, fill, nbytes=4096):
    k = np.full((nbytes // 2,), fill, np.int8)
    if stack == "torch":
        k = torch.from_numpy(k)
        return {"k": k, "v": k.clone(), "ks": None, "vs": None}
    return {"k": k, "v": np.array(k), "ks": None, "vs": None}


def _owned_block(pages, owner_rid, skip=()):
    """The first block (not in `skip`) whose chained hash the ring gives
    to `owner_rid` (the ring is content-hashed: the same on both
    stacks)."""
    for s in range(1, 4096):
        block = tuple((s * 7 + i * 3) % 60 + 1 for i in range(PAGE))
        key = block_hash(_SEED, block)
        if block not in skip and pages.owner_of(key) == owner_rid:
            return block, key
    raise AssertionError("no owned block found")


def _pages_drill(fl):
    wa, wb = fl.workers
    ta, tb = wa.replica.engine.host_tier, wb.replica.engine.host_tier
    stack = fl.stack
    block, key = _owned_block(wa.pages, "fr1")
    # a block owned by B, inserted on A at depth 9: the budget pushes it
    # to B instead of dropping it
    assert ta.insert(_SEED, block, 9, _payload(stack, 7))
    ta.insert(_SEED, tuple(range(1, PAGE + 1)), 0, _payload(stack, 1, 8192))
    # B indexes the page, then acks; A counts the spill after the ack
    wait_for(lambda: wa.pages.spill_pages.value == 1 and
             wb.pages.recv_pages.value == 1, "the spill to land at B")
    landed = tb.peek(key)
    assert landed["block"] == block
    assert np.asarray(landed["payload"]["k"]).tobytes() == \
        np.full(2048, 7, np.int8).tobytes()
    # fetch on a miss: A's match is short, the hook pulls the block back
    tokens = list(block) + [1]
    got = ta.match(tokens, 0)
    assert len(got) == 1
    assert np.asarray(got[0]["k"]).tobytes() == \
        np.full(2048, 7, np.int8).tobytes()
    assert len(ta.match(tokens, 0)) == 1       # now a local hit
    # a peer's page never spills again: B drops it under its own budget
    calls = []
    hook = tb.on_drop
    tb.on_drop = lambda entries: (calls.append(entries), hook(entries))
    tb.insert(_SEED, tuple(range(2, PAGE + 2)), 0, _payload(stack, 1, 9000))
    assert tb.peek(key) is None and calls == []
    # an owner's miss is clean: a block B owns but never received
    other, _ = _owned_block(wa.pages, "fr1", skip=(block,))
    assert ta.match(list(other) + [1], 0) == []
    # the fetched page pushed A's filler out, and the ring gives the
    # filler to B too: a second spill, in flight until the queues drain
    wait_for(lambda: not (wa.pages._q.unfinished_tasks or
                          wb.pages._q.unfinished_tasks),
             "the spill queues to drain")
    return {f"{who}.{name}": getattr(p, name).value
            for p, who in ((wa.pages, "a"), (wb.pages, "b"))
            for name in ("spill_pages", "spill_bytes", "spill_drops",
                         "recv_pages", "fetch_pages", "fetch_misses",
                         "page_serves")}


def test_fleet_pages_match_and_cross_the_packages(stacks, make_fleet,
                                                  monkeypatch):
    # a page's spill and fetch budgets (1 s and 5 s by default) are a
    # loaded test machine's, not a wire's
    monkeypatch.setenv("PT_FLEET_FETCH_TIMEOUT_S", "30")
    fls = _both(make_fleet, ("prefill", "prefill"), host_tier_bytes=10_000)
    got = {s: _pages_drill(fl) for s, fl in fls.items()}
    assert got["torch"] == got["jax"]
    c = got["torch"]
    assert (c["a.spill_pages"], c["b.recv_pages"], c["a.fetch_pages"],
            c["b.page_serves"], c["a.fetch_misses"]) == (2, 2, 1, 1, 1)
    # each package's page client reads the other's page server
    for src, fetch in (("torch", JFL._fetch_page), ("jax", PFL._fetch_page)):
        w = fls[src].workers[0]
        tier = w.replica.engine.host_tier
        block = tuple(range(20, 20 + PAGE))
        assert tier.insert(_SEED, block, 0, _payload(src, 5, 1024))
        key = block_hash(_SEED, block)
        entry = fetch(w.bulk_addr, key, 10)
        assert entry["block"] == block and entry["parent"] == _SEED
        assert np.asarray(entry["payload"]["k"]).tobytes() == \
            np.asarray(tier.peek(key)["payload"]["k"]).tobytes()
        assert fetch(w.bulk_addr, key + 1, 10) is None


# ---------------------------------------------------------------------------
# failover, drain and heartbeat loss


def _kill(stacks, fl):
    SV = stacks[fl.stack][2]
    router = SV.Router(fl.replicas, unhealthy_after=2)
    try:
        h = header(12)
        target = router.affinity_target(h + [1])
        rep = router.replica(target)
        rep.pause()
        held = [router.submit(h + [1 + t], max_new_tokens=3)
                for t in range(3)]
        rep.kill()
        rep.resume()
        outs = [r.result(timeout=WAIT_S) for r in held]
        out = {"tokens": outs, "states": [r.state for r in held],
               "failed_over": all(r.failovers >= 1 for r in held),
               "moved": all(r.replica_id != target for r in held),
               "health": router.stats()["replicas"][target]["health"]}
        rep.revive()
        with router._lock:
            router._replicas[target].opened_at = time.monotonic() - 1e6
        out["revived"] = router.submit(h + [9], max_new_tokens=2).result(
            timeout=WAIT_S)
        return out
    finally:
        router.shutdown(drain=True, timeout=30)


def _drain(stacks, fl):
    SV = stacks[fl.stack][2]
    router = SV.Router(fl.replicas)
    try:
        h = header(15)
        target = router.affinity_target(h + [1])
        rr = router.submit(h + [1], max_new_tokens=10)
        drained = router.drain_replica(target, timeout=WAIT_S)
        # the handle mirrors the terminal state when its stream reader
        # takes the end frame, which may trail the drain call's reply
        toks = rr.result(timeout=WAIT_S)
        out = {"drained": drained, "state": rr.state, "tokens": toks,
               "removed": target not in router.replica_ids}
        rr2 = router.submit(h + [2], max_new_tokens=2)
        out["elsewhere"] = rr2.replica_id != target
        out["after"] = rr2.result(timeout=WAIT_S)
        return out
    finally:
        router.shutdown(drain=True, timeout=30)


def _heartbeat(stacks, fl):
    SV = stacks[fl.stack][2]
    router = SV.Router(fl.replicas, unhealthy_after=1)
    try:
        h = header(21)
        target = router.affinity_target(h + [1])
        rep = router.replica(target)
        rep.pause()
        held = router.submit(h + [1], max_new_tokens=3)
        fl.worker_for(rep).stop_heartbeat()
        wait_for(lambda: not rep.alive, "the plane to declare the worker dead")
        return {"misses": fl.plane.hb_misses.value >= 1,
                "tokens": held.result(timeout=WAIT_S),
                "moved": held.replica_id != target,
                "failed_over": held.failovers >= 1}
    finally:
        router.shutdown(drain=True, timeout=30)


DRILLS = {"kill": (_kill, {}), "drain": (_drain, {}),
          "heartbeat": (_heartbeat, {"hb_timeout_s": 3.0})}


@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_failover_drain_and_heartbeat_match_the_reference(
        stacks, make_fleet, monkeypatch, drill):
    fn, kw = DRILLS[drill]
    if drill == "heartbeat":
        monkeypatch.setenv("PT_FLEET_HB_S", "0.1")
    got = {s: fn(stacks, fl) for s, fl in
           _both(make_fleet, ("both", "both"), **kw).items()}
    assert got["torch"] == got["jax"]
    out = got["torch"]
    assert all(v is True for k, v in out.items() if isinstance(v, bool)), out
    if drill == "kill":
        h = header(12)
        assert out["tokens"] == [greedy(stacks, h + [1 + t], 3)
                                 for t in range(3)]
        assert out["health"] == "open"
    if drill == "drain":
        assert out["tokens"] == greedy(stacks, header(15) + [1], 10)


# ---------------------------------------------------------------------------
# true process isolation: spawned port workers


PROBE = ("sorted(m for m in __import__('sys').modules if m in "
         "('jax', 'paddle_tpu') or m.startswith(('jax.', 'paddle_tpu.')))")


def test_spawned_workers_match_an_in_process_router(stacks):
    endpoint = f"127.0.0.1:{free_port()}"
    engine = {"max_seqs": 2, "max_seq_len": 64, "page_size": PAGE,
              "prefix_cache": True, "host_tier_bytes": 8 << 20}
    spec = {"master": endpoint, "world_size": 3, "seed": 0,
            "model": vars(CFG), "dtype": "float32", "device": "cpu",
            "engine": engine}
    env = {"PYTHONPATH": os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}
    procs = [PFL.spawn_worker(dict(spec, name="p0", rank=1, role="prefill",
                                   host="hostA"), env=env),
             PFL.spawn_worker(dict(spec, name="d0", rank=2, role="decode",
                                   host="hostB"), env=env)]
    plane = router = local = None
    try:
        plane = PSV.FleetPlane(endpoint, ["p0", "d0"])
        router = PSV.Router(plane.replicas)
        prompts = [header(9) + [11], header(10) + [12, 13]]
        held = [router.submit(p, max_new_tokens=4) for p in prompts]
        outs = [r.result(timeout=WAIT_S) for r in held]
        assert [r.replica_id for r in held] == ["d0", "d0"]
        assert 'host="hostB"' in router.render_prometheus()
        # the children's modules, asked over rpc of a builtin
        for name in ("p0", "d0"):
            assert plane._agent.invoke(name, eval, (PROBE,), {},
                                       WAIT_S).wait(WAIT_S) == []
        # the same spec built here, served by an in-process router
        params = PM.init_params(CFG, seed=0, dtype=torch.float32,
                                device="cpu")
        reps = [PSV.Replica(n, PS.ServingEngine(params, CFG, device="cpu",
                                                **engine), role=role)
                for n, role in (("p0", "prefill"), ("d0", "decode"))]
        local = PSV.Router(reps)
        want = [local.submit(p, max_new_tokens=4).result(timeout=WAIT_S)
                for p in prompts]
        assert outs == want
        assert router.shutdown(drain=True, timeout=WAIT_S)
        router = None
        for p in procs:
            assert p.wait(timeout=WAIT_S) == 0
    finally:
        if local is not None:
            local.shutdown(drain=False, timeout=10)
        if router is not None:
            router.shutdown(drain=False, timeout=10)
        if plane is not None:
            plane.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
