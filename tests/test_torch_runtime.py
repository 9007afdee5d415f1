"""The port's serving runtime (`paddle_tpu_torch.serving`: scheduler,
server, client, router, metrics, timeline) held to the JAX package's on
the CPU: the same traffic through both stacks, over real HTTP, under
both pumps and on the ragged, bucketed and chunked engines, gives the
same streamed tokens, the same `/metrics` families, types and labels,
equal counters that are not times, the same `/debug/*` key structure
and the same flight-record kinds; backpressure, deadlines, cancellation,
shutdown and the router behave as the reference's.

What the port leaves out on the CPU, by design: `pt_mfu` and
`pt_mfu_peak` (no step is costed off the card) and the per-function
`pt_fn_*` and per-pool `pt_device_live_bucket_bytes` rows that costs
and a card's allocator would fill; the JAX package's `compile` and
`device.cost` flight records are the port's `signature` records (no jit
runs). Every server binds port 0 and is shut down in a `finally`."""
import http.client
import json
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu.observability as JO
import paddle_tpu.serving as JSV
import paddle_tpu_torch.observability as PO
import paddle_tpu_torch.serving as PSV
from paddle_tpu.models import llama_serving as JS
from paddle_tpu.models import llama_spmd as JM
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.observability import flight_recorder as JFR
from paddle_tpu_torch.models import llama_serving as PS
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.llama_spmd import params_from_jax
from paddle_tpu_torch.observability import flight_recorder as PFR

DIMS = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64,
            seq=128)
JCFG, CFG = JConfig.tiny(**DIMS), LlamaConfig.tiny(**DIMS)
PAGE = 8
ENGINES = {
    "ragged": {},
    "bucketed": {"ragged": False},
    "chunked": {"ragged": False, "spec_decode": 4, "chunked_prefill": True},
}
HEAD = list(range(3, 19))          # two full pages: a shared prefix
PROMPTS = [HEAD + [20, 21, 22], HEAD + [23], [5, 9, 2, 7, 5, 9, 2],
           HEAD + [24, 25]]
NEW = 4
WAIT_S = 60
# families the port leaves out on the CPU (module docstring)
CPU_ABSENT = {"pt_mfu", "pt_mfu_peak"}
CPU_UNROWED = {"pt_mfu", "pt_mfu_peak", "pt_fn_flops", "pt_fn_bytes_accessed",
               "pt_fn_hbm_bytes", "pt_fn_flops_issued_total",
               "pt_device_live_bucket_bytes"}
NO_JIT_KINDS = {"compile", "device.cost", "signature"}
TIMES = re.compile(r"seconds|_s$|timestamp|time")


@pytest.fixture(scope="module")
def stacks():
    jp = JM.init_params(JCFG, seed=0, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return {"jax": (jp, JS, JSV, JFR, JO.health),
            "torch": (tp, PS, PSV, PFR, PO.health)}


def _engine(stacks, stack, kind, **kw):
    params, S = stacks[stack][:2]
    kw = {"max_seqs": 2, "max_seq_len": 64, "page_size": PAGE,
          "prefix_cache": True, **ENGINES[kind], **kw}
    if stack == "jax":
        return S.ServingEngine(params, JCFG, use_pallas=False, **kw)
    return S.ServingEngine(params, CFG, device="cpu", **kw)


def _get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.read().decode()
    finally:
        c.close()


def _wait(cond, what):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < WAIT_S, f"timed out waiting: {what}"
        time.sleep(0.002)


def _serve(stacks, stack, kind, pipeline):
    """PROMPTS over HTTP from one thread each (even ones streamed), all
    queued in order while the pump is paused, then served. Returns the
    tokens, the scrapes and the flight-record kinds."""
    SV, FR, health = stacks[stack][2:]
    eng = _engine(stacks, stack, kind)
    sched = SV.RequestScheduler(eng, max_queue=8, metrics=SV.MetricsRegistry(),
                                pipeline=pipeline)
    srv = SV.ServingServer(sched, port=0).start()
    try:
        # the process-global rings and counters start empty on both
        # stacks: other tests in this process may have fed them (a JAX
        # training loop sets the reference's `pt_train_loss`; JAX tests
        # that compiled the serving functions before push the reference's
        # compile registry towards its once-only retrace-storm warning)
        FR.RECORDER.clear()
        health.reset()
        for obs in (JO, PO):
            obs.compile_telemetry.reset()
        sched.pause()
        cl = SV.ServingClient(port=srv.port, timeout=WAIT_S)
        out = {}

        def go(i, prompt):
            if i % 2:
                out[i] = cl.complete(prompt, max_tokens=NEW)["tokens"]
            else:
                out[i] = [t for ev in cl.stream_complete(prompt,
                                                         max_tokens=NEW)
                          if "state" not in ev for t in ev["tokens"]]
        threads = []
        for i, prompt in enumerate(PROMPTS):
            threads.append(threading.Thread(target=go, args=(i, prompt)))
            threads[-1].start()
            _wait(lambda: sched.stats()["queued"] == i + 1, "queued")
        sched.resume()
        for t in threads:
            t.join(WAIT_S)
            assert not t.is_alive()
        res = {"tokens": out, "snap": sched.metrics_snapshot(),
               "kinds": [e["kind"] for e in FR.RECORDER.events()]}
        for path in ("/metrics", "/debug/flightrecorder", "/debug/trace",
                     "/debug/requests", "/debug/pulse", "/healthz",
                     "/readyz", "/debug/stacks", "/debug/fleet/health"):
            res[path] = _get(srv.port, path)
        return res
    finally:
        srv.stop(timeout=WAIT_S)


def _families(text):
    """(# TYPE names with their types, (sample name, label keys) pairs)
    of a Prometheus text page."""
    types, rows = set(), set()
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            types.add(tuple(line.split()[2:4]))
        elif line and not line.startswith("#"):
            m = re.match(r"([a-zA-Z_:]+)(\{[^}]*\})?", line)
            rows.add((m.group(1), tuple(sorted(re.findall(
                r'(\w+)="', m.group(2) or "")))))
    return types, rows


def _shape(x):
    """The key structure of a JSON value: dicts by their keys, lists by
    the set of their elements' shapes, leaves by type."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in sorted(x.items())}
    if isinstance(x, list):
        return ["list"] + sorted({json.dumps(_shape(v), sort_keys=True)
                                  for v in x})
    return "num" if isinstance(x, (int, float)) and \
        not isinstance(x, bool) else type(x).__name__


def _event_shapes(doc):
    out = {}
    for e in doc["events"]:
        if e["kind"] not in NO_JIT_KINDS:
            out.setdefault(e["kind"], set()).add(
                json.dumps(_shape(e), sort_keys=True))
    return out


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
@pytest.mark.parametrize("kind", list(ENGINES))
def test_http_serving_matches_the_reference(stacks, kind, pipeline,
                                            monkeypatch):
    # the pulse plane samples every 10 ms, so both runs' rings hold the
    # rates and percentiles that two samples give (the reference reads
    # the same variable)
    monkeypatch.setenv("PT_PULSE_INTERVAL_S", "0.01")
    ref, got = (_serve(stacks, s, kind, pipeline) for s in ("jax", "torch"))
    assert got["tokens"] == ref["tokens"]
    assert all(len(t) == NEW for t in got["tokens"].values())
    # /metrics: the same families, types and label keys
    rt, rr = _families(ref["/metrics"][1])
    gt, gr = _families(got["/metrics"][1])
    assert gt == {t for t in rt if t[0] not in CPU_ABSENT}
    assert gr == {r for r in rr if r[0] not in CPU_UNROWED}
    # the constant the card checks is the reference's list
    assert PSV.server.METRIC_NAMES == tuple(
        line.split()[2] for line in ref["/metrics"][1].splitlines()
        if line.startswith("# TYPE"))
    # every counter and gauge that is not a time, and every histogram's
    # count (TTFT and TPOT observations included), equal
    assert set(got["snap"]) == set(ref["snap"])
    for name, r in ref["snap"].items():
        g = got["snap"][name]
        assert g["type"] == r["type"], name
        if r["type"] == "histogram":
            assert g["count"] == r["count"], name
        elif not TIMES.search(name):
            assert g.get("value") == r.get("value"), name
    assert got["snap"]["pt_prefix_tokens_reused"]["value"] >= len(HEAD)
    # /debug/*: status and key structure
    for path in ("/debug/trace", "/debug/requests", "/debug/pulse",
                 "/healthz", "/readyz"):
        assert got[path][0] == ref[path][0] == 200, path
        r, g = (json.loads(x[path][1]) for x in (ref, got))
        if path == "/debug/pulse":
            for name in CPU_ABSENT:
                del r["signals"][name]
        assert _shape(g) == _shape(r), path
    fr, fg = (json.loads(x["/debug/flightrecorder"][1]) for x in (ref, got))
    assert sorted(fg) == sorted(fr)
    assert _event_shapes(fg) == _event_shapes(fr)
    assert got["/debug/stacks"][0] == 200 and "thread" in \
        got["/debug/stacks"][1]
    assert got["/debug/fleet/health"][0] == ref["/debug/fleet/health"][0] \
        == 404
    if not pipeline:
        # one script, the synchronous pump: the same flight-record kinds
        # in the same order
        assert [k for k in got["kinds"] if k not in NO_JIT_KINDS] == \
            [k for k in ref["kinds"] if k not in NO_JIT_KINDS]


def _scheduler_script(stacks, stack):
    """Backpressure, a never-fitting prompt, a queued deadline, priority
    order, cancellation, shutdown with and without drain: what each
    produced, in plain data."""
    SV = stacks[stack][2]
    out = {}
    eng = _engine(stacks, stack, "ragged", max_seqs=1)
    sched = SV.RequestScheduler(eng, max_queue=2)
    try:
        sched.pause()
        a = sched.submit([1, 2, 3], max_new_tokens=4)
        doomed = sched.submit([2, 4, 6], max_new_tokens=4, ttl_s=0.05)
        with pytest.raises(SV.BackpressureError) as bp:
            sched.submit([7, 8, 9], max_new_tokens=4)
        out["retry_after"] = bp.value.retry_after_s > 0
        with pytest.raises(ValueError, match="max_seq_len"):
            sched.submit(list(range(1, 60)), max_new_tokens=30)
        time.sleep(0.1)                   # the queued TTL runs out
        sched.resume()
        out["a"] = (a.result(timeout=WAIT_S), a.state)
        with pytest.raises(SV.DeadlineExceededError):
            doomed.result(timeout=WAIT_S)
        out["doomed"] = doomed.state
        sched.pause()
        blocker = sched.submit([1, 2, 3], max_new_tokens=12)
        lo = sched.submit([4, 5, 6], max_new_tokens=3, priority="low")
        sched.resume()
        _wait(lambda: blocker.state == "running", "blocker running")
        hi = sched.submit([7, 8, 9], max_new_tokens=3, priority="high")
        for sr in (blocker, lo, hi):
            sr.result(timeout=WAIT_S)
        out["order"] = sorted(("lo", "hi"), key=lambda n: {
            "lo": lo, "hi": hi}[n].t_first_token)
        victim = sched.submit([3, 3, 3], max_new_tokens=40)
        _wait(lambda: victim.state == "running", "victim running")
        victim.cancel()
        out["victim"] = (len(victim.result(timeout=WAIT_S)) < 40,
                         victim.state)
        drained = [sched.submit([1 + i, 5, 9], max_new_tokens=6)
                   for i in range(2)]
        out["drain"] = sched.shutdown(drain=True, timeout=WAIT_S)
        out["drained"] = [sr.state for sr in drained]
        with pytest.raises(SV.SchedulerClosedError):
            sched.submit([1, 2], max_new_tokens=2)
        out["ledger"] = {k: v for k, v in sched.stats()["requests"].items()}
    finally:
        sched.shutdown(drain=False, timeout=WAIT_S)
    eng = _engine(stacks, stack, "ragged", max_seqs=1)
    sched = SV.RequestScheduler(eng, max_queue=8)
    try:
        cut = [sched.submit([1 + i, 5, 9], max_new_tokens=50)
               for i in range(3)]
        out["no_drain"] = sched.shutdown(drain=False, timeout=WAIT_S)
        out["cut"] = sorted(sr.state for sr in cut)
        assert eng.pool.conserved() if stack == "torch" else True
    finally:
        sched.shutdown(drain=False, timeout=WAIT_S)
    return out


def test_scheduler_behaviour_matches_the_reference(stacks):
    ref, got = (_scheduler_script(stacks, s) for s in ("jax", "torch"))
    assert got == ref
    assert got["doomed"] == "expired" and got["order"] == ["hi", "lo"]
    assert got["victim"] == (True, "cancelled")
    assert got["cut"] == ["cancelled"] * 3


def _http_script(stacks, stack):
    """429 with Retry-After, 504 on a deadline, 400 on a prompt that can
    never fit, and a graceful shutdown that finishes a stream in
    flight."""
    SV = stacks[stack][2]
    out = {}
    eng = _engine(stacks, stack, "ragged", max_seqs=1)
    sched = SV.RequestScheduler(eng, max_queue=1)
    srv = SV.ServingServer(sched, port=0).start()
    try:
        cl = SV.ServingClient(port=srv.port, timeout=WAIT_S)
        sched.pause()
        first = threading.Thread(
            target=lambda: out.setdefault("first", cl.complete(
                [1, 2, 3], max_tokens=4)["tokens"]))
        first.start()
        _wait(lambda: sched.stats()["queued"] == 1, "queued")
        with pytest.raises(SV.ServingHTTPError) as e:
            cl.complete([9, 9, 9], max_tokens=4)
        out["429"] = (e.value.status, e.value.retry_after_s is not None)
        sched.resume()
        first.join(WAIT_S)
        with pytest.raises(SV.ServingHTTPError) as e:
            cl.complete(list(range(1, 60)), max_tokens=30)
        out["400"] = e.value.status
        sched.pause()
        with pytest.raises(SV.ServingHTTPError) as e:
            cl.complete([1, 2, 3], max_tokens=4, ttl_s=0.05)
        out["504"] = e.value.status
        sched.resume()
        evs = []
        stream = threading.Thread(target=lambda: evs.extend(
            cl.stream_complete([1, 5, 9], max_tokens=12)))
        stream.start()
        _wait(lambda: len(evs) >= 1, "first streamed token")
        out["shutdown"] = srv.stop(timeout=WAIT_S)
        stream.join(WAIT_S)
        out["stream"] = [t for ev in evs if "state" not in ev
                         for t in ev["tokens"]]
        out["stream_end"] = evs[-1].get("state")
    finally:
        srv.stop(timeout=WAIT_S)
    return out


def test_http_behaviour_matches_the_reference(stacks):
    ref, got = (_http_script(stacks, s) for s in ("jax", "torch"))
    assert got == ref
    assert got["429"] == (429, True) and got["400"] == 400
    assert got["504"] == 504 and len(got["stream"]) == 12


def _route(stacks, stack, roles):
    """PROMPTS through a Router over two ragged replicas (roles None:
    prefix affinity; ["prefill", "decode"]: every request handed off
    from one to the other), all queued before the replicas run."""
    SV = stacks[stack][2]
    reps = SV.build_replicas(
        lambda i: _engine(stacks, stack, "ragged"), 2, max_queue=8,
        roles=roles)
    router = SV.Router(reps)
    try:
        router.pause()
        rrs = [router.submit(p, max_new_tokens=NEW) for p in PROMPTS]
        router.resume()
        toks = [rr.result(timeout=WAIT_S) for rr in rrs]
        snaps = {r.replica_id: r.registry.snapshot() for r in reps}
        counts = {rid: {n: s[n]["value"] for n in (
            "pt_serving_requests_accepted", "pt_serving_generated_tokens",
            "pt_serving_requests_completed", "pt_handoff_exports",
            "pt_handoff_imports", "pt_handoff_failures", "pt_prefix_lookups",
            "pt_prefix_tokens_reused")} for rid, s in snaps.items()}
        return {"tokens": toks, "counts": counts,
                "placed": [rr.replica_id for rr in rrs]}
    finally:
        router.shutdown(drain=True, timeout=WAIT_S)


@pytest.mark.parametrize("roles", [None, ["prefill", "decode"]],
                         ids=["affinity", "handoff"])
def test_router_matches_the_reference(stacks, roles):
    ref, got = (_route(stacks, s, roles) for s in ("jax", "torch"))
    assert got == ref
    if roles:
        assert got["counts"]["r0"]["pt_handoff_exports"] == len(PROMPTS)
        assert got["counts"]["r1"]["pt_handoff_imports"] == len(PROMPTS)


def test_exports_mirror_the_reference():
    """The packages' `__all__` are the reference's (the fleet plane
    and the trainer's health checks included), less `nan_blame`, which
    hooks `nn` sublayers and comes with item 13b."""
    training = {"nan_blame"}
    assert set(PSV.__all__) == set(JSV.__all__)
    assert set(PO.__all__) == set(JO.__all__) - training
    for name in PO.__all__:
        assert hasattr(PO, name), name
    for name in PSV.__all__:
        assert hasattr(PSV, name), name
