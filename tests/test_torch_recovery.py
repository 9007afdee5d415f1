"""Fault injection and crash recovery of the port's runtime held to the
JAX package's on the CPU: the same `FaultPlan` (points, actions, seed)
armed at each point of `serving.faults.POINTS` on both stacks gives the
same outcome. A transient fault is invisible (the no-fault tokens), a
poison request fails alone, a mid-stream crash fails its request and is
not requeued, the crash-loop breaker flips `/readyz` and refuses with
Retry-After, a Router fails over to a healthy replica, the page pool is
conserved after `suffix_prefill` and `tier_restore` faults, handoff
faults degrade to local decode or recompute, and `corrupt` flips the same
byte as the reference's."""

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
from paddle_tpu_torch.models import llama_serving as PS
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.llama_spmd import params_from_jax

DIMS = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64,
            seq=128)
JCFG, CFG = JConfig.tiny(**DIMS), LlamaConfig.tiny(**DIMS)
PAGE = 8
WAIT_S = 60
PROMPTS = [[2, 7, 1], [3, 7, 1, 8], [4, 7, 1]]


@pytest.fixture(scope="module")
def stacks():
    jp = JM.init_params(JCFG, seed=0, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return {"jax": (jp, JS, JSV), "torch": (tp, PS, PSV)}


def _engine(stacks, stack, spec=None, **kw):
    params, S, SV = stacks[stack]
    kw = {"max_seqs": 4, "max_seq_len": 64, "page_size": PAGE,
          "prefix_cache": True, **kw}
    if spec is not None:
        kw["faults"] = SV.FaultPlan(spec)
    if stack == "jax":
        return S.ServingEngine(params, JCFG, use_pallas=False, **kw)
    return S.ServingEngine(params, CFG, device="cpu", **kw)


def _conserved(eng):
    c = eng.pool.counts()
    return c["free"] + c["cached"] + c["live"] == eng.num_pages - 1 and \
        c["live"] == 0


def _requests(stacks, stack, spec, pipeline=False, prompts=PROMPTS,
              sched_kw=None, **kw):
    """`prompts` queued while the pump is paused, then served; returns
    each request's (tokens or error class, state) and the ledger."""
    SV = stacks[stack][2]
    eng = _engine(stacks, stack, spec, **kw)
    sched = SV.RequestScheduler(eng, max_queue=16,
                                metrics=SV.MetricsRegistry(),
                                pipeline=pipeline, **(sched_kw or {}))
    try:
        sched.pause()
        hs = [sched.submit(p, rid=f"r{i}" if p != [9, 9, 9, 9] else "bad",
                           max_new_tokens=6) for i, p in enumerate(prompts)]
        sched.resume()
        outs = []
        for h in hs:
            try:
                outs.append((h.result(timeout=WAIT_S), h.state))
            except SV.SchedulerError as e:
                outs.append((type(e).__name__, h.state))
        st = sched.stats()
        snap = sched.metrics_snapshot()
    finally:
        sched.shutdown(drain=True, timeout=WAIT_S)
    assert _conserved(eng), stack
    plan = eng.faults
    return {"outs": outs, "ledger": st["requests"],
            "quarantined": st["recovery"]["quarantined"],
            "restarts": eng.restarts,
            "restarts_metric": snap["pt_engine_restarts"]["value"],
            "fired": None if plan is None else len(plan.fired)}


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
@pytest.mark.parametrize("spec", ["step_launch:raise@3",
                                  "step_finish:raise@3"],
                         ids=["step_launch", "step_finish"])
def test_transient_fault_is_invisible(stacks, spec, pipeline):
    base = _requests(stacks, "torch", None, pipeline)
    ref, got = (_requests(stacks, s, spec, pipeline)
                for s in ("jax", "torch"))
    assert got == ref
    assert [o for o, _ in got["outs"]] == [o for o, _ in base["outs"]]
    assert got["restarts"] == 1 and got["ledger"]["requeued"] >= 1
    assert got["ledger"]["failed"] == 0


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_poison_request_fails_alone(stacks, pipeline):
    prompts = PROMPTS + [[9, 9, 9, 9]]
    base = _requests(stacks, "torch", None, pipeline)
    kw = {"sched_kw": {"poison_after": 2, "max_restarts": 50}}
    ref, got = (_requests(stacks, s, "step_launch:raise@1x*:rid=bad",
                          pipeline, prompts, **kw)
                for s in ("jax", "torch"))
    assert got == ref
    assert got["outs"][:3] == base["outs"]
    assert got["outs"][3] == ("PoisonedRequestError", "failed")
    assert got["quarantined"] == 1 and got["ledger"]["failed"] == 1


def _mid_stream(stacks, stack):
    SV = stacks[stack][2]
    eng = _engine(stacks, stack, max_seq_len=512)
    sched = SV.RequestScheduler(eng, max_queue=8, metrics=SV.MetricsRegistry())
    try:
        h = sched.submit([1, 2, 3], max_new_tokens=400)
        other = None
        it = h.stream(timeout=WAIT_S)
        got = list(next(it))
        plan = eng.faults = SV.FaultPlan()
        plan.add("step_launch", "raise", count=1,
                 exc=RuntimeError("mid-stream crash"))
        with pytest.raises(SV.SchedulerError):
            for chunk in it:
                got.extend(chunk)
        other = sched.submit([4, 5, 6], max_new_tokens=4)
        return {"state": h.state, "requeues": h._requeues,
                "published": len(got) == h._emitted,
                "other": (other.result(timeout=WAIT_S), other.state)}
    finally:
        sched.shutdown(drain=False, timeout=WAIT_S)


def test_mid_stream_crash_fails_and_is_not_requeued(stacks):
    ref, got = (_mid_stream(stacks, s) for s in ("jax", "torch"))
    assert got == ref
    assert got["state"] == "failed" and got["requeues"] == 0
    assert got["published"] and got["other"][1] == "done"


def _breaker(stacks, stack):
    SV = stacks[stack][2]
    out = {}
    rep = SV.Replica("r0", _engine(stacks, stack), max_restarts=2,
                     restart_window_s=60.0, poison_after=99)
    srv = SV.ServingServer(rep.scheduler, port=0).start()
    try:
        cl = SV.ServingClient(port=srv.port, timeout=WAIT_S)
        out["ready0"] = cl.readyz()["ready"]
        rep.kill()
        h = rep.submit([1, 2, 3], max_new_tokens=8)
        with pytest.raises(SV.SchedulerError):
            h.result(timeout=WAIT_S)
        with pytest.raises(SV.ServingHTTPError) as e:
            cl.readyz()
        out["readyz"] = (e.value.status, e.value.body["detail"])
        with pytest.raises(SV.ServingHTTPError) as e:
            cl.complete([1, 2, 3], max_tokens=2)
        out["complete"] = (e.value.status, e.value.retry_after_s is not None)
        with pytest.raises(SV.CrashLoopError):
            rep.submit([1, 2, 3], max_new_tokens=2)
        rep.revive()
        out["ready1"] = cl.readyz()["ready"]
        r = cl.complete([1, 2, 3], max_tokens=4)
        out["after"] = (r["state"], r["tokens"])
        out["restarts"] = rep.engine.restarts
    finally:
        srv.stop(drain=False, timeout=WAIT_S)
    return out


def test_breaker_flips_readyz_and_refuses_with_retry_after(stacks):
    ref, got = (_breaker(stacks, s) for s in ("jax", "torch"))
    assert got == ref
    assert got["readyz"] == (503, "crash_loop")
    assert got["complete"] == (503, True) and got["ready1"] is True


def _failover(stacks, stack):
    SV = stacks[stack][2]
    reps = SV.build_replicas(lambda i: _engine(stacks, stack, max_seqs=2),
                             2, max_queue=16, max_restarts=2,
                             restart_window_s=60.0, poison_after=99)
    router = SV.Router(reps, unhealthy_after=2, probe_after_s=30.0)
    try:
        prompt = [3, 1, 4, 1, 5]
        target = router.affinity_target(prompt)
        rep = router.replica(target)
        rep.pause()
        held = [router.submit(prompt, max_new_tokens=6) for _ in range(2)]
        rep.kill()
        rep.resume()
        outs = [r.result(timeout=WAIT_S) for r in held]
        return {"outs": outs, "target": target,
                "moved": [r.replica_id != target and r.failovers >= 1
                          for r in held],
                "health": router.stats()["replicas"][target]["health"],
                "ready": rep.ready()}
    finally:
        router.shutdown(drain=False, timeout=WAIT_S)


def test_router_fails_over_to_a_healthy_replica(stacks):
    ref, got = (_failover(stacks, s) for s in ("jax", "torch"))
    assert got == ref
    assert got["moved"] == [True, True] and got["health"] == "open"
    assert not got["ready"]


@pytest.mark.parametrize("point", ["suffix_prefill", "tier_restore"])
def test_admission_faults_conserve_the_pool(stacks, point):
    """A crash inside the bucketed suffix prefill (pages mapped, slot not
    attached) or the host tier's restore (before its alloc) releases
    everything; the requests are served again with the tokens of a run
    without the fault (`_requests` checks the pool)."""
    head = list(range(1, 17))              # two full pages
    if point == "suffix_prefill":
        # one slot: the later admissions hit the first one's pages
        prompts = [head + [20], head + [21], head + [22]]
        kw = {"ragged": False, "max_seqs": 1}
    else:
        # eight pages: the other prompts evict the head's pages to the
        # host tier, and the last admission restores them
        prompts = [head + [20]] + [[40 + i] * 17 for i in range(3)] + \
            [head + [21]]
        kw = {"host_tier_bytes": 1 << 20, "num_pages": 9, "max_seqs": 1}
    spec = f"{point}:raise@1"
    base = _requests(stacks, "torch", None, prompts=prompts, **kw)
    ref, got = (_requests(stacks, s, spec, prompts=prompts, **kw)
                for s in ("jax", "torch"))
    assert got == ref
    assert [o for o, _ in got["outs"]] == [o for o, _ in base["outs"]]
    assert got["fired"] == 1 and got["restarts"] == 1


def _handoff(stacks, stack, spec):
    """PROMPTS through a prefill replica and a decode replica, the
    engines' plans armed with `spec`."""
    SV = stacks[stack][2]
    reps = SV.build_replicas(lambda i: _engine(stacks, stack, spec), 2,
                             max_queue=8, roles=["prefill", "decode"])
    router = SV.Router(reps)
    try:
        router.pause()
        rrs = [router.submit(p, max_new_tokens=6) for p in PROMPTS]
        router.resume()
        outs = [rr.result(timeout=WAIT_S) for rr in rrs]
        return {"outs": outs,
                "engines": [(r.engine.handoff_exports,
                             r.engine.handoff_imports,
                             r.engine.handoff_failures) for r in reps]}
    finally:
        router.shutdown(drain=True, timeout=WAIT_S)


@pytest.mark.parametrize("spec", ["handoff_export:raise@1",
                                  "handoff_import:raise@1"],
                         ids=["handoff_export", "handoff_import"])
def test_handoff_faults_degrade_and_match(stacks, spec):
    base = _handoff(stacks, "torch", None)
    ref, got = (_handoff(stacks, s, spec) for s in ("jax", "torch"))
    assert got == ref
    assert got["outs"] == base["outs"]
    failures = sum(e[2] for e in got["engines"])
    assert failures == 1


def _dispatch(stacks, stack):
    SV = stacks[stack][2]
    reps = SV.build_replicas(lambda i: _engine(stacks, stack), 2,
                             max_queue=8)
    router = SV.Router(reps, faults=SV.FaultPlan("router_dispatch:raise@2"))
    try:
        out = [router.submit(PROMPTS[0], max_new_tokens=4).result(
            timeout=WAIT_S)]
        with pytest.raises(SV.InjectedFault) as e:
            router.submit(PROMPTS[1], max_new_tokens=4)
        out.append((e.value.point, e.value.hit))
        out.append(router.submit(PROMPTS[2], max_new_tokens=4).result(
            timeout=WAIT_S))
        return out
    finally:
        router.shutdown(drain=True, timeout=WAIT_S)


def test_router_dispatch_fault_matches(stacks):
    ref, got = (_dispatch(stacks, s) for s in ("jax", "torch"))
    assert got == ref and got[1] == ("router_dispatch", 2)


def _tier_spill(stack, spec):
    """One int8 page through each package's HostTier with `spec` armed:
    (pages landed, copy errors, the landed k's bytes)."""
    rng = np.random.default_rng(0)
    k = rng.integers(-127, 128, (2, 2, PAGE, 8), dtype=np.int8)
    v = rng.integers(-127, 128, (2, 2, PAGE, 8), dtype=np.int8)
    ks = rng.uniform(0.01, 1, (2, 2, PAGE, 1)).astype(np.float32)
    vs = rng.uniform(0.01, 1, (2, 2, PAGE, 1)).astype(np.float32)
    SV = JSV if stack == "jax" else PSV
    tier = SV.HostTier(PAGE, tier_bytes=1 << 20)
    tier.faults = SV.FaultPlan(spec, seed=5)
    block = tuple(range(PAGE))
    seed = 0x9E3779B9
    if stack == "jax":
        tier.spill_async(seed, block, 1, k, v, ks, vs, prequantized=True)
    else:
        tier.spill_async(seed, block, 1, *(torch.from_numpy(a)
                                           for a in (k, v, ks, vs)))
    assert tier.flush(timeout=WAIT_S)
    hits = tier.match(list(block) + [1], 0)
    got = None if not hits else np.asarray(hits[0]["k"]).tobytes()
    return tier.stats()["pages"], tier.copy_errors, got, k.tobytes()


@pytest.mark.parametrize("spec", ["tier_spill:corrupt@1",
                                  "tier_spill:raise@1"],
                         ids=["corrupt", "raise"])
def test_tier_spill_faults_match(spec):
    ref, got = (_tier_spill(s, spec) for s in ("jax", "torch"))
    assert got == ref
    pages, errors, landed, clean = got
    if spec.endswith("raise@1"):
        assert (pages, errors, landed) == (0, 1, None)
    else:
        diff = np.flatnonzero(np.frombuffer(landed, np.uint8)
                              != np.frombuffer(clean, np.uint8))
        assert (pages, errors, len(diff)) == (1, 0, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_corrupt_flips_the_reference_byte(dtype):
    """`corrupt` on a torch tensor flips the byte that the reference's
    flips on a numpy array of the same dtype and shape, at every hit."""
    import ml_dtypes
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 5, 7)).astype(np.float32)
    if dtype == "int8":
        a = (a * 40).astype(np.int8)
    arr = a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    jplan = JSV.FaultPlan("tier_spill:corrupt@1x3", seed=11)
    pplan = PSV.FaultPlan("tier_spill:corrupt@1x3", seed=11)
    for _ in range(3):
        ra = jplan.fire("tier_spill", arr)
        rt = pplan.fire("tier_spill", t)
        want = np.asarray(ra).view(np.uint8).reshape(-1)
        got = rt.contiguous().view(-1).view(torch.uint8).numpy()
        assert np.array_equal(got, want)
        assert np.count_nonzero(
            got != t.contiguous().view(-1).view(torch.uint8).numpy()) == 1
    assert pplan.stats() == jplan.stats()
