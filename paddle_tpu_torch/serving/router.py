"""Scale-out serving tier: prefix-affinity router over a replica pool.

One pump thread owning one engine is the single-host ceiling; this
module fans `/v1/completions` traffic across N independent replicas
(`serving/replica.py` — engine + scheduler + metrics per replica) from
any number of frontend threads:

  * **Prefix affinity.** The dispatch key is the chained block hash of
    the longest block-aligned prompt prefix — the SAME hash scheme the
    replicas' prefix caches index by (`serving/kvcache.py`), so two
    prompts that would share cached KV pages hash to the same key. The
    key picks a replica on a consistent-hash ring (virtual nodes), so
    a hot system prompt keeps landing on the replica that already
    holds its pages, and adding/draining a replica only re-homes the
    keys that map to it.
  * **Least-loaded spill.** When the affinity target refuses admission
    (`BackpressureError`) or is out of rotation, the request spills to
    the least-loaded healthy replica instead of queueing behind the
    hot spot. All replicas full → the BackpressureError propagates
    (HTTP 429, client owns the retry).
  * **Health / circuit breaker.** Per-replica consecutive-failure
    counts drive a breaker: `ok → open` after `unhealthy_after`
    consecutive failed requests (no new dispatches), `open →
    half_open` after `probe_after_s` (ONE probe request), probe
    success closes the breaker, probe failure re-opens it.
  * **Failover.** A request that its replica failed before emitting
    any output (queued-but-unstarted when the engine died) is
    transparently re-dispatched to another replica — same request id,
    same trace id, bounded by the set of remaining replicas. Outputs
    are token-identical to an undisturbed run because generation is
    deterministic given the request parameters.
  * **Graceful drain.** `drain_replica()` flips readiness off (ring
    exit + scheduler close), lets running work finish, then removes
    the replica — the rolling-restart primitive. Draining is refused
    when it would leave a non-empty pool with no prefill-eligible
    replica (queued requests would strand behind decode-only
    replicas); draining the very last replica stays allowed.
  * **Disaggregated prefill/decode.** Replicas carry a `role`
    (`replica.py`): only prefill-eligible ones ("prefill"/"both") own
    ring points and take new requests. A dispatch to a pure prefill
    replica arms `kv_export` whenever a decode-eligible replica is in
    rotation; when the request terminates in state "handoff" the
    consumer-side handle migrates it — `_migrate` re-submits the
    KVHandoff payload to the least-loaded decode replica ("decode"
    first, then "both", then the source itself as the never-dropped
    fallback) and the handle swaps underneath the caller invisibly.

Everything is host-side stdlib; the router never touches an engine
directly (TPL004: no engine/device calls under the router lock — the
lock only guards routing state; replica submits happen outside it).
`router.dispatch` / `router.failover` flight-recorder events carry
each request's trace id across the dispatch hop.

Counterpart of `paddle_tpu/serving/router.py`, carried over as a copy
(the port's host side is the reference's, held to it by the
`tests/test_torch_*.py` parity tests).
"""
from __future__ import annotations

import bisect
import itertools
import threading
import time

from ..observability import flight_recorder as _flight
from .kvcache import _SEED, block_hash
from .metrics import MetricsRegistry
from .scheduler import (BackpressureError, SchedulerClosedError,
                        SchedulerError)

__all__ = ["Router", "RouterRequest", "prefix_key"]


def prefix_key(tokens, page_size):
    """Routing key for a prompt: the chained block hash
    (`kvcache.block_hash`) of its longest block-aligned prefix, capped
    one token short exactly like `PrefixCache.match` — equal keys mean
    the replicas' caches would index the same page chain. Prompts with
    no full block hash their raw tokens so identical short prompts
    still co-locate. Returns (key, n_blocks)."""
    ps = int(page_size)
    toks = tuple(int(t) for t in tokens)
    n_blocks = max(len(toks) - 1, 0) // ps if ps > 0 else 0
    parent = _SEED
    for b in range(n_blocks):
        parent = block_hash(parent, toks[b * ps:(b + 1) * ps])
    if n_blocks == 0:
        parent = block_hash(parent, toks)
    return parent, n_blocks


class _HashRing:
    """Consistent-hash ring with virtual nodes. Not thread-safe — the
    router mutates it under its lock."""

    def __init__(self, vnodes=64):
        self.vnodes = int(vnodes)
        self._points = []            # sorted [(point, rid)]

    def add(self, rid):
        for i in range(self.vnodes):
            bisect.insort(self._points, (hash((rid, i)), rid))

    def remove(self, rid):
        self._points = [(p, r) for p, r in self._points if r != rid]

    def lookup(self, key):
        """Replica owning `key`: first point clockwise of it."""
        pts = self._points
        if not pts:
            return None
        i = bisect.bisect_left(pts, (key,))
        return pts[i % len(pts)][1]


class _ReplicaState:
    """Router-side view of one replica: circuit-breaker state plus
    dispatch accounting. Mutated only under the router lock."""

    __slots__ = ("replica", "state", "failures", "opened_at",
                 "probe_at", "dispatches", "failovers_in")

    def __init__(self, replica):
        self.replica = replica
        self.state = "ok"            # ok | open | half_open | draining
        self.failures = 0            # consecutive failed requests
        self.opened_at = 0.0
        self.probe_at = 0.0
        self.dispatches = 0
        self.failovers_in = 0        # requests failed over TO this one


class RouterRequest:
    """Caller-facing handle over whichever replica currently owns the
    request. Duck-types the `ServingRequest` surface the HTTP server
    consumes (`rid/req/state/error/output/trace_id`, `stream()`,
    `result()`, `cancel()`); on a replica failure BEFORE any output it
    re-dispatches to another replica transparently, so rolling
    restarts and engine crashes never surface for queued work."""

    def __init__(self, router, sr, replica_id, prompt_ids, params, key):
        self._router = router
        self._sr = sr                # current underlying ServingRequest
        self.replica_id = replica_id
        self._prompt = list(prompt_ids)
        # resubmit with the identical parameters + ids: failover output
        # must be what the original dispatch would have produced
        self._params = dict(params, rid=sr.rid, trace_id=sr.trace_id)
        self._key = key
        self._tried = [replica_id]
        self.failovers = 0
        self._reported = False

    # -- delegation to the current underlying request -----------------
    @property
    def rid(self):
        return self._sr.rid

    @property
    def req(self):
        return self._sr.req

    @property
    def state(self):
        return self._sr.state

    @property
    def error(self):
        return self._sr.error

    @property
    def output(self):
        return self._sr.output

    @property
    def trace_id(self):
        return self._sr.trace_id

    @property
    def priority(self):
        return self._sr.priority

    @property
    def t_first_token(self):
        return self._sr.t_first_token

    @property
    def timeline(self):
        """The CURRENT owner's timeline — after a migration this is
        the decode replica's, i.e. the full stitched ledger."""
        return self._sr.timeline

    @property
    def slo(self):
        return self._sr.slo

    @property
    def slo_attained(self):
        return self._sr.slo_attained

    @property
    def violated_phase(self):
        return self._sr.violated_phase

    def cancel(self):
        return self._sr.cancel()

    # -- failover machinery -------------------------------------------
    def _report(self):
        """Feed the terminal state into the router's health tracking
        exactly once per underlying dispatch."""
        if not self._reported:
            self._reported = True
            self._router._note_result(self.replica_id, self._sr.state)

    def _failed_unstarted(self):
        """Replica failed this request before the CONSUMER saw any
        bytes — the safe-to-replay case. Generated-but-unconsumed
        tokens (e.g. a warm restart's requeue cycles before the crash-
        loop breaker gave up) don't block failover: generation is
        deterministic for the given parameters, and a failed request
        never publishes further chunks, so a re-dispatch is token-
        identical to an undisturbed run."""
        return self._sr.state == "failed" and \
            not getattr(self._sr, "_streamed", False)

    def _failover_or_raise(self, err):
        self._report()
        nxt = self._router._redispatch(self)
        if nxt is None:
            raise err
        rid, sr = nxt
        self._tried.append(rid)
        self.replica_id = rid
        self._sr = sr
        self._reported = False
        self.failovers += 1

    def _continue_handoff(self):
        """The current replica finished its PREFILL half (terminal
        state "handoff", KVHandoff payload attached): migrate the
        request to a decode replica and swap the underlying handle.
        The decode submit presets the already-published output, so
        streaming resumes exactly where the prefill replica stopped."""
        self._report()               # handoff == success for health
        rid, sr = self._router._migrate(self)
        self._tried.append(rid)
        self.replica_id = rid
        self._sr = sr
        self._reported = False

    # -- consumption ---------------------------------------------------
    def stream(self, timeout=None):
        """Yield token chunks; a pre-first-token replica death is
        retried on another replica invisibly, and a prefill->decode
        handoff continues on the decode replica mid-stream. Once a
        chunk has been yielded the stream is never replayed (the
        caller already has tokens) — a later failure raises."""
        sent = 0
        while True:
            try:
                for chunk in self._sr.stream(timeout=timeout):
                    sent += 1
                    yield chunk
                if self._sr.state == "handoff":
                    self._continue_handoff()
                    continue
                self._report()
                return
            except Exception as e:  # noqa: BLE001 — terminal-state errors
                if sent == 0 and self._failed_unstarted():
                    self._failover_or_raise(e)
                    continue
                self._report()
                raise

    def result(self, timeout=None):
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            left = None if deadline is None \
                else max(deadline - time.monotonic(), 0.001)
            try:
                out = self._sr.result(timeout=left)
            except TimeoutError:
                raise
            except Exception as e:  # noqa: BLE001 — terminal-state errors
                if self._failed_unstarted():
                    self._failover_or_raise(e)
                    continue
                self._report()
                raise
            if self._sr.state == "handoff":
                self._continue_handoff()
                continue
            self._report()
            return out


class Router:
    """Replica pool + dispatcher. Duck-types the scheduler surface the
    HTTP server mounts (`submit/stats/readiness/shutdown/
    render_prometheus/metrics_snapshot`), so
    `ServingServer(Router(...))` is the whole wiring.

    The router lock guards ONLY routing state (ring, breaker states,
    counters); replica submits and stats reads happen outside it, so a
    slow replica never serializes dispatch to the others.
    """

    def __init__(self, replicas, *, policy="affinity", vnodes=64,
                 unhealthy_after=2, probe_after_s=1.0, metrics=None,
                 faults=None, fleet=None):
        if policy not in ("affinity", "round_robin"):
            raise ValueError(
                f"policy={policy!r}: use 'affinity' or 'round_robin'")
        # optional serving.faults.FaultPlan: the `router_dispatch`
        # point fires once per submit, before replica selection
        self.faults = faults
        # optional serving.fleet.FleetPlane: attaching it lights up
        # the /debug/fleet/* endpoints (cross-host stitched trace,
        # merged flight rings) on the server mounting this router
        self.fleet = fleet
        self._lock = threading.Lock()
        self._replicas = {}          # rid -> _ReplicaState (ordered)
        self._ring = _HashRing(vnodes)
        self._policy = policy
        self._rr = itertools.count()
        self.unhealthy_after = int(unhealthy_after)
        self.probe_after_s = float(probe_after_s)
        self.page_size = None
        self.registry = metrics if isinstance(metrics, MetricsRegistry) \
            else MetricsRegistry()
        r = self.registry
        self.dispatches = r.counter(
            "pt_router_dispatches", "Requests dispatched to a replica.")
        self.affinity_hits = r.counter(
            "pt_router_affinity_hits",
            "Dispatches that landed on the prefix-affinity target.")
        self.spills = r.counter(
            "pt_router_spills",
            "Dispatches diverted off the affinity target "
            "(backpressure or health).")
        self.probes = r.counter(
            "pt_router_probes", "Half-open circuit-breaker probes.")
        self.failovers = r.counter(
            "pt_router_failovers",
            "Requests re-dispatched after a replica failed them "
            "before any output.")
        self.rejects = r.counter(
            "pt_router_rejects",
            "Requests refused because every replica was full or out "
            "of rotation.")
        self.unhealthy_transitions = r.counter(
            "pt_router_unhealthy_transitions",
            "Circuit-breaker ok->open transitions.")
        self.handoffs = r.counter(
            "pt_router_handoffs",
            "Requests migrated prefill->decode after a KV export.")
        self.replicas_gauge = r.gauge(
            "pt_router_replicas", "Registered replicas.")
        self.ready_gauge = r.gauge(
            "pt_router_replicas_ready", "Replicas accepting dispatches.")
        # per-replica exposition cost (satellite of the timeline plane):
        # one labeled gauge per replica so a slow scrape names its
        # culprit; created lazily as replicas join
        self._scrape_gauges = {}
        for rep in replicas:
            self.add_replica(rep)

    # -- pool membership ----------------------------------------------
    def add_replica(self, replica):
        """Register a replica and give it ring ownership (rolling
        restarts re-add here after drain_replica removed). Decode-only
        replicas never own ring points — new prompts can't start
        there; they receive work only via `_migrate`."""
        rid = replica.replica_id
        ps = int(replica.page_size)
        with self._lock:
            if rid in self._replicas:
                raise ValueError(f"router: duplicate replica id {rid!r}")
            if self.page_size is None:
                self.page_size = ps
            elif ps != self.page_size:
                raise ValueError(
                    f"router: replica {rid!r} page_size={ps} != "
                    f"{self.page_size} — affinity keys would diverge "
                    "from the replicas' prefix caches")
            self._replicas[rid] = _ReplicaState(replica)
            if replica.prefill_eligible():
                self._ring.add(rid)
            self.replicas_gauge.set(len(self._replicas))

    def replica(self, rid):
        with self._lock:
            st = self._replicas.get(rid)
        return None if st is None else st.replica

    def affinity_target(self, prompt_ids):
        """Replica id the consistent-hash ring names for this prompt's
        prefix key, ignoring health — where the request WOULD go on a
        healthy pool (observability + tests)."""
        key, _ = prefix_key(prompt_ids, self.page_size or 1)
        with self._lock:
            return self._ring.lookup(key)

    @property
    def replica_ids(self):
        with self._lock:
            return list(self._replicas)

    def drain_replica(self, rid, timeout=None, remove=True):
        """Rolling-restart primitive: take `rid` out of rotation
        (readiness flips false immediately), let in-flight and queued
        work finish, then drop it from the pool. Returns True when the
        replica's pump exited within `timeout`.

        Refused (ValueError) when the replicas left behind form a
        NON-EMPTY pool with no prefill-eligible member — new requests
        would strand behind decode-only replicas that can never start
        them. Draining the very last replica stays allowed: an empty
        pool rejects crisply with SchedulerClosedError instead of
        silently queueing."""
        with self._lock:
            st = self._replicas.get(rid)
            if st is None:
                raise KeyError(f"router: no replica {rid!r}")
            rest = [s for r, s in self._replicas.items()
                    if r != rid and s.state != "draining"]
            if rest and not any(s.replica.prefill_eligible()
                                for s in rest):
                raise ValueError(
                    f"router: draining {rid!r} would leave no "
                    "prefill-eligible replica in rotation — new "
                    "requests would strand; drain a decode replica "
                    "first or add a 'prefill'/'both' replica")
            st.state = "draining"
            self._ring.remove(rid)
        _flight.record("router.drain", replica=rid)
        ok = st.replica.shutdown(drain=True, timeout=timeout)
        if remove:
            with self._lock:
                self._replicas.pop(rid, None)
                self.replicas_gauge.set(len(self._replicas))
        return ok

    # -- dispatch ------------------------------------------------------
    def submit(self, prompt_ids, *, priority="normal", ttl_s=None,
               trace_id=None, rid=None, **params):
        """Dispatch by prefix affinity with least-loaded spill; returns
        a RouterRequest. Raises BackpressureError when every eligible
        replica refused admission, SchedulerClosedError when none is in
        rotation, ValueError for a request no engine could run (the
        first candidate validates it)."""
        if self.faults is not None:
            self.faults.fire("router_dispatch",
                             rids=None if rid is None else [str(rid)])
        key, n_blocks = prefix_key(prompt_ids, self.page_size or 1)
        plan = self._plan(key)
        kw = dict(params, priority=priority, ttl_s=ttl_s,
                  trace_id=trace_id)
        last_err = None
        for target, kind in plan:
            with self._lock:
                st = self._replicas.get(target)
            if st is None:           # removed between plan and dispatch
                continue
            try:
                # kv_export is decided PER DISPATCH (never stored in
                # the replay params): a failover or topology change
                # must re-decide against the replica that actually
                # takes the request
                sr = st.replica.submit(
                    prompt_ids, rid=rid,
                    kv_export=self._kv_export_for(target), **kw)
            except BackpressureError as e:
                last_err = e
                continue
            except SchedulerClosedError as e:
                last_err = e
                continue
            self._note_dispatch(target, kind, sr, n_blocks)
            return RouterRequest(self, sr, target, prompt_ids, kw, key)
        self.rejects.inc()
        if last_err is not None:
            raise last_err
        raise SchedulerClosedError(
            "router: no replica in rotation (all draining or removed)")

    def _plan(self, key):
        """Dispatch order: the affinity target first (consistent-hash
        owner of the key; `round_robin` policy rotates instead), then
        every other eligible replica by ascending load — the spill
        order. Half-open probes ride the same plan with kind
        'probe'."""
        now = time.monotonic()
        with self._lock:
            if not self._replicas:
                raise SchedulerClosedError("router: no replicas")
            if self._policy == "affinity":
                primary = self._ring.lookup(key)
            else:
                rids = [i for i, st in self._replicas.items()
                        if st.state != "draining"
                        and st.replica.prefill_eligible()]
                primary = rids[next(self._rr) % len(rids)] if rids \
                    else None
            # decode-only replicas never take NEW requests — they are
            # fed exclusively through _migrate (KV handoff import)
            cands = [(i, st.replica, self._eligibility_locked(st, now))
                     for i, st in self._replicas.items()
                     if st.replica.prefill_eligible()]
        plan = []
        spill = []
        for i, rep, elig in cands:
            if elig is None:
                continue
            if i == primary:
                kind = "probe" if elig == "probe" else (
                    "affinity" if self._policy == "affinity" else "rr")
                plan.append((i, kind))
            else:
                # load() is one scheduler-lock hop per replica; done
                # OUTSIDE the router lock so dispatch never serializes
                # on a slow replica
                spill.append((rep.load(), i,
                              "probe" if elig == "probe" else "spill"))
        spill.sort(key=lambda t: t[0])
        plan.extend((i, kind) for _, i, kind in spill)
        return plan

    def _eligibility_locked(self, st, now):
        """None (skip), 'ok', or 'probe' (breaker half-open trial)."""
        if st.state == "draining":
            return None
        if st.state == "ok":
            return "ok"
        if st.state == "half_open":
            # one probe at a time; a probe that never reports back
            # (abandoned handle) unblocks after another cooldown
            if now - st.probe_at >= self.probe_after_s:
                return "probe"
            return None
        # open: cooled down -> offer one probe
        if now - st.opened_at >= self.probe_after_s:
            return "probe"
        return None

    def _note_dispatch(self, rid, kind, sr, n_blocks):
        with self._lock:
            st = self._replicas.get(rid)
            if st is not None:
                st.dispatches += 1
                if kind == "probe":
                    st.state = "half_open"
                    st.probe_at = time.monotonic()
        self.dispatches.inc()
        if kind == "affinity":
            self.affinity_hits.inc()
        elif kind == "probe":
            self.probes.inc()
        elif kind == "spill":
            self.spills.inc()
        # "rr" (round_robin primary) counts only as a dispatch
        _flight.record("router.dispatch", rid=str(sr.rid),
                       trace_id=sr.trace_id, replica=rid, route=kind,
                       prefix_blocks=n_blocks)

    # -- disaggregated prefill/decode ---------------------------------
    def _kv_export_for(self, rid):
        """True when a dispatch to `rid` should arm KV handoff: the
        target is a PURE prefill replica and a decode-eligible replica
        is in rotation somewhere to receive the pages. "both" targets
        never export — they decode locally (today's behavior,
        handoff machinery stays cold)."""
        with self._lock:
            st = self._replicas.get(rid)
            if st is None or st.replica.role != "prefill":
                return False
            return any(o.state != "draining"
                       and o.replica.decode_eligible()
                       for r2, o in self._replicas.items() if r2 != rid)

    def _migrate(self, rr: RouterRequest):
        """Continue a handoff-terminal request on a decode replica.
        Target order: pure "decode" replicas by ascending load, then
        "both" replicas by ascending load, then the SOURCE replica
        itself — it just released the pages, so re-importing there is
        the never-dropped fallback (the request decodes locally, just
        without the disaggregation win). Returns (rid, ServingRequest);
        raises the last admission error only when every candidate
        including the source refused."""
        h = rr._sr.handoff
        src = rr.replica_id
        with self._lock:
            items = [(r, st.replica) for r, st in self._replicas.items()
                     if r != src and st.state != "draining"
                     and st.replica.decode_eligible()]
        # load() hops each replica's scheduler lock — outside ours
        ranked = sorted(((rep.role != "decode", rep.load(), r, rep)
                         for r, rep in items), key=lambda t: t[:2])
        cands = [(r, rep) for _, _, r, rep in ranked]
        src_rep = self.replica(src)
        if src_rep is not None:
            cands.append((src, src_rep))
        last_err = None
        for target, rep in cands:
            try:
                sr = rep.submit(rr._prompt, kv_import=h, **rr._params)
            except (BackpressureError, SchedulerClosedError) as e:
                last_err = e
                continue
            with self._lock:
                st = self._replicas.get(target)
                if st is not None:
                    st.dispatches += 1
            self.handoffs.inc()
            _flight.record("router.handoff", rid=str(sr.rid),
                           trace_id=sr.trace_id, from_replica=src,
                           to_replica=target, bytes=h.nbytes,
                           pages=h.pages)
            return target, sr
        raise last_err if last_err is not None else \
            SchedulerClosedError(
                f"router: no replica could continue handoff {rr.rid}")

    # -- failover ------------------------------------------------------
    def _redispatch(self, rr: RouterRequest):
        """Re-dispatch a failed-before-output request to a replica it
        has not tried. Returns (rid, ServingRequest) or None when no
        replica can take it."""
        tried = set(rr._tried)
        try:
            plan = self._plan(rr._key)
        except SchedulerClosedError:
            return None
        for target, _kind in plan:
            if target in tried:
                continue
            with self._lock:
                st = self._replicas.get(target)
            if st is None:
                continue
            try:
                sr = st.replica.submit(
                    rr._prompt, kv_export=self._kv_export_for(target),
                    **rr._params)
            except (BackpressureError, SchedulerClosedError):
                continue
            with self._lock:
                st.failovers_in += 1
            self.failovers.inc()
            _flight.record("router.failover", rid=str(sr.rid),
                           trace_id=sr.trace_id,
                           from_replica=rr.replica_id, to_replica=target,
                           attempt=rr.failovers + 1)
            return target, sr
        return None

    # -- health tracking ----------------------------------------------
    def _note_result(self, rid, state):
        """Terminal state of one dispatched request — drives the
        circuit breaker. Success closes, consecutive failures open,
        probe outcomes resolve half-open."""
        with self._lock:
            st = self._replicas.get(rid)
            if st is None:
                return
            if state in ("done", "handoff"):
                # a handoff is the prefill replica SUCCEEDING at its
                # half of the request — it closes breakers like "done"
                st.failures = 0
                if st.state in ("open", "half_open"):
                    st.state = "ok"
                    _flight.record("router.recovered", replica=rid)
            elif state == "failed":
                st.failures += 1
                if st.state == "half_open":
                    st.state = "open"        # failed probe: re-open
                    st.opened_at = time.monotonic()
                elif st.state == "ok" and \
                        st.failures >= self.unhealthy_after:
                    st.state = "open"
                    st.opened_at = time.monotonic()
                    self.unhealthy_transitions.inc()
                    _flight.record("router.unhealthy", replica=rid,
                                   failures=st.failures)
            # cancelled/expired say nothing about replica health

    # -- scheduler-surface duck type ----------------------------------
    def stats(self):
        with self._lock:
            items = [(rid, st.replica, st.state, st.failures,
                      st.dispatches, st.failovers_in)
                     for rid, st in self._replicas.items()]
        reps, queued, inflight, active, n_ready = {}, 0, 0, 0, 0
        n_closed = 0
        for rid, rep, state, failures, dispatches, fo in items:
            s = rep.stats()
            ready = state == "ok" and s["ready"]
            n_ready += ready
            n_closed += s.get("closed", False)
            queued += s["queued"]
            inflight += s["inflight"]
            active += s["active"]
            reps[rid] = {
                "health": state, "ready": ready,
                "role": s.get("role", "both"),
                "consecutive_failures": failures,
                "dispatches": dispatches, "failovers_in": fo,
                "queued": s["queued"], "inflight": s["inflight"],
                "active": s["active"], "requests": s.get("requests"),
            }
            # fleet mode: the worker's host tag rides every per-replica
            # payload; absent on in-process replicas (byte-identical)
            host = s.get("host") or getattr(rep, "host", None)
            if host is not None:
                reps[rid]["host"] = host
        self.ready_gauge.set(n_ready)
        # closed is LIVENESS (every pump gone), not readiness: a fully
        # paused pool is alive (healthz "ok") but not ready (readyz 503)
        return {"replicas": reps, "queued": queued,
                "inflight": inflight, "active": active,
                "replicas_ready": n_ready,
                "closed": n_closed == len(items),
                "router": {
                    "dispatches": self.dispatches.value,
                    "affinity_hits": self.affinity_hits.value,
                    "spills": self.spills.value,
                    "failovers": self.failovers.value,
                    "handoffs": self.handoffs.value,
                    "unhealthy_transitions":
                        self.unhealthy_transitions.value,
                }}

    def readiness(self):
        """Router readiness: at least one replica in rotation and
        accepting. Per-replica detail rides along so an external LB
        (or a human) sees who is out and why."""
        st = self.stats()
        detail = {rid: ("ok" if r["ready"] else r["health"])
                  for rid, r in st["replicas"].items()}
        return st["replicas_ready"] > 0, detail

    def pause(self):
        for rid in self.replica_ids:
            rep = self.replica(rid)
            if rep is not None:
                rep.pause()

    def resume(self):
        for rid in self.replica_ids:
            rep = self.replica(rid)
            if rep is not None:
                rep.resume()

    def drain(self, timeout=None):
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        ok = True
        for rid in self.replica_ids:
            rep = self.replica(rid)
            if rep is None:
                continue
            left = None if deadline is None \
                else max(deadline - time.monotonic(), 0.0)
            ok = rep.drain(timeout=left) and ok
        return ok

    def shutdown(self, drain=True, timeout=None):
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        ok = True
        for rid in self.replica_ids:
            rep = self.replica(rid)
            if rep is None:
                continue
            left = None if deadline is None \
                else max(deadline - time.monotonic(), 0.0)
            ok = rep.shutdown(drain=drain, timeout=left) and ok
        return ok

    # -- metrics aggregation ------------------------------------------
    def _scrape_gauge(self, rid, host=None):
        g = self._scrape_gauges.get(rid)
        if g is None:
            labels = {"replica": rid}
            if host is not None:
                labels["host"] = host
            g = self.registry.gauge(
                "pt_router_scrape_seconds",
                "Wall time of the last /metrics scrape of this "
                "replica's registry (a slow replica's exposition cost, "
                "made visible).", labels=labels)
            self._scrape_gauges[rid] = g
        return g

    @staticmethod
    def _scrape_replica(rep):
        """One replica's exposition. Goes through the scheduler when
        there is one so the scrape-side work that must never run on a
        pump (anomaly-sentinel analysis) happens here."""
        sched = getattr(rep, "scheduler", None)
        if sched is not None and hasattr(sched, "render_prometheus"):
            return sched.render_prometheus()
        return rep.registry.render_prometheus()

    def render_prometheus(self):
        """Router counters plus every replica's exposition with a
        `replica="<id>"` label injected on each series (HELP/TYPE
        comments are kept only for the router's own metrics — repeated
        per-replica TYPE lines would be invalid exposition).

        Lock discipline (TPL004, same as dispatch): the membership
        snapshot is taken under the router lock, but every replica
        scrape — registry render, relabel, sentinel scan — runs
        OUTSIDE it, so one replica's slow exposition can never stall
        submits. Each replica's scrape wall time lands in its
        `pt_router_scrape_seconds{replica=}` gauge."""
        self.stats()                 # refresh ready gauge
        with self._lock:
            items = [(rid, st.replica) for rid, st in
                     self._replicas.items()]
        parts = []
        for rid, rep in items:
            t0 = time.perf_counter()
            host = getattr(rep, "host", None)
            text = _relabel(self._scrape_replica(rep), rid, host=host)
            self._scrape_gauge(rid, host).set(time.perf_counter() - t0)
            parts.append(text)
        # the router's own registry renders LAST so the scrape gauges
        # it just set are current in the same exposition
        return "".join([self.registry.render_prometheus()] + parts)

    def metrics_snapshot(self):
        """JSON snapshot: router metrics flat (as the single-scheduler
        server exposes its registry) plus one nested snapshot per
        replica under "replicas"."""
        with self._lock:
            items = [(rid, st.replica) for rid, st in
                     self._replicas.items()]
        reps = {}
        for rid, rep in items:
            t0 = time.perf_counter()
            sched = getattr(rep, "scheduler", None)
            if sched is not None and hasattr(sched, "metrics_snapshot"):
                reps[rid] = sched.metrics_snapshot()
            else:
                reps[rid] = rep.registry.snapshot()
            host = getattr(rep, "host", None)
            if host is not None and isinstance(reps[rid], dict):
                reps[rid]["host"] = host
            self._scrape_gauge(rid, host).set(time.perf_counter() - t0)
        snap = self.registry.snapshot()
        snap["replicas"] = reps
        return snap

    def recent_requests(self, n=50):
        """Aggregate /debug/requests across the pool: each replica's
        recent terminal requests tagged with `replica=<id>`, merged in
        end-time order (newest last), trimmed to `n`. A migrated
        request appears once per replica that finalized it — the
        decode-side entry carries the full stitched timeline."""
        with self._lock:
            items = [(rid, st.replica) for rid, st in
                     self._replicas.items()]
        merged = []
        for rid, rep in items:
            sched = getattr(rep, "scheduler", None)
            if sched is None or not hasattr(sched, "recent_requests"):
                continue
            host = getattr(rep, "host", None)
            for entry in sched.recent_requests(n):
                e = dict(entry)
                e["replica"] = rid
                if host is not None:
                    e["host"] = host
                merged.append(e)
        # entries without a timeline sort stably at the front
        merged.sort(key=lambda e: (e.get("marks") or [[None, 0.0]])[-1][1])
        return merged[-int(n):] if n else merged

    def pulse(self, window=None, signals=None):
        """Aggregate /debug/pulse across the pool: one payload per
        replica under `replicas` (the `replica=` tag of the pulse
        plane), behind the same duck-typed method the single-scheduler
        server mounts. Same TPL004 discipline as the scrapes: the
        membership snapshot is taken under the router lock, every
        replica's (possibly sampling) pulse call runs OUTSIDE it."""
        with self._lock:
            items = [(rid, st.replica) for rid, st in
                     self._replicas.items()]
        reps = {}
        for rid, rep in items:
            sched = getattr(rep, "scheduler", None)
            if sched is not None and hasattr(sched, "pulse"):
                payload = sched.pulse(window=window, signals=signals)
                host = getattr(rep, "host", None)
                if host is not None and isinstance(payload, dict):
                    payload["host"] = host
                reps[rid] = payload
        return {"enabled": any(p.get("enabled") for p in reps.values()),
                "replicas": reps}

    # -- fleet observability (delegated to the attached plane) ---------
    def fleet_trace(self):
        """Merged, skew-corrected chrome trace across every fleet
        process — None when no FleetPlane is attached (the server maps
        that to 404)."""
        if self.fleet is None:
            return None
        return self.fleet.fleet_trace()

    def fleet_flightrecorder(self):
        """Merged flight-ring dump across the fleet — None when no
        FleetPlane is attached."""
        if self.fleet is None:
            return None
        return self.fleet.fleet_flightrecorder()


def _relabel(text, rid, host=None):
    """Inject replica="<rid>" — plus host="<host>" in fleet mode —
    into every series line of a Prometheus exposition (comment lines
    dropped — see render_prometheus)."""
    tag = f'replica="{rid}"'
    if host is not None:
        tag += f',host="{host}"'
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, rest = line.partition(" ")
        if "{" in name:
            base, _, labels = name.partition("{")
            name = f"{base}{{{tag},{labels}"
        else:
            name = f"{name}{{{tag}}}"
        out.append(f"{name} {rest}")
    return "\n".join(out) + "\n" if out else ""
