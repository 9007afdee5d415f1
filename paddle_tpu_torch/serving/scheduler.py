"""Multi-tenant request scheduler over the continuous-batching engine.

`RequestScheduler` turns `models/llama_serving.ServingEngine` — a
single-threaded step loop — into a runtime that concurrent frontends
can submit to:

  * admission control: a bounded queue per priority class; a full
    queue raises `BackpressureError` (explicit 429-style rejection,
    never a silent drop);
  * deadlines: each request may carry a TTL — queued requests past
    their deadline are expired without touching the engine, running
    ones are cancelled at the next step boundary;
  * priority classes: "high" / "normal" / "low" — the pump feeds the
    engine highest-class-first whenever a slot frees up (the engine's
    own FIFO is never allowed to stack, so a late high-priority
    arrival cannot be inverted by it);
  * graceful drain: `shutdown(drain=True)` stops admissions, lets
    in-flight work finish, then parks the pump thread;
  * crash recovery (docs/reliability.md): a pump exception warm-
    restarts the engine instead of failing every request — device
    state is released, requests that never streamed a byte are
    REQUEUED (same rid/trace id/deadline/priority; generated-so-far
    tokens replayed through the prefix-cache/suffix-prefill resume
    path, token-identically), only mid-stream requests fail. A
    request admitted across `poison_after` consecutive crashed steps
    is quarantined as poison (fails alone, never requeued again), and
    `max_restarts` restarts within `restart_window_s` trip a crash-
    loop breaker: readiness flips false (/readyz 503, the router's
    failover takes over) and admission refuses with CrashLoopError
    until `reset_breaker()` (Replica.revive calls it).

The engine itself is NOT thread-safe and is only ever touched by the
pump thread; cross-thread communication is flag-based (cancel marks)
plus per-request chunk queues, all under one condition variable.

Counterpart of `paddle_tpu/serving/scheduler.py`, carried over as a copy
(the port's host side is the reference's, held to it by the
`tests/test_torch_*.py` parity tests).
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque

from .._env import env_bool
from ..observability import device_telemetry as _devtel
from ..observability import flight_recorder as _flight
from ..observability import trace_context as _tc
from ..observability.logging import get_logger
from .metrics import EngineMetrics, MetricsRegistry
from .timeline import StepAnomalySentinel, Timeline, judge_slo, \
    resolve_slo

__all__ = ["RequestScheduler", "ServingRequest", "SchedulerError",
           "BackpressureError", "DeadlineExceededError",
           "SchedulerClosedError", "PoisonedRequestError",
           "CrashLoopError", "PRIORITIES"]

PRIORITIES = ("high", "normal", "low")


class SchedulerError(RuntimeError):
    pass


class BackpressureError(SchedulerError):
    """Admission refused: the bounded queue is full. HTTP frontends
    map this to 429 with Retry-After."""

    def __init__(self, msg, retry_after_s=1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class DeadlineExceededError(SchedulerError):
    """The request's TTL elapsed before it completed."""


class SchedulerClosedError(SchedulerError):
    """submit() after shutdown() began."""


class PoisonedRequestError(SchedulerError):
    """The request was quarantined: it sat in the admitted set for
    `poison_after` consecutive crashed engine steps, so the scheduler
    attributes the crash loop to it. It fails alone — client-visible
    as a `poisoned` error — and is never requeued again."""


class CrashLoopError(SchedulerClosedError):
    """Admission refused: the crash-loop breaker is open
    (`max_restarts` engine restarts within `restart_window_s`). HTTP
    frontends map this to 503 with Retry-After; the router skips to
    the next replica (it subclasses SchedulerClosedError)."""

    def __init__(self, msg, retry_after_s=1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class ServingRequest:
    """Handle a submitter holds: stream tokens as they are emitted, or
    block for the full result. Terminal states: "done", "cancelled",
    "expired", "failed", "handoff" (prefill complete, KV exported — the
    `handoff` attribute carries the KVHandoff payload and a decode
    replica owns the rest of the request's life)."""

    def __init__(self, sched, req, priority, deadline, trace_id=None):
        self._sched = sched
        self.req = req                  # engine-level Request
        self.rid = req.rid
        # request-scoped trace identity: everything this request causes
        # (spans, flight events, log lines) carries this id
        self.trace_id = trace_id or _tc.current_trace_id() or str(req.rid)
        self.priority = priority
        self.deadline = deadline        # absolute time.monotonic() or None
        self.state = "queued"
        self.error = None
        self.t_submit = time.monotonic()
        self.t_admitted = None          # pump fed the engine
        self.t_first_token = None
        self.t_done = None
        self.chunks = queue.Queue()     # lists of token ids; None = EOS
        self._emitted = 0
        self._cancel_requested = False
        self._cancel_applied = False
        self._expired = False
        # crash-recovery state: `_streamed` flips when a consumer has
        # SEEN a chunk (the point of no replay — published-but-unread
        # chunks stay replayable because recovery is token-identical);
        # `_crash_streak` counts consecutive crashed steps while
        # admitted (quarantine attribution, reset by a proven step);
        # `_requeues` is the request's lifetime warm-restart count
        self._streamed = False
        self._started = False
        self._crash_streak = 0
        self._requeues = 0
        self._proof_mark = 0
        # disaggregated serving: the KVHandoff payload when this
        # request terminates with state "handoff" (router migration)
        self.handoff = None
        # timeline plane (serving/timeline.py): the stitched phase
        # ledger (None when PT_SERVE_TIMELINE=0), the SLO class, and
        # the finalize-time verdict
        self.timeline = None
        self.slo = None
        self.slo_attained = None
        self.violated_phase = None
        self._done = threading.Event()

    @property
    def output(self):
        return list(self.req.output)

    def cancel(self):
        """Request cancellation; applied by the pump at the next step
        boundary. Returns False if already terminal."""
        return self._sched._request_cancel(self)

    def stream(self, timeout=None):
        """Yield lists of newly emitted token ids until the request
        reaches a terminal state; raises the terminal error (deadline,
        failure) if there is one."""
        while True:
            chunk = self.chunks.get(timeout=timeout)
            if chunk is None:
                if self.error is not None:
                    raise self.error
                return
            # the consumer is about to see bytes: from here on a crash
            # must fail this request, never silently replay it
            self._streamed = True
            yield chunk

    def result(self, timeout=None):
        """Block until terminal; return the full output token list."""
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(f"request {self.rid}: not done")
        if self.error is not None:
            raise self.error
        return self.output


class RequestScheduler:
    """Thread-safe frontend over one ServingEngine (see module doc)."""

    def __init__(self, engine, max_queue=64, metrics=None,
                 idle_poll_s=0.02, start=True, pipeline=None,
                 poison_after=3, max_restarts=5, restart_window_s=10.0,
                 breaker_retry_after_s=1.0):
        self._engine = engine
        # pipeline=True: double-buffered pump (docs/serving.md
        # § Pipelined step loop) — launch device step N+1 before
        # consuming step N's result record, so host bookkeeping and
        # next-wave admission overlap the in-flight device program.
        # Default comes from PT_SERVE_PIPELINE. Spec-decode engines
        # stay synchronous (drafting needs host-current context);
        # slow-path events (cancel/TTL/preempt/failure/shutdown) drain
        # the one-step-deep pipeline before acting, so every mode is
        # token-identical to the synchronous pump.
        if pipeline is None:
            pipeline = env_bool("PT_SERVE_PIPELINE")
        self._pipeline = bool(pipeline) and \
            getattr(engine, "spec_decode", 0) <= 1
        # the launched-but-unconsumed StepTicket; pump-thread only
        # (written outside the lock by design — _expire_and_cancel
        # just reads it to defer engine-side cancel application)
        self._pending = None
        self.max_queue = int(max_queue)
        if self.max_queue < 1:
            raise ValueError(f"max_queue={max_queue}: want >= 1")
        registry = metrics if isinstance(metrics, MetricsRegistry) \
            else None
        self.metrics = EngineMetrics(registry, external_queue=True)
        self.registry = self.metrics.registry
        # the engine reports TTFT/TPOT/occupancy itself through the
        # same hook object; the scheduler owns queue depth + rejections
        engine.metrics = self.metrics
        self._log = get_logger("serving")
        self._idle_poll_s = idle_poll_s
        self._cond = threading.Condition()
        self._queues = {p: deque() for p in PRIORITIES}
        self._inflight = {}             # id(engine Request) -> handle
        # monotonic request ledger: routers and external health checks
        # need DELTAS ("did this replica finish anything since the last
        # probe?"), which the point-in-time gauges cannot answer.
        # Mutated only under self._cond; surfaced by stats()/healthz
        # and mirrored to pt_serving_requests_{started,failed} counters.
        # `requeued` counts warm-restart requeues ONCE each — the
        # conservation invariant stays submitted == completed + failed
        # + cancelled + expired + queued + inflight (a requeued request
        # simply moves back into `queued`)
        self._ledger = {"submitted": 0, "started": 0, "completed": 0,
                        "failed": 0, "cancelled": 0, "expired": 0,
                        "requeued": 0, "handoff": 0}
        # crash recovery (docs/reliability.md). Quarantine: a request
        # admitted across `poison_after` consecutive crashed steps is
        # the attributed poison. Breaker: `max_restarts` restarts
        # within `restart_window_s` seconds flip readiness false and
        # refuse admission (CrashLoopError) until reset_breaker().
        # Probation (`_suspects`/`_unproven`): requeued victims are
        # re-admitted one at a time until each survives a step, so a
        # poison request crashes ALONE and innocents never accumulate
        # a streak.
        self.poison_after = int(poison_after)
        self.max_restarts = int(max_restarts)
        self.restart_window_s = float(restart_window_s)
        self.breaker_retry_after_s = float(breaker_retry_after_s)
        if self.poison_after < 1:
            raise ValueError(f"poison_after={poison_after}: want >= 1")
        if self.max_restarts < 1:
            raise ValueError(f"max_restarts={max_restarts}: want >= 1")
        self._suspects = set()          # requeued, not yet proven
        self._unproven = set()          # fed back, awaiting one step
        self._restart_t = deque()       # restart times in the window
        self._broken = False
        self._quarantined = 0
        self._fin_seen = len(engine.finished)
        # timeline + SLO plane (serving/timeline.py). PT_SERVE_TIMELINE=0
        # disables it entirely — every request's `timeline` stays None,
        # every mark site is a no-op, and token outputs are untouched
        # either way (the plane is host-clock bookkeeping only).
        self._timeline_on = env_bool("PT_SERVE_TIMELINE")
        # step-time anomaly sentinel: the pump appends samples, ALL
        # analysis runs in _scan_anomalies on the scrape thread
        self._sentinel = StepAnomalySentinel()
        # completed-request ring for /debug/requests
        self._recent = deque(maxlen=256)
        # pulse plane (observability/pulse.py): ring-buffer time-series
        # over this registry + anomaly-triggered capture bundles. Its
        # daemon thread ticks at PT_PULSE_INTERVAL_S; scrapes also
        # sample opportunistically. PT_SERVE_PULSE=0 -> no plane object,
        # no thread, token-identical serving either way (the plane only
        # ever reads host-side snapshots).
        self._pulse = None
        if env_bool("PT_SERVE_PULSE"):
            from ..observability.pulse import PulsePlane
            self._pulse = PulsePlane(
                self._pulse_snapshot,
                scan_fn=self._scan_anomalies,
                info_fn=self._pulse_info,
                recent_fn=self.recent_requests,
                self_cost_fn=self.metrics.observe_scrape_self)
        self._rid = itertools.count()
        self._closed = False
        self._paused = False
        self._drained = threading.Event()
        self._drained.set()
        self._thread = threading.Thread(target=self._pump,
                                        name="pt-serving-pump",
                                        daemon=True)
        if start:
            self._thread.start()

    # -- submission (any thread) --------------------------------------
    def submit(self, prompt_ids, *, rid=None, max_new_tokens=64,
               eos_id=None, temperature=0.0, top_k=0, top_p=1.0,
               seed=None, logprobs=False, priority="normal",
               ttl_s=None, trace_id=None, kv_export=False,
               kv_import=None, slo=None):
        """Admit-or-refuse NOW: raises BackpressureError on a full
        queue, SchedulerClosedError during shutdown, ValueError for a
        request the engine could never run. Returns a ServingRequest.

        `slo` names the request's latency objective class
        ("interactive" / "batch"; None defaults from priority — see
        serving/timeline.py): finalize judges ttft/tpot against the
        class targets and books goodput.

        Disaggregated serving (docs/serving.md § Disaggregated
        prefill/decode): `kv_export=True` marks the request for KV
        handoff — it terminates with state "handoff" (payload on
        `sr.handoff`) once its prompt is prefilled and seeded;
        `kv_import=<KVHandoff>` resumes an exported request here — its
        generated-so-far output is pre-seeded and only NEW tokens
        stream from this handle (the payload's timeline, when present,
        is stitched into the resumed request)."""
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority={priority!r}: want one of {PRIORITIES}")
        if ttl_s is not None and ttl_s <= 0:
            raise ValueError(f"ttl_s={ttl_s}: want > 0 or None")
        slo = resolve_slo(slo, priority)    # ValueError on a bad class
        from ..models.llama_serving import Request
        req = Request(rid if rid is not None
                      else f"sr{next(self._rid)}",
                      prompt_ids, max_new_tokens=max_new_tokens,
                      eos_id=eos_id, temperature=temperature,
                      top_k=top_k, top_p=top_p, seed=seed,
                      logprobs=logprobs)
        if kv_import is not None:
            # resume mid-generation: everything the prefill replica
            # decided rides in; the pending next_token is output's tail
            req.output = [int(t) for t in kv_import.output]
            req.next_token = int(kv_import.next_token)
            req.cached_tokens = int(kv_import.cached_tokens)
            if logprobs and kv_import.logprobs is not None:
                req.logprobs = list(kv_import.logprobs)
            req._kv_import = kv_import
        if kv_export:
            req._handoff_export = True
        self._engine.validate(req)      # never-fits -> ValueError, now
        deadline = None if ttl_s is None else time.monotonic() + ttl_s
        with self._cond:
            if self._closed:
                raise SchedulerClosedError(
                    "serving: scheduler is shutting down")
            if self._broken:
                self.metrics.on_reject()
                _flight.record("sched.reject", rid=str(req.rid),
                               trace_id=trace_id, priority=priority,
                               reason="crash_loop")
                raise CrashLoopError(
                    "serving: crash-loop breaker open "
                    f"({len(self._restart_t)} engine restarts within "
                    f"{self.restart_window_s:g}s); replica needs "
                    "intervention", retry_after_s=self.breaker_retry_after_s)
            depth = self._queued_locked()
            if depth >= self.max_queue:
                self.metrics.on_reject()
                _flight.record("sched.reject", rid=str(req.rid),
                               trace_id=trace_id, priority=priority,
                               depth=depth, max_queue=self.max_queue)
                raise BackpressureError(
                    f"serving: queue full ({depth}/{self.max_queue}); "
                    "retry later")
            sr = ServingRequest(self, req, priority, deadline,
                                trace_id=trace_id)
            sr.slo = slo
            if self._timeline_on:
                tl = None
                if kv_import is not None:
                    # stitch: continue the exporting side's ledger so
                    # the migrated request keeps ONE timeline
                    tl = Timeline.from_dict(
                        getattr(kv_import, "timeline", None))
                if tl is None:
                    tl = Timeline()
                    tl.mark("submit")
                if kv_import is not None:
                    tl.mark("migrate")
                sr.timeline = tl
                # the engine stamps exceptional transitions (preempt /
                # spill / handoff) straight onto the request's ledger —
                # duck-typed, no model-code import of this module
                req._timeline = tl
            if kv_import is not None:
                # imported tokens were already streamed by the prefill
                # replica's handle — this one emits only NEW tokens
                sr._emitted = len(req.output)
            # stamp the engine-level request too: engine-side flight
            # records (kvcache.hit / kvtier.hit) carry the same trace
            # id as the scheduler's spans without importing anything
            req._trace_id = sr.trace_id
            _flight.record("sched.submit", rid=str(sr.rid),
                           trace_id=sr.trace_id, priority=priority,
                           ttl_s=ttl_s, prompt_tokens=len(req.prompt),
                           depth=depth)
            # TTFT clock starts at scheduler admission, so queueing
            # latency is part of the number (the engine stamps only if
            # unset)
            req._t_submit = time.perf_counter()
            self.metrics.accepted.inc()
            self._ledger["submitted"] += 1
            self._queues[priority].append(sr)
            self._drained.clear()
            self._book_depth_locked()
            self._cond.notify_all()
        return sr

    def cancel(self, sr):
        return self._request_cancel(sr)

    def _request_cancel(self, sr):
        with self._cond:
            if sr.state not in ("queued", "running"):
                return False
            sr._cancel_requested = True
            self._cond.notify_all()
        return True

    # -- operational controls -----------------------------------------
    def pause(self):
        """Stop feeding the engine (in-flight work keeps stepping);
        queued work accumulates — deterministic backpressure for tests
        and for load-shedding drills."""
        with self._cond:
            self._paused = True

    def resume(self):
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def drain(self, timeout=None):
        """Block until no queued and no in-flight work remains."""
        return self._drained.wait(timeout=timeout)

    def shutdown(self, drain=True, timeout=None):
        """Stop admissions; with drain=True let in-flight and queued
        requests finish, else cancel everything. Joins the pump thread;
        returns True when it exited within `timeout`."""
        with self._cond:
            self._closed = True
            self._paused = False
            if not drain:
                for q in self._queues.values():
                    for sr in q:
                        sr._cancel_requested = True
                for sr in self._inflight.values():
                    sr._cancel_requested = True
            self._cond.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
        if self._pulse is not None:
            self._pulse.stop()
        return not self._thread.is_alive()

    def stats(self):
        with self._cond:
            st = {
                "queued": self._queued_locked(),
                "active": sum(1 for r in self._engine._slots
                              if r is not None),
                "engine_waiting": len(self._engine._waiting),
                "inflight": len(self._inflight),
                "closed": self._closed,
                "paused": self._paused,
                "device_steps": self._engine.device_steps,
                "preemptions": self._engine.preemptions,
                # monotonic ledger — consumers diff it across probes
                "requests": dict(self._ledger),
                # crash-recovery surface: restart cadence + breaker
                "recovery": {
                    "restarts": getattr(self._engine, "restarts", 0),
                    "quarantined": self._quarantined,
                    "breaker_open": self._broken,
                    "recent_restarts": len(self._restart_t),
                    "restart_window_s": self.restart_window_s,
                },
            }
            pc = getattr(self._engine, "prefix_cache", None)
            if pc is not None:
                st["prefix_cache"] = pc.stats()
            tier = getattr(self._engine, "host_tier", None)
            if tier is not None:
                st["kv_tier"] = tier.stats()
            return st

    def readiness(self):
        """(ready, reason): False while draining (shutdown began) or
        paused — the /readyz signal. Liveness (/healthz) stays
        independent: a draining replica is alive but must be out of
        any load balancer's rotation before it stops."""
        with self._cond:
            if self._closed:
                return False, "draining"
            if self._broken:
                return False, "crash_loop"
            if self._paused:
                return False, "paused"
            return True, "ok"

    def reset_breaker(self):
        """Close the crash-loop breaker and forget the restart window
        — the 'operator fixed the fault' half of a recovery drill
        (Replica.revive calls this after removing its kill rule)."""
        with self._cond:
            self._broken = False
            self._restart_t.clear()
            self._cond.notify_all()

    def render_prometheus(self):
        """Prometheus exposition of this scheduler's registry (the
        server calls this on whatever it mounts — a Router aggregates
        replica registries behind the same method)."""
        t0 = time.perf_counter()
        self._scan_anomalies()
        if self._pulse is not None:
            # ride the scrape cadence: sample only if an interval has
            # passed (the plane's own thread fills scrape-free gaps)
            self._pulse.maybe_sample(scanned=True)
        text = self.registry.render_prometheus()
        self.metrics.observe_scrape_self(time.perf_counter() - t0)
        return text

    def metrics_snapshot(self):
        t0 = time.perf_counter()
        self._scan_anomalies()
        if self._pulse is not None:
            self._pulse.maybe_sample(scanned=True)
        snap = self.registry.snapshot()
        self.metrics.observe_scrape_self(time.perf_counter() - t0)
        return snap

    # -- pulse plane (observability/pulse.py) -------------------------
    def pulse(self, window=None, signals=None):
        """The /debug/pulse payload: windowed ring time-series derived
        from this registry (the Router aggregates per-replica payloads
        behind the same duck-typed method). `{"enabled": False}` when
        PT_SERVE_PULSE=0."""
        if self._pulse is None:
            return {"enabled": False}
        self._pulse.maybe_sample()
        return self._pulse.payload(window=window, signals=signals)

    def _pulse_snapshot(self):
        """Registry snapshot plus the device-telemetry MFU gauges
        (pt_mfu lives outside the serving registry) — the sampler's
        input. Host-side dict reads only."""
        snap = self.registry.snapshot()
        costs = _devtel.COSTS
        if costs.steps_measured:
            # absent, never 0, until a step on the card was costed
            snap["pt_mfu"] = {"type": "gauge",
                              "value": float(costs.last_mfu)}
            snap["pt_mfu_peak"] = {"type": "gauge",
                                   "value": float(costs.peak_mfu)}
        return snap

    def _pulse_info(self):
        """Trigger-time context a capture bundle embeds: breaker
        state, restart count, and the trace ids in flight (queued +
        running + the most recent terminals — the triggering request
        is one of these whichever side of finalize the trigger lands
        on)."""
        with self._cond:
            trace_ids = [sr.trace_id for sr in self._inflight.values()]
            trace_ids += [sr.trace_id for q in self._queues.values()
                          for sr in q]
            trace_ids += [e.get("trace_id")
                          for e in list(self._recent)[-8:]]
            return {
                "breaker_open": self._broken,
                "restarts": getattr(self._engine, "restarts", 0),
                "queued": self._queued_locked(),
                "inflight": len(self._inflight),
                "trace_ids": [t for t in dict.fromkeys(trace_ids)
                              if t is not None],
            }

    def _scan_anomalies(self):
        """Drain the sentinel's step samples and publish any stalls —
        runs on whatever thread scrapes /metrics, NEVER the pump."""
        for a in self._sentinel.scan():
            self.metrics.on_step_anomaly()
            _flight.record("anomaly.step_stall", **a)
            self._log.event("anomaly.step_stall", level="warning", **a)

    # -- pump (single thread; sole owner of the engine) ----------------
    def _queued_locked(self):
        return sum(len(q) for q in self._queues.values())

    def _book_depth_locked(self):
        """Total + per-priority queue-depth gauges in one pass."""
        self.metrics.set_queue_depth(self._queued_locked())
        self.metrics.set_queue_depths(
            {p: len(self._queues[p]) for p in PRIORITIES})

    def _pop_next_locked(self):
        for p in PRIORITIES:
            if self._queues[p]:
                return self._queues[p].popleft()
        return None

    def _expire_and_cancel_locked(self):
        now = time.monotonic()
        for p in PRIORITIES:
            q = self._queues[p]
            keep = deque()
            for sr in q:
                if sr._cancel_requested:
                    self.metrics.on_cancel("queued")
                    _flight.record("sched.cancel", rid=str(sr.rid),
                                   trace_id=sr.trace_id, where="queued")
                    self._finalize(sr, "cancelled")
                elif sr.deadline is not None and now > sr.deadline:
                    self.metrics.on_expire()
                    _flight.record("sched.expire", rid=str(sr.rid),
                                   trace_id=sr.trace_id, where="queued",
                                   queued_s=now - sr.t_submit)
                    self._finalize(sr, "expired")
                else:
                    keep.append(sr)
            self._queues[p] = keep
        for sr in list(self._inflight.values()):
            expired = sr.deadline is not None and now > sr.deadline
            if expired and not sr._expired:
                sr._expired = True
                self.metrics.on_expire()
                _flight.record("sched.expire", rid=str(sr.rid),
                               trace_id=sr.trace_id, where="running",
                               tokens=len(sr.req.output))
            if (expired or sr._cancel_requested) and \
                    not sr._cancel_applied:
                # a step in flight: releasing the slot now would race
                # its device results — the pump drains the pipeline
                # first (next iteration re-enters with _pending None)
                if self._pending is not None:
                    continue
                sr._cancel_applied = True
                # pump thread owns the engine: safe to mutate its queue
                self._engine.cancel(sr.req)

    def _feed_locked(self):
        if self._paused:
            return
        if self._unproven:
            # probation: a requeued victim is in the engine and has not
            # survived a step yet — feed nothing until it proves (or
            # crashes alone, which is the attribution we want)
            return
        eng = self._engine
        room = sum(1 for r in eng._slots if r is None) \
            - len(eng._waiting)
        while room > 0:
            sr = self._pop_next_locked()
            if sr is None:
                break
            eng.submit(sr.req)
            sr.state = "running"
            if not sr._started:
                # started counts DISTINCT requests that left the queue:
                # a warm-restart requeue re-feeds, it does not re-start
                sr._started = True
                self._ledger["started"] += 1
                self.metrics.on_start()
            sr.t_admitted = time.monotonic()
            if sr.timeline is not None:
                sr.timeline.mark("admit", t=sr.t_admitted)
            _flight.record("sched.admit", rid=str(sr.rid),
                           trace_id=sr.trace_id, priority=sr.priority,
                           queued_s=sr.t_admitted - sr.t_submit,
                           requeues=sr._requeues or None)
            self._inflight[id(sr.req)] = sr
            room -= 1
            if self._suspects:
                # while any requeued victim awaits its proof, admission
                # is one-at-a-time: proven requests keep running, the
                # next candidate joins only after this one survives a
                # step — so a poison request eventually crashes alone
                self._unproven.add(sr)
                break

    def _publish(self):
        """Push newly emitted tokens to each in-flight handle and
        finalize whatever the engine finished. Pump-thread only."""
        with self._cond:
            for sr in list(self._inflight.values()):
                n = len(sr.req.output)
                if n > sr._emitted:
                    if sr.t_first_token is None:
                        sr.t_first_token = time.monotonic()
                        # guard: a migrated request's first token was
                        # marked on the prefill replica and rode the
                        # handoff payload in
                        if sr.timeline is not None and \
                                not sr.timeline.has("first_token"):
                            sr.timeline.mark("first_token",
                                             t=sr.t_first_token)
                    sr.chunks.put(list(sr.req.output[sr._emitted:n]))
                    sr._emitted = n
            if self._unproven:
                # probation proof: output advanced past the requeue
                # snapshot means the victim survived a step — its crash
                # streak resets and the next suspect may be fed
                for sr in list(self._unproven):
                    if len(sr.req.output) > sr._proof_mark:
                        self._unproven.discard(sr)
                        self._suspects.discard(sr)
                        sr._crash_streak = 0
            fin = self._engine.finished
            while self._fin_seen < len(fin):
                req = fin[self._fin_seen]
                self._fin_seen += 1
                sr = self._inflight.pop(id(req), None)
                if sr is None:
                    continue        # submitted around the scheduler
                if getattr(sr, "_expired", False):
                    self._finalize(sr, "expired")
                elif req.cancelled:
                    self._finalize(sr, "cancelled")
                elif getattr(req, "_handoff_done", None) is not None:
                    # prefill complete, KV exported: hand the payload
                    # to whoever holds the handle (the router's
                    # migration path re-submits it on a decode replica)
                    sr.handoff = req._handoff_done
                    self._finalize(sr, "handoff")
                else:
                    self._finalize(sr, "done")
            self._book_depth_locked()
            if not self._queued_locked() and not self._inflight:
                self._drained.set()
                self._cond.notify_all()

    def _finalize(self, sr, state):
        sr.state = state
        sr.t_done = time.monotonic()
        if sr.timeline is not None:
            sr.timeline.mark("end", t=sr.t_done)
        self._suspects.discard(sr)
        self._unproven.discard(sr)
        self._ledger[{"done": "completed", "failed": "failed",
                      "cancelled": "cancelled", "expired": "expired",
                      "handoff": "handoff"}[state]] += 1
        if state == "failed":
            self.metrics.on_fail()
        if state == "expired":
            sr.error = DeadlineExceededError(
                f"request {sr.rid}: deadline exceeded after "
                f"{sr.t_done - sr.t_submit:.3f}s "
                f"({len(sr.req.output)} tokens emitted)")
        n = len(sr.req.output)
        if n > sr._emitted and state != "failed":
            # a FAILED request publishes no further bytes: its partial
            # output is untrusted, and "failed ⇒ the consumer saw only
            # what it already saw" is what makes never-streamed
            # failures safely replayable (router failover)
            sr.chunks.put(list(sr.req.output[sr._emitted:n]))
            sr._emitted = n
        sr.chunks.put(None)
        self._account_slo(sr, state)
        self._emit_request_spans(sr, state)
        self._recent.append(self._timeline_entry(sr, state))
        sr._done.set()

    def _account_slo(self, sr, state):
        """Book the finished request against the SLO/goodput plane:
        phase histograms, the goodput/total token counters, and the
        attained/violated verdict (violations attributed to the
        dominant phase of the missed budget). Only state "done" counts
        — a "handoff" terminal is mid-life (the decode replica books
        it), and failures/cancels deliver nothing."""
        tl = sr.timeline
        if tl is None or state != "done":
            return
        phases = tl.phases()
        self.metrics.observe_phases(phases)
        tokens = len(sr.req.output)
        self.metrics.on_request_tokens(tokens)
        if sr.slo is None:
            # no objective: delivered tokens are goodput by definition
            self.metrics.on_goodput(tokens)
            return
        attained, phase = judge_slo(sr.slo, tl.ttft(),
                                    tl.tpot(tokens), phases)
        sr.slo_attained = attained
        sr.violated_phase = phase
        if attained:
            self.metrics.on_slo_attained(sr.slo)
            self.metrics.on_goodput(tokens)
        else:
            self.metrics.on_slo_violated(phase)

    def _timeline_entry(self, sr, state):
        """JSON-shaped record for the /debug/requests ring."""
        entry = {"rid": str(sr.rid), "trace_id": sr.trace_id,
                 "state": state, "priority": sr.priority,
                 "slo": sr.slo, "tokens": len(sr.req.output),
                 "requeues": sr._requeues}
        tl = sr.timeline
        if tl is not None:
            entry.update(
                e2e_s=tl.elapsed(), ttft_s=tl.ttft(),
                phases=tl.phases(), steps=dict(tl.steps),
                marks=[[m, t] for m, t in tl.marks],
                slo_attained=sr.slo_attained,
                violated_phase=sr.violated_phase)
        return entry

    def recent_requests(self, n=50):
        """Most recent terminal requests (newest last), each with its
        stitched timeline — the /debug/requests payload."""
        with self._cond:
            items = list(self._recent)
        return items[-int(n):] if n else items

    def _emit_request_spans(self, sr, state):
        """Reconstruct the request's phase timeline — queued → prefill
        (admission to first token) → decode — as spans sharing its
        trace id, so a chrome export shows the whole life of the
        request on one row. Assembled here, at the terminal state,
        because the phase boundaries were stamped on three different
        threads; monotonic deltas are re-anchored to wall clock."""
        now_w, now_m = time.time(), time.monotonic()

        def wall(tm):
            return now_w - (now_m - tm)
        t_end = sr.t_done if sr.t_done is not None else now_m
        attrs = {"rid": str(sr.rid), "state": state,
                 "priority": sr.priority,
                 "tokens": len(sr.req.output)}
        tl = sr.timeline
        if tl is not None and tl.marks:
            # the stitched ledger is authoritative: one child span per
            # phase segment, exceptional transitions included, all
            # sharing the request's trace id
            for ph, a, b in tl.segments():
                _tc.record_span_event(
                    f"request.{ph}", b - a, trace_id=sr.trace_id,
                    t_end=wall(b), args=attrs)
            _flight.record(
                "request.done", rid=str(sr.rid), trace_id=sr.trace_id,
                state=state, tokens=len(sr.req.output),
                slo=sr.slo, slo_attained=sr.slo_attained,
                violated_phase=sr.violated_phase,
                requeues=sr._requeues or None,
                phases={k: round(v, 6)
                        for k, v in tl.phases().items()},
                ttft_s=tl.ttft(), e2e_s=tl.elapsed())
            return
        q_end = sr.t_admitted if sr.t_admitted is not None else t_end
        _tc.record_span_event(
            "request.queued", q_end - sr.t_submit,
            trace_id=sr.trace_id, t_end=wall(q_end), args=attrs)
        if sr.t_admitted is not None:
            p_end = sr.t_first_token \
                if sr.t_first_token is not None else t_end
            _tc.record_span_event(
                "request.prefill", p_end - sr.t_admitted,
                trace_id=sr.trace_id, t_end=wall(p_end), args=attrs)
        if sr.t_first_token is not None:
            _tc.record_span_event(
                "request.decode", t_end - sr.t_first_token,
                trace_id=sr.trace_id, t_end=wall(t_end), args=attrs)
        _flight.record(
            "request.done", rid=str(sr.rid), trace_id=sr.trace_id,
            state=state, tokens=len(sr.req.output),
            queued_s=q_end - sr.t_submit,
            ttft_s=None if sr.t_first_token is None
            else sr.t_first_token - sr.t_submit,
            e2e_s=t_end - sr.t_submit)

    def _engine_has_work(self):
        return (any(r is not None for r in self._engine._slots)
                or bool(self._engine._waiting))

    def _drain_needed(self):
        """True when the pipelined pump must catch the host up before
        acting: shutdown began, or a cancel/TTL deadline wants to touch
        a slot whose latest step is still in flight."""
        with self._cond:
            if self._closed:
                return True
            now = time.monotonic()
            for sr in self._inflight.values():
                if sr._cancel_requested or (
                        sr.deadline is not None and now > sr.deadline):
                    return True
            return any(sr._cancel_requested
                       for q in self._queues.values() for sr in q)

    def _finish_pending(self, inflight=None):
        """Consume the in-flight ticket (the sanctioned async read
        lives in engine.step_finish); returns #active it applied."""
        ticket, self._pending = self._pending, None
        if ticket is None:
            return 0
        return self._engine.step_finish(ticket, inflight=inflight)

    def _step_pipelined(self):
        """One pipelined pump turn: launch step N+1 FIRST (its input
        tokens come from step N's device record via the carry mask),
        then consume step N — the host bookkeeping overlaps the device
        executing N+1. Page-growth preemption raises PipelineStall
        inside the launch (the victim's pending token is still on
        device): drain, then relaunch against host-current state.
        Tickets are opaque here: a ragged engine hands back
        RaggedTickets (every wave is ONE `unified_step` dispatch,
        prefill and decode mixed), a bucketed one StepTickets — the
        pump logic is identical for both."""
        from ..models.llama_serving import PipelineStall
        eng = self._engine
        try:
            ticket = eng.step_launch(carry=self._pending)
        except PipelineStall:
            self._finish_pending()
            ticket = eng.step_launch()
        n_active = self._finish_pending(inflight=ticket)
        self._pending = ticket
        if ticket is not None:
            n_active = max(n_active, len(ticket.slots))
        return n_active

    def _pump(self):
        while True:
            if self._pending is not None and self._drain_needed():
                # slow path (cancel/TTL/shutdown): catch the host up so
                # releases/cancels operate on consumed state only —
                # the one-step-deep pipeline drains, never leaks
                try:
                    self._finish_pending()
                except Exception as e:  # noqa: BLE001 — fail requests
                    self._recover(e)
                self._publish()
            with self._cond:
                self._expire_and_cancel_locked()
                self._feed_locked()
                if not self._engine_has_work() and self._pending is None:
                    if self._closed and not self._queued_locked():
                        break
                    # park until a submission/cancel/shutdown pokes us
                    # (or queued work is unfeedable: paused / no slot);
                    # the timeout bounds queued-deadline expiry latency
                    self._cond.wait(timeout=self._idle_poll_s)
                    continue
            t0 = time.perf_counter()
            try:
                if self._pipeline:
                    n_active = self._step_pipelined()
                else:
                    n_active = self._engine.step()
            except Exception as e:  # noqa: BLE001 — fail requests
                self._pending = None
                self._recover(e)
                continue
            dt = time.perf_counter() - t0
            self.metrics.observe_step(dt)
            # slot-mix sample: host-side slot walk, no device traffic —
            # feeds the pt_serving_slots{kind=} gauges (pulse plane)
            # and tags the sentinel sample with the step's phase mix
            npf = nact = 0
            for r in self._engine._slots:
                if r is not None:
                    nact += 1
                    if self._engine._prefilling(r):
                        npf += 1
            self.metrics.set_slot_mix(npf, nact - npf)
            if self._timeline_on:
                # anomaly sentinel sample: one deque append — no math,
                # no locks, no device traffic on the pump (analysis
                # runs on scrape)
                self._sentinel.note(dt, npf, nact - npf)
            # MFU: the tracked prefill/decode/verify calls this step
            # issued a known number of XLA-counted FLOPs; dividing by
            # the (synced) step wall time sets the pt_mfu gauge. Pure
            # host arithmetic — no device traffic.
            _devtel.note_step(dt)
            # rate-limited structured step record (always lands in the
            # flight recorder; hits the log stream when one is wired)
            self._log.event(
                "serving.step", step_s=dt, active=n_active,
                queue_depth=self.metrics.queue_depth.value,
                device_steps=self._engine.device_steps,
                host_gap_s=getattr(self._engine, "last_host_gap_s", 0.0),
                pipeline_depth=getattr(self._engine, "pipeline_depth", 0))
            self._publish()
        if self._pending is not None:
            try:
                self._finish_pending()
            except Exception as e:  # noqa: BLE001
                self._recover(e)
        self._publish()

    def _recover(self, exc):
        """An engine step blew up: warm-restart instead of failing
        everyone (docs/reliability.md has the state machine).

        Device state is released exactly as a failure must (the
        engine's `crash_reset`: index-suspended slot release, stash
        drop for engine-queued victims). Then each in-flight request is
        classified, in order:

          cancelled/expired  -> its normal terminal state;
          quarantined        -> admitted across `poison_after`
                                consecutive crashed steps: the
                                attributed poison fails ALONE with a
                                client-visible PoisonedRequestError
                                and is never requeued again;
          requeued           -> never streamed a byte: back to the
                                FRONT of its priority queue with the
                                same rid/trace id/deadline; generated-
                                so-far tokens replay through the
                                preemption-resume / prefix-cache
                                suffix-prefill path, token-identically;
          failed             -> mid-stream (the consumer has bytes), or
                                the breaker/shutdown forbids requeue.

        `max_restarts` restarts inside `restart_window_s` trip the
        crash-loop breaker BEFORE classification: everything fails
        fast (nothing streamed -> router failover stays token-
        identical), readiness flips false, and admission refuses until
        reset_breaker()."""
        t0 = time.perf_counter()
        self._log.event("engine.error", level="error", error=repr(exc))
        with self._cond:
            eng = self._engine
            # who was the engine actually working on? slot holders plus
            # requests popped from its queue mid-admission (limbo) form
            # the "admitted set" the poison streak attributes to;
            # engine-queued requests were untouched by the crash
            active_ids = {id(r) for r in eng._slots if r is not None}
            waiting_ids = {id(r) for r in eng._waiting}
            eng.crash_reset()
            now = time.monotonic()
            self._restart_t.append(now)
            while self._restart_t and \
                    now - self._restart_t[0] > self.restart_window_s:
                self._restart_t.popleft()
            if not self._broken and \
                    len(self._restart_t) >= self.max_restarts:
                self._broken = True
                _flight.record("engine.breaker",
                               restarts=len(self._restart_t),
                               window_s=self.restart_window_s,
                               error=repr(exc))
                self._log.event("engine.breaker", level="error",
                                restarts=len(self._restart_t),
                                window_s=self.restart_window_s)
            requeue_ok = not self._closed and not self._broken
            requeued, failed, quarantined = [], [], []
            for sr in list(self._inflight.values()):
                req = sr.req
                # an admission candidate may still hold acquired prefix
                # refs (crash mid-_admit): drop them or the pool leaks
                eng._cache_unacquire(req)
                if id(req) not in waiting_ids or id(req) in active_ids:
                    sr._crash_streak += 1
                if sr._cancel_requested:
                    self.metrics.on_cancel("running")
                    _flight.record("sched.cancel", rid=str(sr.rid),
                                   trace_id=sr.trace_id, where="crash")
                    self._finalize(sr, "cancelled")
                elif sr._expired:
                    self._finalize(sr, "expired")
                elif sr._crash_streak >= self.poison_after:
                    sr.error = PoisonedRequestError(
                        f"request {sr.rid}: poisoned — in the admitted "
                        f"set for {sr._crash_streak} consecutive failed "
                        f"steps; quarantined (last error: {exc!r})")
                    self._quarantined += 1
                    self.metrics.on_poison()
                    _flight.record("poison.quarantine", rid=str(sr.rid),
                                   trace_id=sr.trace_id,
                                   streak=sr._crash_streak,
                                   error=repr(exc))
                    quarantined.append(sr)
                    self._finalize(sr, "failed")
                elif requeue_ok and not sr._streamed:
                    requeued.append(sr)
                else:
                    sr.error = SchedulerError(
                        f"engine step failed: {exc!r}")
                    failed.append(sr)
                    self._finalize(sr, "failed")
            self._inflight.clear()
            self._unproven.clear()
            # requeue to the FRONT of each priority queue, preserving
            # the original admission order; resume state rides the
            # Request itself (the recompute-preemption machinery):
            # prompt + generated-so-far re-prefill, pending next_token
            # survives, nothing is re-sampled
            for sr in reversed(requeued):
                req = sr.req
                req.slot = None
                req._offload = None
                req._resume = bool(req.output)
                sr.state = "queued"
                sr._cancel_applied = False
                sr._requeues += 1
                if sr.timeline is not None:
                    sr.timeline.mark("requeued")
                sr._proof_mark = len(req.output)
                self._suspects.add(sr)
                self._queues[sr.priority].appendleft(sr)
            self._ledger["requeued"] += len(requeued)
            if requeued:
                self.metrics.on_requeue(len(requeued))
            dt = time.perf_counter() - t0
            self.metrics.on_restart(dt)
            _flight.record(
                "engine.restart", error=repr(exc), duration_s=dt,
                requeued=len(requeued), failed=len(failed),
                quarantined=len(quarantined), broken=self._broken,
                restarts=eng.restarts,
                trace_ids=[sr.trace_id for sr in
                           requeued + quarantined + failed])
            self._book_depth_locked()
            self._cond.notify_all()
