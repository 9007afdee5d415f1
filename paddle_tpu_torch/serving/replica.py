"""One serving replica: an engine + scheduler pair behind a
transport-agnostic surface the router dispatches to.

A `Replica` owns one `ServingEngine` (its KV pool, prefix cache, pump
state) wrapped in one `RequestScheduler` (its bounded queue and pump
thread) plus a PRIVATE `MetricsRegistry` — nothing is shared between
replicas, so N replicas are N independent failure domains in one
process. The surface the router uses is deliberately small and
carries no in-process types in its *semantics* (submit parameters and
stats are plain data; only the returned request handle is local), so
a future multi-host replica can implement the same methods over the
existing rpc/collective layer without touching the router:

  * `submit(prompt_ids, **params)` — admit-or-refuse now
    (`BackpressureError` / `SchedulerClosedError` pass through);
  * `stats()` / `load()` — queue depth, occupancy, and the
    scheduler's monotonic request ledger (started/completed/failed),
    which is what health tracking diffs;
  * `ready()` — readiness (False while paused or draining), the
    /readyz signal an external LB would consume;
  * `pause()/resume()/shutdown(drain=)` — rolling-restart hooks;
  * `kill()` — fault injection for failover drills and tests.

The engine arrives as a constructor argument: this module imports no
model code (the serving package stays cycle-free and cheap).

Counterpart of `paddle_tpu/serving/replica.py`, carried over as a copy
(the port's host side is the reference's, held to it by the
`tests/test_torch_*.py` parity tests).
"""
from __future__ import annotations

from .faults import FaultPlan
from .metrics import MetricsRegistry
from .scheduler import RequestScheduler

__all__ = ["Replica", "ReplicaKilledError", "build_replicas"]


class ReplicaKilledError(RuntimeError):
    """Injected engine failure (Replica.kill): every subsequent step
    raises, so the scheduler's crash recovery runs — requeues, then
    quarantine/breaker — and the router's failover path takes over."""


class Replica:
    """In-process replica: one engine + scheduler + metrics registry.

    `replica_id` is the stable identity used for consistent-hash ring
    placement, the `replica=` label on aggregated /metrics, and
    flight-recorder events. Extra keyword arguments (`poison_after`,
    `max_restarts`, `restart_window_s`, ...) pass through to the
    scheduler — per-replica recovery thresholds for chaos drills.

    `role` specializes the replica for disaggregated serving
    (docs/serving.md § Disaggregated prefill/decode): "prefill"
    replicas take new requests and hand their KV off once the prompt
    is prefilled; "decode" replicas only continue imported requests;
    "both" — the default — serves end-to-end exactly as before (no
    handoff machinery runs, zero cost). The role is advisory identity
    the ROUTER enforces at dispatch; the engine itself stays
    role-agnostic.
    """

    ROLES = ("prefill", "decode", "both")

    # fleet-mode host tag (serving/fleet.py sets it on the worker):
    # None on a plain in-process replica, so single-host metrics and
    # /debug payloads stay byte-identical
    host = None

    def __init__(self, replica_id, engine, *, max_queue=64,
                 metrics=None, idle_poll_s=0.02, pipeline=None,
                 role="both", **sched_kw):
        self.replica_id = str(replica_id)
        if role not in self.ROLES:
            raise ValueError(
                f"role={role!r}: want one of {self.ROLES}")
        self.role = role
        self.engine = engine
        registry = metrics if metrics is not None else MetricsRegistry()
        self.scheduler = RequestScheduler(engine, max_queue=max_queue,
                                          metrics=registry,
                                          idle_poll_s=idle_poll_s,
                                          pipeline=pipeline, **sched_kw)

    # -- identity / introspection -------------------------------------
    @property
    def registry(self):
        return self.scheduler.registry

    @property
    def page_size(self):
        """KV page size — the router's affinity keys hash block-aligned
        prompt prefixes at this granularity (same chained block-hash
        scheme the replica's own prefix cache indexes by)."""
        return int(self.engine.page_size)

    @property
    def max_queue(self):
        return self.scheduler.max_queue

    def stats(self):
        st = self.scheduler.stats()
        st["replica_id"] = self.replica_id
        st["role"] = self.role
        st["ready"] = self.ready()
        if self.host is not None:
            st["host"] = self.host
        return st

    def prefill_eligible(self):
        """May take NEW requests (fresh prompts to prefill)."""
        return self.role in ("prefill", "both")

    def decode_eligible(self):
        """May continue an imported (or locally prefilled) decode."""
        return self.role in ("decode", "both")

    def load(self):
        """Queued + in-flight requests — the least-loaded spill order
        sorts on this. One lock acquisition, cheap enough per
        dispatch."""
        st = self.scheduler.stats()
        return st["queued"] + st["inflight"] + st["active"]

    def recent_requests(self, n=50):
        """Recent terminal requests with their stitched timelines —
        plain JSON-shaped data, so a multi-host replica can ship it
        over the rpc layer unchanged (/debug/requests aggregation)."""
        return self.scheduler.recent_requests(n)

    def ready(self):
        return self.scheduler.readiness()[0]

    # -- dispatch ------------------------------------------------------
    def submit(self, prompt_ids, **params):
        """Admit-or-refuse now; returns the scheduler's request
        handle. BackpressureError (queue full) and SchedulerClosedError
        (draining) propagate — the router turns those into spill /
        re-dispatch decisions."""
        return self.scheduler.submit(prompt_ids, **params)

    # -- operational controls -----------------------------------------
    def pause(self):
        self.scheduler.pause()

    def resume(self):
        self.scheduler.resume()

    def drain(self, timeout=None):
        return self.scheduler.drain(timeout=timeout)

    def shutdown(self, drain=True, timeout=None):
        return self.scheduler.shutdown(drain=drain, timeout=timeout)

    def kill(self, exc=None):
        """Fault injection: one FaultPlan rule among many — an
        infinite `step_launch:raise` armed on the engine's plan, so
        every device step (sync, pipelined, and spec dispatch all fire
        the same point) raises and the scheduler's crash recovery
        runs: requeues burn through the poison/breaker thresholds and
        the router fails the requests over to a healthy replica. A
        real crash (OOM, device loss) takes the identical code path
        because the pump converts ANY step exception into a warm
        restart."""
        err = exc if exc is not None else ReplicaKilledError(
            f"replica {self.replica_id}: killed (fault injection)")
        plan = self.engine.faults
        if plan is None:
            plan = self.engine.faults = FaultPlan()
        plan.add("step_launch", "raise", count=None, exc=err,
                 label=f"kill:{self.replica_id}")

    def revive(self):
        """Undo `kill()`: remove the kill rule and close the crash-
        loop breaker — the 'replica restarted' half of a failover
        drill (the scheduler's recovery already left the engine's
        slots and pages clean)."""
        plan = self.engine.faults
        if plan is not None:
            plan.remove(f"kill:{self.replica_id}")
        # tests may also have installed direct step overrides
        self.engine.__dict__.pop("step", None)
        self.engine.__dict__.pop("step_launch", None)
        self.scheduler.reset_breaker()

    def __repr__(self):
        return f"Replica({self.replica_id!r})"


def build_replicas(engine_factory, n, *, max_queue=64, prefix="r",
                   idle_poll_s=0.02, pipeline=None, roles=None,
                   **sched_kw):
    """N independent replicas from an engine factory. The factory is
    called once per replica — each gets its own params reference but
    its own KV pool, prefix cache, scheduler, and metrics registry
    (`engine_factory(i) -> ServingEngine`). `roles` is an optional
    per-replica role list (short lists pad with "both") for a
    disaggregated prefill/decode topology."""
    roles = list(roles or [])
    roles += ["both"] * (int(n) - len(roles))
    return [Replica(f"{prefix}{i}", engine_factory(i),
                    max_queue=max_queue, idle_poll_s=idle_poll_s,
                    pipeline=pipeline, role=roles[i], **sched_kw)
            for i in range(int(n))]
