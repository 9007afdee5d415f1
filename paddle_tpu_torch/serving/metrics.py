"""Serving metrics: a counters/gauges/histograms registry with
Prometheus text exposition and a JSON snapshot API.

The registry is the single source for every number the serving runtime
publishes — TTFT, per-token latency, queue depth, batch occupancy,
preemption and page-allocation stats (reference: the predictor's
serving telemetry; vLLM exposes the same catalog over /metrics).
`EngineMetrics` is the engine-facing half: `ServingEngine.metrics`
duck-types against it, so `models/llama_serving.py` never imports this
module (no cycle — the engine works bare, the runtime instruments it;
the engine's only serving-package import is the host-side
`serving.kvcache` bookkeeping, which imports no model code back).

Counterpart of `paddle_tpu/serving/metrics.py`, carried over as a copy
(the port's host side is the reference's, held to it by the
`tests/test_torch_*.py` parity tests).
"""
from __future__ import annotations

import bisect
import os
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "EngineMetrics", "DEFAULT_BUCKETS", "GAP_BUCKETS"]

# latency buckets in seconds: sub-ms CPU decode steps up to multi-second
# queued TTFTs all land in a populated bucket
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# host-gap buckets: the time between device-step launches is tens of
# microseconds under the pipelined pump and a full device step plus
# bookkeeping under the synchronous one — finer left edge than the
# latency buckets so the reduction is visible in the histogram
GAP_BUCKETS = (2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
               0.01, 0.025, 0.05, 0.1, 0.25, 1.0)


def _escape_label_value(v):
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped or the exposition line is
    invalid (and everything after it unparseable)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _label_suffix(labels):
    """`{k="v",...}` suffix in sorted-key order ('' when unlabeled).
    Keys sort so the same label set always renders one series name;
    values are escaped per the Prometheus text-format spec."""
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label_value(labels[k])}"'
                          for k in sorted(labels)) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name, help="", lock=None, labels=None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else {}
        self._suffix = _label_suffix(self.labels)
        self._lock = lock or threading.Lock()


class Counter(_Metric):
    """Monotonic count (Prometheus counter)."""
    kind = "counter"

    def __init__(self, name, help="", lock=None, labels=None):
        super().__init__(name, help, lock, labels)
        self._v = 0.0

    def inc(self, n=1.0):
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) < 0")
        with self._lock:
            self._v += n

    @property
    def value(self):
        with self._lock:
            return self._v

    def _render(self, out):
        out.append(f"{self.name}_total{self._suffix} {_fmt(self._v)}")

    def _snap(self):
        return {"type": "counter", "value": self._v}


class Gauge(_Metric):
    """Point-in-time value (Prometheus gauge)."""
    kind = "gauge"

    def __init__(self, name, help="", lock=None, labels=None):
        super().__init__(name, help, lock, labels)
        self._v = 0.0

    def set(self, v):
        with self._lock:
            self._v = float(v)

    def set_to_max(self, v):
        """Peak tracking: keep the high-water mark."""
        with self._lock:
            if v > self._v:
                self._v = float(v)

    def inc(self, n=1.0):
        with self._lock:
            self._v += n

    def dec(self, n=1.0):
        self.inc(-n)

    @property
    def value(self):
        with self._lock:
            return self._v

    def _render(self, out):
        out.append(f"{self.name}{self._suffix} {_fmt(self._v)}")

    def _snap(self):
        return {"type": "gauge", "value": self._v}


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus exposition shape);
    percentiles for the JSON snapshot are interpolated inside the
    landing bucket, which is exact enough for dashboards and tests."""
    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS, lock=None,
                 labels=None):
        super().__init__(name, help, lock, labels)
        self._bounds = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self._bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._counts[bisect.bisect_left(self._bounds, v)] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def percentile(self, q):
        """Interpolated q-th percentile (q in [0, 100]); 0.0 when empty.
        A percentile landing in the overflow (+Inf) bucket returns the
        largest finite bucket edge — a LOWER bound, never `inf` (the
        snapshot flags it; see `percentile_overflow`)."""
        return self.percentile_overflow(q)[0]

    def percentile_overflow(self, q):
        """(value, in_overflow): `in_overflow` is True when the
        percentile fell in the +Inf bucket, making `value` (the largest
        finite bucket edge) a lower bound on the true percentile."""
        with self._lock:
            if self._count == 0:
                return 0.0, False
            target = self._count * q / 100.0
            seen = 0
            lo = 0.0
            for i, n in enumerate(self._counts):
                if i == len(self._bounds):
                    # overflow bucket: its finite edge is the previous
                    # bucket's upper bound — return it, flagged
                    return (self._bounds[-1] if self._bounds else lo), \
                        True
                hi = self._bounds[i]
                if seen + n >= target:
                    if n == 0:
                        return hi, False
                    return lo + (hi - lo) * (target - seen) / n, False
                seen += n
                lo = hi
            return lo, False

    def _render(self, out):
        cum = 0
        for i, b in enumerate(self._bounds):
            cum += self._counts[i]
            out.append(f'{self.name}_bucket{{le="{_fmt(b)}"}} {cum}')
        cum += self._counts[-1]
        out.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        out.append(f"{self.name}_sum {_fmt(self._sum)}")
        out.append(f"{self.name}_count {self._count}")

    def _snap(self):
        cum, buckets = 0, {}
        for i, b in enumerate(self._bounds):
            cum += self._counts[i]
            buckets[_fmt(b)] = cum
        buckets["+Inf"] = cum + self._counts[-1]
        snap = {"type": "histogram", "count": self._count,
                "sum": self._sum, "buckets": buckets}
        for label, q in (("p50", 50), ("p90", 90), ("p99", 99)):
            v, overflow = self.percentile_overflow(q)
            snap[label] = v
            if overflow:
                # the true percentile is past the largest finite edge;
                # the reported value is a lower bound
                snap[f"{label}_lower_bound"] = True
        return snap


def _fmt(v):
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


_IMPORT_WALL_TIME = time.time()


def _process_start_time():
    """Unix timestamp the process started at (the standard
    `process_start_time_seconds` convention): /proc starttime ticks
    since boot plus the boot time, falling back to this module's
    import wall time where /proc is unavailable."""
    try:
        with open("/proc/self/stat") as f:
            stat = f.read()
        # field 22 (starttime, clock ticks since boot) counted after
        # the parenthesized comm — comm may contain spaces, so split
        # after the LAST ')'
        ticks = float(stat.rpartition(")")[2].split()[19])
        hz = float(os.sysconf("SC_CLK_TCK"))
        with open("/proc/stat") as f:
            for line in f:
                if line.startswith("btime "):
                    return float(line.split()[1]) + ticks / hz
    except (OSError, ValueError, IndexError):
        pass
    return _IMPORT_WALL_TIME


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe get-or-create registry of named metrics.

    Counters and gauges optionally carry a small static label set
    (e.g. ``labels={"phase": "decode"}``); each distinct (name, label
    set) is its own series, keyed by the rendered ``name{k="v"}``
    string, and exposition emits one HELP/TYPE header per base name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get(self, cls, name, help, labels=None, **kw):
        key = name + _label_suffix(labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, lock=threading.Lock(),
                        labels=labels, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {key!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name, help="", labels=None):
        return self._get(Counter, name, help, labels=labels)

    def gauge(self, name, help="", labels=None):
        return self._get(Gauge, name, help, labels=labels)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS):
        # histograms stay unlabeled: bucket series already carry an
        # le= label and nothing in the stack needs labeled ones yet
        return self._get(Histogram, name, help, buckets=buckets)

    def render_prometheus(self):
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: (m.name, m._suffix))
        out = []
        prev = None
        for m in metrics:
            if m.name != prev:
                # one HELP/TYPE header per base name, shared by every
                # labeled series of that name
                if m.help:
                    out.append(f"# HELP {m.name} {m.help}")
                out.append(f"# TYPE {m.name} {m.kind}")
                prev = m.name
            with m._lock:
                m._render(out)
        return "\n".join(out) + "\n"

    def snapshot(self):
        """JSON-serializable dict of every metric's current state,
        keyed by name (plus the label suffix for labeled series)."""
        with self._lock:
            metrics = list(self._metrics.items())
        return {key: m._snap() for key, m in metrics}


class EngineMetrics:
    """The hook object `ServingEngine.metrics` duck-types against.

    The engine calls these from the thread driving `step()`; every
    method funnels into registry metrics, so a scrape from any other
    thread sees a consistent snapshot. `external_queue=True` (set by
    RequestScheduler) hands queue-depth ownership to the scheduler,
    whose queue sits in front of the engine's."""

    def __init__(self, registry=None, external_queue=False):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._external_queue = external_queue
        r = self.registry
        self.ttft = r.histogram(
            "pt_serving_ttft_seconds", "Submit-to-first-token latency.")
        self.tpot = r.histogram(
            "pt_serving_tpot_seconds", "Per-output-token latency.")
        self.e2e = r.histogram(
            "pt_serving_e2e_seconds", "Submit-to-completion latency.")
        self.step_seconds = r.histogram(
            "pt_serving_step_seconds",
            "Wall time of one engine step (prefill+decode/verify).")
        self.host_gap = r.histogram(
            "pt_step_host_gap_seconds",
            "Host wall time between consecutive device-step launches "
            "(decode/verify dispatch to the next dispatch) — the gap "
            "the device sits without a queued step program.",
            buckets=GAP_BUCKETS)
        self.pipeline_depth = r.gauge(
            "pt_pipeline_depth",
            "Device steps in flight beyond the one the host has "
            "consumed (1 = double-buffered pump, 0 = synchronous).")
        self.queue_depth = r.gauge(
            "pt_serving_queue_depth", "Requests waiting for a slot.")
        self.queue_depth_peak = r.gauge(
            "pt_serving_queue_depth_peak", "High-water queue depth.")
        self.batch_occupancy = r.gauge(
            "pt_serving_batch_occupancy",
            "Active slots / max_seqs at the last step.")
        self.active = r.gauge(
            "pt_serving_active_requests", "Requests holding a slot.")
        self.pages_free = r.gauge(
            "pt_serving_kv_pages_free", "KV pages in the free list.")
        self.pages_total = r.gauge(
            "pt_serving_kv_pages_total",
            "Allocatable KV pages (excludes the trash page).")
        self.prefill_tokens = r.gauge(
            "pt_serving_prefill_tokens", "Cumulative prefilled tokens.")
        # ragged vs bucketed dispatch accounting: how many
        # token rows were pure bucket padding vs real tokens served by
        # the unified ragged step — the padding waste the ragged entry
        # point exists to eliminate. Mirrored from engine ints via
        # on_step deltas (single-writer: the pump thread).
        self.pad_tokens = r.counter(
            "pt_pad_tokens",
            "Token rows dispatched as power-of-two bucket padding by "
            "the bucketed entry points (0 in ragged mode).")
        self.ragged_tokens = r.counter(
            "pt_ragged_tokens",
            "Real token rows served through the unified ragged step.")
        # lean epilogue accounting: unembed (lm_head) rows
        # actually computed vs rows the row-sparse epilogue skipped —
        # the (T, vocab) FLOPs/bytes that never ran. Same delta-mirror
        # pattern as the pad counters.
        self.logit_rows = r.counter(
            "pt_logit_rows",
            "lm_head logit rows computed by serving device programs.")
        self.logit_rows_skipped = r.counter(
            "pt_logit_rows_skipped",
            "Logit rows the lean row-sparse epilogue skipped (0 with "
            "PT_SERVE_LEAN=0).")
        self._tok_seen = {"pad_tokens": 0, "ragged_tokens": 0,
                          "logit_rows": 0, "logit_rows_skipped": 0}
        self.steps = r.counter(
            "pt_serving_device_steps", "Decode/verify device calls.")
        self.tokens = r.counter(
            "pt_serving_generated_tokens", "Output tokens emitted.")
        self.preemptions = r.counter(
            "pt_serving_preemptions", "Requests evicted mid-flight.")
        self.page_allocs = r.counter(
            "pt_serving_page_allocs", "KV pages handed out.")
        self.accepted = r.counter(
            "pt_serving_requests_accepted", "Requests admitted.")
        self.started = r.counter(
            "pt_serving_requests_started",
            "Requests fed to the engine (left the queue).")
        self.failed = r.counter(
            "pt_serving_requests_failed",
            "Requests failed by an engine error.")
        self.rejected = r.counter(
            "pt_serving_requests_rejected",
            "Requests refused by admission control (backpressure).")
        self.completed = r.counter(
            "pt_serving_requests_completed", "Requests finished.")
        self.cancelled = r.counter(
            "pt_serving_requests_cancelled", "Requests cancelled.")
        self.expired = r.counter(
            "pt_serving_requests_expired", "Requests past deadline.")
        # prefix KV cache (serving/kvcache.py): admission-time reuse
        self.prefix_lookups = r.counter(
            "pt_prefix_lookups",
            "Admissions that consulted the prefix cache.")
        self.prefix_hits = r.counter(
            "pt_prefix_hits", "Admissions that matched a cached prefix.")
        self.prefix_hit_rate = r.gauge(
            "pt_prefix_hit_rate",
            "Prefix-cache hit rate over admitted requests.")
        self.prefix_tokens_reused = r.counter(
            "pt_prefix_tokens_reused",
            "Prompt tokens served from cached KV pages instead of "
            "prefill compute.")
        self.prefix_evictions = r.counter(
            "pt_prefix_evictions",
            "Cached rc==0 pages reclaimed by allocation.")
        self.prefix_cached_pages = r.gauge(
            "pt_prefix_cached_pages",
            "Reclaimable rc==0 pages parked in the prefix cache.")
        # host-RAM KV tier (serving/kvtier.py): evicted prefix pages
        # demoted to host memory + the preemption offload stash, one
        # ledger. Counters mirror the tier's own rollups via on_step
        # deltas (spills land on the tier's copy thread; the mirror
        # runs on the pump, so every series stays single-writer).
        self.tier_spills = r.counter(
            "pt_prefix_tier_spills",
            "Evicted prefix pages spilled to the host-RAM tier.")
        self.tier_hits = r.counter(
            "pt_prefix_tier_hits",
            "Admissions that matched KV in the host tier.")
        self.tier_restores = r.counter(
            "pt_prefix_tier_restores",
            "KV pages restored host->device from the tier.")
        self.tier_drops = r.counter(
            "pt_prefix_tier_drops",
            "Host-tier pages dropped under the tier_bytes budget.")
        self.tier_copy_errors = r.counter(
            "pt_prefix_tier_copy_errors",
            "Spill copies that failed on the tier's copy thread (the "
            "page is dropped, the thread survives).")
        self.tier_host_bytes = r.gauge(
            "pt_tier_host_bytes",
            "Host RAM held by the KV tier (spilled pages + preemption "
            "stash).")
        self.tier_pages = r.gauge(
            "pt_tier_pages", "KV pages resident in the host tier.")
        self._tier_seen = {"spills": 0, "hits": 0, "restores": 0,
                           "drops": 0, "copy_errors": 0}
        # disaggregated prefill/decode (docs/serving.md § Disaggregated
        # prefill/decode): KV handoff traffic between role-specialized
        # replicas. Mirrored from engine ints via on_step deltas like
        # the tier counters (export runs on the pump thread, import on
        # the destination's pump — each replica's registry is private,
        # so every series stays single-writer); the router's /metrics
        # relabelling exposes them per replica for free.
        self.handoff_exports = r.counter(
            "pt_handoff_exports",
            "Requests whose KV pages were exported for a "
            "prefill->decode handoff.")
        self.handoff_imports = r.counter(
            "pt_handoff_imports",
            "Requests continued from an imported KV handoff payload.")
        self.handoff_bytes = r.counter(
            "pt_handoff_bytes",
            "KV payload bytes moved by handoffs (counted on both the "
            "export and import side).")
        self.handoff_failures = r.counter(
            "pt_handoff_failures",
            "Handoff exports/imports that failed and degraded to "
            "local decode / recompute-resume.")
        self.handoff_seconds = r.histogram(
            "pt_handoff_seconds",
            "Wall time of one handoff export or import (fence + "
            "encode/scatter, per side).")
        self._handoff_seen = {"handoff_exports": 0, "handoff_imports": 0,
                              "handoff_bytes": 0, "handoff_failures": 0}
        # crash recovery (serving/faults.py + scheduler warm restart):
        # restart cadence, requeue volume, and poison quarantines —
        # the numbers docs/reliability.md's runbook reads
        self.engine_restarts = r.counter(
            "pt_engine_restarts",
            "Warm restarts after an engine step exception (device "
            "state released, unstarted requests requeued).")
        self.restart_seconds = r.histogram(
            "pt_engine_restart_seconds",
            "Wall time of one warm restart: device-state release "
            "through requeue.")
        self.requests_requeued = r.counter(
            "pt_requests_requeued",
            "Requests requeued by a warm restart instead of failed.")
        self.poison_quarantined = r.counter(
            "pt_poison_quarantined",
            "Requests quarantined as poison after crashing K "
            "consecutive admitted steps.")
        # SLO / goodput plane (serving/timeline.py): judged per
        # completed request in the scheduler's finalize path from the
        # request's stitched timeline. Goodput is the Gemma-serving /
        # MPMD objective: tokens delivered INSIDE the latency target.
        self.total_tokens = r.counter(
            "pt_tokens",
            "Output tokens of completed requests (goodput denominator).")
        self.goodput_tokens = r.counter(
            "pt_goodput_tokens",
            "Output tokens of completed requests that met their SLO "
            "(requests with no SLO class count as delivered).")
        # pulse plane (observability/pulse.py) + process identity:
        # start time per the Prometheus convention, the self-cost of
        # one scrape/sample pass (the pulse plane's overhead is itself
        # observable), running-slot mix and per-priority queue depth —
        # the labeled series the pulse rings read trends from
        self.process_start_time = r.gauge(
            "pt_process_start_time_seconds",
            "Unix time the serving process started.")
        self.process_start_time.set(_process_start_time())
        self.scrape_self = r.gauge(
            "pt_scrape_self_seconds",
            "Wall time of the last metrics scrape / pulse sample pass "
            "(anomaly scan + snapshot + ring derivation).")
        self._slot_mix = {
            kind: r.gauge(
                "pt_serving_slots",
                "Occupied engine slots by phase of the request "
                "holding them.", labels={"kind": kind})
            for kind in ("prefill", "decode")}
        self._queue_priority = {}       # priority -> labeled gauge
        self.step_anomalies = r.counter(
            "pt_step_anomalies",
            "Serving steps flagged as stalls by the EWMA+MAD anomaly "
            "sentinel (each leaves an anomaly.step_stall flight record).")
        self.phase_seconds = {
            ph: r.histogram(
                f"pt_phase_{ph}_seconds",
                f"Wall seconds completed requests spent in the "
                f"'{ph}' phase of their timeline.")
            for ph in ("queued", "prefill", "decode", "preempted",
                       "handoff")}
        self._slo_attained = {}     # class -> labeled counter
        self._slo_violated = {}     # phase -> labeled counter

    # -- engine-facing hooks (called from the step()-driving thread) --
    def on_submit(self, engine):
        # with an external queue the scheduler already counted the
        # admission (engine.submit here is just the feed step)
        if not self._external_queue:
            self.accepted.inc()
            depth = len(engine._waiting)
            self.queue_depth.set(depth)
            self.queue_depth_peak.set_to_max(depth)

    def on_handoff(self, engine):
        """Mirror the engine's handoff counters. Runs inside on_step
        AND directly from the harvest/import sites: a prefill replica
        can go idle the moment its last request migrates away, with no
        further step to carry the delta onto /metrics."""
        seen = self._handoff_seen
        for attr, counter in (("handoff_exports", self.handoff_exports),
                              ("handoff_imports", self.handoff_imports),
                              ("handoff_bytes", self.handoff_bytes),
                              ("handoff_failures",
                               self.handoff_failures)):
            cur = getattr(engine, attr, 0)
            delta = cur - seen[attr]
            if delta > 0:
                counter.inc(delta)
                seen[attr] = cur
        # per-handoff durations drain on the pump thread (the same
        # thread that appends them), so a plain list is race-free
        times = getattr(engine, "_handoff_times", None)
        if times:
            for dt in times:
                self.handoff_seconds.observe(dt)
            del times[:]

    def on_step(self, engine, n_active):
        self.steps.inc()
        self.batch_occupancy.set(n_active / max(engine.max_seqs, 1))
        self.active.set(n_active)
        self.pages_free.set(len(engine._free))
        self.pages_total.set(engine.num_pages - 1)
        self.prefill_tokens.set(engine.prefill_tokens)
        seen = self._tok_seen
        for attr, counter in (("pad_tokens", self.pad_tokens),
                              ("ragged_tokens", self.ragged_tokens),
                              ("logit_rows", self.logit_rows),
                              ("logit_rows_skipped",
                               self.logit_rows_skipped)):
            cur = getattr(engine, attr, 0)
            delta = cur - seen[attr]
            if delta > 0:
                counter.inc(delta)
                seen[attr] = cur
        self.on_handoff(engine)
        pc = getattr(engine, "prefix_cache", None)
        if pc is not None:
            self.prefix_cached_pages.set(pc.cached_pages)
        tier = getattr(engine, "host_tier", None)
        if tier is not None:
            st = tier.stats()
            self.tier_host_bytes.set(st["host_bytes"])
            self.tier_pages.set(st["pages"])
            seen = self._tier_seen
            for name, counter in (("spills", self.tier_spills),
                                  ("hits", self.tier_hits),
                                  ("restores", self.tier_restores),
                                  ("drops", self.tier_drops),
                                  ("copy_errors", self.tier_copy_errors)):
                delta = st[name] - seen[name]
                if delta > 0:
                    counter.inc(delta)
                    seen[name] = st[name]
        if not self._external_queue:
            depth = len(engine._waiting)
            self.queue_depth.set(depth)
            self.queue_depth_peak.set_to_max(depth)

    def observe_ttft(self, dt):
        self.ttft.observe(dt)

    def observe_host_gap(self, dt):
        """Engine hook: wall time from the previous decode/verify
        dispatch returning to this one starting."""
        self.host_gap.observe(dt)

    def set_pipeline_depth(self, depth):
        self.pipeline_depth.set(depth)

    def observe_tpot(self, dt):
        self.tpot.observe(dt)

    def on_tokens(self, n):
        self.tokens.inc(n)

    def on_preempt(self, policy):
        self.preemptions.inc()

    def on_page_alloc(self, n):
        self.page_allocs.inc(n)

    def on_finish(self, req, dt=None):
        self.completed.inc()
        if dt is not None:
            self.e2e.observe(dt)

    def on_cancel(self, where):
        self.cancelled.inc()

    def on_prefix_lookup(self, cached_tokens):
        """One admitted request consulted the prefix cache;
        cached_tokens == 0 is a miss."""
        self.prefix_lookups.inc()
        if cached_tokens > 0:
            self.prefix_hits.inc()
            self.prefix_tokens_reused.inc(cached_tokens)
        lk = self.prefix_lookups.value
        self.prefix_hit_rate.set(self.prefix_hits.value / lk if lk
                                 else 0.0)

    def on_prefix_evict(self, n=1):
        self.prefix_evictions.inc(n)

    # -- scheduler-facing hooks --
    def observe_step(self, dt):
        self.step_seconds.observe(dt)

    def on_reject(self):
        self.rejected.inc()

    def on_start(self):
        """A queued request was fed to the engine."""
        self.started.inc()

    def on_fail(self):
        """A request was failed by an engine error (the router's
        failover trigger)."""
        self.failed.inc()

    def on_restart(self, dt):
        """One warm restart completed (device-state release through
        requeue) in `dt` seconds."""
        self.engine_restarts.inc()
        self.restart_seconds.observe(dt)

    def on_requeue(self, n):
        """`n` requests were requeued instead of failed."""
        self.requests_requeued.inc(n)

    def on_poison(self):
        """A request was quarantined as poison."""
        self.poison_quarantined.inc()

    def on_expire(self):
        self.expired.inc()

    def observe_phases(self, phases):
        """One completed request's phase -> seconds breakdown."""
        for ph, dt in phases.items():
            h = self.phase_seconds.get(ph)
            if h is not None:
                h.observe(dt)

    def on_request_tokens(self, n):
        """Output tokens of one completed request (goodput
        denominator; `on_goodput` adds the numerator)."""
        self.total_tokens.inc(n)

    def on_goodput(self, n):
        """`n` tokens were delivered inside their latency objective
        (or carried no objective)."""
        self.goodput_tokens.inc(n)

    def on_slo_attained(self, slo):
        c = self._slo_attained.get(slo)
        if c is None:
            c = self.registry.counter(
                "pt_slo_attained",
                "Completed requests that met their SLO class targets.",
                labels={"slo": slo})
            self._slo_attained[slo] = c
        c.inc()

    def on_slo_violated(self, phase):
        c = self._slo_violated.get(phase)
        if c is None:
            c = self.registry.counter(
                "pt_slo_violated",
                "Completed requests that missed their SLO, attributed "
                "to the dominant phase of the violated budget.",
                labels={"phase": phase})
            self._slo_violated[phase] = c
        c.inc()

    def on_step_anomaly(self, n=1):
        self.step_anomalies.inc(n)

    def set_queue_depth(self, depth):
        self.queue_depth.set(depth)
        self.queue_depth_peak.set_to_max(depth)

    def set_queue_depths(self, by_priority):
        """Per-priority queue depths (labeled gauges) alongside the
        total `set_queue_depth` already books."""
        for priority, depth in by_priority.items():
            g = self._queue_priority.get(priority)
            if g is None:
                g = self.registry.gauge(
                    "pt_serving_queue_depth_priority",
                    "Requests waiting for a slot, by priority class.",
                    labels={"priority": priority})
                self._queue_priority[priority] = g
            g.set(depth)

    def set_slot_mix(self, prefill, decode):
        """Running-slot mix sampled by the pump each step."""
        self._slot_mix["prefill"].set(prefill)
        self._slot_mix["decode"].set(decode)

    def observe_scrape_self(self, dt):
        """Self-cost of one scrape/sample pass (scrape-thread side)."""
        self.scrape_self.set(dt)
