"""Telemetry pulse plane (aux subsystem: observability).

Every other surface in the stack is point-in-time: `/metrics` shows
cumulative counters, `/debug/flightrecorder` the last N events. This
module adds the *short-horizon history* an operator (or a post-mortem)
actually reads trends from:

  * `PulseRing`    — one bounded time-series of (wall_ts, value).
  * `PulseSampler` — derives a ring per signal **generically** from a
    `MetricsRegistry.snapshot()` dict: counters become per-second
    rates via deltas, gauges are sampled as-is, histograms become
    windowed p50/p99 computed from cumulative-bucket deltas between
    consecutive samples (so the percentiles describe the last
    interval, not the process lifetime). A `goodput_ratio` composite
    is derived from the pt_goodput_tokens / pt_tokens counter pair.
  * `PulsePlane`   — owns a sampler plus the trigger/capture logic:
    a daemon thread ticks every `PT_PULSE_INTERVAL_S` (scrapes also
    opportunistically sample, deduped by the same interval), and on a
    trigger — step-stall anomaly, engine restart, crash-loop breaker
    opening, or an SLO-violation burst — writes a rate-limited
    **capture bundle** to `PT_CAPTURE_DIR`: flight-recorder dump, the
    triggering window of every pulse ring, the recent-request
    timeline ring, the metrics snapshot, and a config/env
    fingerprint, all tagged with the trace ids in flight at the
    trigger. `tools/ptdump.py bundle <dir>` renders one as a
    post-mortem narrative; `tools/ptop.py` renders the live rings.

Zero device syncs by construction: everything here reads host-side
registry snapshots and host clocks — the serving stack's single
sanctioned sync (`ServingEngine._fetch_results`) is untouched, and
the sampler/bundle-writer functions sit in tpulint's TPL001 hot set
so a stray device pull can never hide in the observability plane.

Knobs (read at construction): `PT_SERVE_PULSE=0` disables the plane
entirely (no thread, token-identical outputs), `PT_PULSE_INTERVAL_S`
(default 1.0) the sample cadence, `PT_PULSE_DEPTH` (default 240) the
ring depth, `PT_CAPTURE_DIR` (unset = bundles off), `PT_CAPTURE_MAX`
(default 8 per process) + `PT_CAPTURE_MIN_S` (default 30) the bundle
rate limit, `PT_PULSE_SLO_BURST` (default 3) the violations-per-
interval burst threshold.

Counterpart of `paddle_tpu/observability/pulse.py`, carried over as a copy
(the port's host side is the reference's, held to it by the
`tests/test_torch_*.py` parity tests).
"""
from __future__ import annotations

import json
import math
import os
import sys
import threading
import time
from collections import deque

from . import flight_recorder as _flight
from .._env import env_float, env_int, env_str
from .logging import get_logger

__all__ = ["PulseRing", "PulseSampler", "PulsePlane", "TRIGGERS"]

TRIGGERS = ("step_stall", "engine_restart", "breaker_open", "slo_burst")

# counters whose per-interval delta fires a capture trigger
_TRIGGER_COUNTERS = {
    "pt_step_anomalies": "step_stall",
    "pt_engine_restarts": "engine_restart",
}


class PulseRing:
    """One bounded time-series: (wall_ts, value) pairs, newest last.
    Appends come from the sampler (under the sampler's lock); reads
    copy, so consumers never hold the lock while serializing."""

    __slots__ = ("_ring",)

    def __init__(self, depth):
        self._ring = deque(maxlen=int(depth))

    def append(self, t, v):
        self._ring.append((t, v))

    def window(self, since=None):
        """Points with ts >= since (all when None), as [[t, v], ...]."""
        if since is None:
            return [[t, v] for t, v in self._ring]
        return [[t, v] for t, v in self._ring if t >= since]

    def last(self):
        return self._ring[-1] if self._ring else None

    def __len__(self):
        return len(self._ring)


def _windowed_percentile(prev_buckets, cur_buckets, q):
    """Interpolated q-th percentile of the observations that landed
    BETWEEN two cumulative-bucket snapshots; (None, 0) when no new
    observations arrived. A percentile in the +Inf bucket returns the
    largest finite edge (a lower bound), mirroring Histogram."""
    prev_buckets = prev_buckets or {}
    bounds = sorted(
        (math.inf if k == "+Inf" else float(k), k) for k in cur_buckets)
    total = cur_buckets.get("+Inf", 0) - prev_buckets.get("+Inf", 0)
    if total <= 0:
        return None, 0
    target = total * q / 100.0
    lo = 0.0
    seen = 0
    for b, key in bounds:
        dcum = cur_buckets.get(key, 0) - prev_buckets.get(key, 0)
        if dcum >= target:
            if b == math.inf:
                return lo, total        # lower bound: largest finite edge
            n = dcum - seen
            if n <= 0:
                return b, total
            return lo + (b - lo) * (target - seen) / n, total
        seen = dcum
        if b != math.inf:
            lo = b
    return lo, total


class PulseSampler:
    """Derive bounded ring time-series from successive registry
    snapshots. Signal names are `<metric key>` for gauges,
    `<metric key>:rate` (per second) for counters, and
    `<metric key>:p50` / `:p99` (windowed) for histograms — the
    `signals=` query filter prefix-matches these."""

    def __init__(self, depth=None):
        if depth is None:
            depth = env_int("PT_PULSE_DEPTH")
        self.depth = max(int(depth), 2)
        self._lock = threading.Lock()
        self._rings = {}                # signal name -> PulseRing
        self._prev = None               # previous snapshot dict
        self._prev_t = None
        self._last_pct = {}             # histogram signal -> last value

    def _ring(self, name):
        r = self._rings.get(name)
        if r is None:
            r = PulseRing(self.depth)
            self._rings[name] = r
        return r

    def sample(self, snap, t=None):
        """Fold one registry snapshot into the rings. Pure host
        arithmetic over the snapshot dict — no device traffic, no
        metric-object access (the snapshot already copied under the
        registry's locks)."""
        if t is None:
            t = time.time()
        with self._lock:
            prev, prev_t = self._prev, self._prev_t
            dt = None if prev_t is None else max(t - prev_t, 1e-9)
            for key, m in snap.items():
                kind = m.get("type") if isinstance(m, dict) else None
                if kind == "gauge":
                    self._ring(key).append(t, float(m["value"]))
                elif kind == "counter":
                    if dt is None:
                        continue        # first sample: no delta yet
                    pm = prev.get(key)
                    base = float(pm["value"]) if pm else 0.0
                    rate = max(float(m["value"]) - base, 0.0) / dt
                    self._ring(f"{key}:rate").append(t, rate)
                elif kind == "histogram":
                    if dt is None:
                        continue    # first sample: no window yet
                    pm = prev.get(key)
                    for q, tag in ((50, "p50"), (99, "p99")):
                        name = f"{key}:{tag}"
                        v, n = _windowed_percentile(
                            (pm or {}).get("buckets"),
                            m.get("buckets", {}), q)
                        if n == 0:
                            # idle interval: carry the last computed
                            # value so the series stays dense
                            v = self._last_pct.get(name, 0.0)
                        else:
                            self._last_pct[name] = v
                        self._ring(name).append(t, v)
            self._goodput(snap, prev, t)
            self._prev, self._prev_t = snap, t
        return t

    def _goodput(self, snap, prev, t):
        """Composite: delta(goodput_tokens)/delta(total_tokens) over
        the interval; 1.0 while nothing completed (no evidence of
        badput)."""
        cur_t = snap.get("pt_tokens")
        cur_g = snap.get("pt_goodput_tokens")
        if cur_t is None or cur_g is None:
            return
        pt = (prev or {}).get("pt_tokens")
        pg = (prev or {}).get("pt_goodput_tokens")
        d_tot = float(cur_t["value"]) - (float(pt["value"]) if pt else 0.0)
        d_good = float(cur_g["value"]) - (float(pg["value"]) if pg else 0.0)
        ring = self._ring("goodput_ratio")
        if d_tot <= 0:
            last = ring.last()
            ring.append(t, last[1] if last else 1.0)
        else:
            ring.append(t, max(min(d_good / d_tot, 1.0), 0.0))

    def series(self, window=None, signals=None, now=None):
        """JSON-shaped view: {signal: [[t, v], ...]}. `window` trims to
        the last N seconds; `signals` is an iterable of name prefixes
        (a bare metric name selects all its derived signals)."""
        if now is None:
            now = time.time()
        since = None if not window else now - float(window)
        with self._lock:
            items = sorted(self._rings.items())
            out = {}
            for name, ring in items:
                if signals and not any(name.startswith(s)
                                       for s in signals):
                    continue
                pts = ring.window(since)
                if pts:
                    out[name] = pts
        return out


def _env_fingerprint():
    """The config/env half of a bundle: every PT_/PADDLE_TPU_/JAX_
    knob plus process identity — enough to answer 'what exactly was
    this process running' without the process."""
    env = {k: v for k, v in sorted(os.environ.items())
           if k.startswith(("PT_", "PADDLE_TPU_", "JAX_"))}
    return {"pid": os.getpid(), "argv": list(sys.argv),
            "python": sys.version.split()[0],
            "platform": sys.platform, "env": env}


class PulsePlane:
    """Sampler + trigger/capture logic for one scheduler (the Router
    aggregates per-replica planes through `RequestScheduler.pulse`).

    Callables are injected so this module imports nothing from
    serving/ (no cycle): `snapshot_fn()` returns the registry
    snapshot, `scan_fn()` runs scrape-side analysis first (the
    anomaly sentinel), `info_fn()` returns trigger-time context
    (trace ids in flight, breaker state), `recent_fn(n)` the recent-
    request ring, `self_cost_fn(dt)` books the pass's own cost
    (pt_scrape_self_seconds)."""

    def __init__(self, snapshot_fn, *, scan_fn=None, info_fn=None,
                 recent_fn=None, self_cost_fn=None, interval_s=None,
                 depth=None, capture_dir=None, capture_max=None,
                 capture_min_s=None, slo_burst=None, start_thread=True,
                 name="pt-pulse"):
        if interval_s is None:
            interval_s = env_float("PT_PULSE_INTERVAL_S")
        self.interval_s = max(float(interval_s), 0.01)
        self._snapshot_fn = snapshot_fn
        self._scan_fn = scan_fn
        self._info_fn = info_fn
        self._recent_fn = recent_fn
        self._self_cost_fn = self_cost_fn
        self.sampler = PulseSampler(depth=depth)
        if capture_dir is None:
            capture_dir = env_str("PT_CAPTURE_DIR") or None
        self.capture_dir = capture_dir
        self.capture_max = int(capture_max if capture_max is not None
                               else env_int("PT_CAPTURE_MAX"))
        self.capture_min_s = float(
            capture_min_s if capture_min_s is not None
            else env_float("PT_CAPTURE_MIN_S"))
        self.slo_burst = int(slo_burst if slo_burst is not None
                             else env_int("PT_PULSE_SLO_BURST"))
        self._log = get_logger("pulse")
        self._lock = threading.Lock()   # sample dedup + trigger state
        self._last_sample_t = 0.0
        self._trig_prev = None          # counter values at last check
        self._breaker_prev = False
        self.triggers = {k: 0 for k in TRIGGERS}    # fired (pre-limit)
        self.bundles = []               # paths written
        self._bundle_last_t = 0.0
        self._bundle_seq = 0
        self._stop = threading.Event()
        self._thread = None
        if start_thread:
            self._thread = threading.Thread(
                target=self._run, name=name, daemon=True)
            self._thread.start()

    # -- sampling ------------------------------------------------------
    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the plane must
                # never take the process down; evidence over purity
                self._log.event("pulse.error", level="error",
                                error=repr(e))

    def tick(self, scanned=False):
        """One sample + trigger pass. Pure host work: scrape-side
        analysis, one registry snapshot, ring appends, counter-delta
        trigger checks. Runs on the pulse thread (and, deduped, on
        whatever thread scrapes /metrics or /debug/pulse)."""
        t0 = time.perf_counter()
        if self._scan_fn is not None and not scanned:
            self._scan_fn()
        snap = self._snapshot_fn()
        now = self.sampler.sample(snap)
        with self._lock:
            self._last_sample_t = now
        self._check_triggers(snap)
        if self._self_cost_fn is not None:
            self._self_cost_fn(time.perf_counter() - t0)

    def maybe_sample(self, scanned=False):
        """Opportunistic sample from a scrape path: ticks only when at
        least one interval passed since the last sample (the scrape
        cadence rides for free, the daemon thread fills the gaps)."""
        with self._lock:
            due = time.time() - self._last_sample_t >= self.interval_s
        if due:
            self.tick(scanned=scanned)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s + 1.0)

    @property
    def thread_alive(self):
        return self._thread is not None and self._thread.is_alive()

    # -- exposure ------------------------------------------------------
    def payload(self, window=None, signals=None):
        """The /debug/pulse JSON body."""
        now = time.time()
        with self._lock:
            triggers = dict(self.triggers)
            bundles = list(self.bundles)
        return {
            "enabled": True,
            "now": now,
            "interval_s": self.interval_s,
            "depth": self.sampler.depth,
            "signals": self.sampler.series(window=window,
                                           signals=signals, now=now),
            "triggers": triggers,
            "bundles": bundles,
        }

    def trigger_state(self):
        """Light cross-host poll target: cumulative trigger fires,
        local bundle paths, and the trace ids in flight — no rings, no
        registry snapshot. The fleet plane diffs `triggers` between
        polls to fire ONE fleet-wide capture per incident."""
        info = self._info_fn() if self._info_fn is not None else {}
        with self._lock:
            return {"triggers": dict(self.triggers),
                    "bundles": list(self.bundles),
                    "trace_ids": list(info.get("trace_ids") or [])}

    # -- triggers + capture bundles -----------------------------------
    def _trigger_counts(self, snap):
        counts = {}
        for key, m in snap.items():
            if not isinstance(m, dict) or m.get("type") != "counter":
                continue
            base = key.partition("{")[0]
            if base in _TRIGGER_COUNTERS:
                counts[key] = float(m["value"])
            elif base == "pt_slo_violated":
                counts[key] = float(m["value"])
        return counts

    def _check_triggers(self, snap):
        info = self._info_fn() if self._info_fn is not None else {}
        breaker = bool(info.get("breaker_open"))
        counts = self._trigger_counts(snap)
        fired = []
        # the whole delta pass runs under the lock: tick() races itself
        # (pulse daemon vs. opportunistic scrape threads), and an
        # unlocked `triggers[trig] += 1` read-modify-write loses fires
        # exactly when two triggers coincide — the moment they matter.
        # Only the capture (file I/O) runs outside.
        with self._lock:
            prev = self._trig_prev
            self._trig_prev = counts
            breaker_prev, self._breaker_prev = self._breaker_prev, breaker
            if prev is None:
                return                  # first pass: baseline only
            slo_delta = 0.0
            for key, cur in counts.items():
                delta = cur - prev.get(key, 0.0)
                if delta <= 0:
                    continue
                base = key.partition("{")[0]
                if base == "pt_slo_violated":
                    slo_delta += delta
                else:
                    fired.append(_TRIGGER_COUNTERS[base])
            if slo_delta >= self.slo_burst:
                fired.append("slo_burst")
            if breaker and not breaker_prev:
                fired.append("breaker_open")
            for trig in fired:
                self.triggers[trig] += 1
        if fired:
            self._capture(fired[0], info, snap)

    def _rate_limited(self):
        now = time.monotonic()
        with self._lock:
            if self.capture_dir is None:
                return True
            if self._bundle_seq >= self.capture_max:
                return True
            if self.bundles and \
                    now - self._bundle_last_t < self.capture_min_s:
                return True
            self._bundle_last_t = now
            self._bundle_seq += 1
            return False

    def _capture(self, trigger, info, snap):
        if self._rate_limited():
            return None
        return self._write_bundle(trigger, info, snap)

    def _write_bundle(self, trigger, info, snap):
        """Write one capture bundle directory. Runs on the pulse (or a
        scrape) thread — never the pump; the only cost to the serving
        path is the registry locks the snapshot already took."""
        stamp = time.strftime("%Y%m%d-%H%M%S")
        with self._lock:
            seq = self._bundle_seq
            triggers_total = dict(self.triggers)
        name = f"bundle-{stamp}-{seq:03d}-{trigger}" \
               f"-{os.getpid()}"
        path = os.path.join(self.capture_dir, name)
        os.makedirs(path, exist_ok=True)
        trace_ids = list(info.get("trace_ids") or [])
        meta = {
            "trigger": trigger, "at": time.time(), "pid": os.getpid(),
            "trace_ids": trace_ids,
            "triggers_total": triggers_total,
            "info": {k: v for k, v in info.items() if k != "trace_ids"},
        }
        pulse_doc = self.payload()
        # the triggering window of every ring carries the trigger's
        # identity — a bundle's pulse.json is self-describing
        pulse_doc["trigger"] = meta
        docs = {
            "meta.json": meta,
            "flight.json": _flight.snapshot(
                reason=f"pulse:{trigger}"),
            "pulse.json": pulse_doc,
            "requests.json": {
                "requests": (self._recent_fn(64)
                             if self._recent_fn is not None else [])},
            "metrics.json": snap,
            "config.json": _env_fingerprint(),
        }
        for fname, doc in docs.items():
            tmp = os.path.join(path, f".{fname}.tmp")
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, os.path.join(path, fname))
        with self._lock:
            self.bundles.append(path)
        _flight.record("pulse.bundle", trigger=trigger, path=path,
                       trace_ids=trace_ids or None)
        self._log.event("pulse.bundle", level="warning",
                        trigger=trigger, path=path)
        return path
