"""Per-request timelines and the SLO/goodput accounting plane.

Every `ServingRequest` carries a `Timeline`: a compact, append-only
list of (mark, host-clock stamp) pairs covering the request's whole
life — `submit → admit → first_token → ... → end` — plus every
exceptional transition the stack can inject (`preempted/resumed`,
`requeued` after a crash, `handoff_export → migrate → handoff_import`
for disaggregation, `spill/restore` for the KV tier) and per-phase
step counts. Marks are `time.monotonic()` stamps taken on whichever
thread owns the request at that moment (submitter, pump, copy thread);
there is exactly ZERO device work here — the plane must never add a
sync to the step loop (tpulint TPL001 and the sanctioned-reader test
enforce this).

A timeline survives migration: `ServingEngine._export_handoff` embeds
`to_dict()` in the `KVHandoff` payload and the decode replica's
scheduler resumes it with `from_dict()`, so a request that crossed
replicas still has ONE stitched, monotonic timeline (in-process
replicas share a monotonic clock; a future cross-host transport must
re-anchor stamps at import).

Phase attribution: every interval between consecutive marks belongs to
exactly one phase — `queued`, `prefill`, `decode`, `preempted`, or
`handoff` — determined by the mark that *opened* the interval (see
`_advance`). Because the intervals tile the request's life, the phase
durations always sum to the end-to-end latency exactly; the e2e
"within 5%" acceptance check is really a stitching check.

On top of the timeline sits SLO accounting: a request's `slo` class
(`"interactive"` / `"batch"` / None, defaulting from its priority)
names ttft/tpot targets; `judge_slo` decides attainment and blames a
violation on its dominant phase (the largest phase inside the violated
budget's window). `StepAnomalySentinel` watches the step-time stream
with an EWMA mean + EWMA-MAD band and flags stalls — fed by the pump
with a lock-free deque append, drained ONLY on the scrape thread.

Counterpart of `paddle_tpu/serving/timeline.py`, carried over as a copy
(the port's host side is the reference's, held to it by the
`tests/test_torch_*.py` parity tests).
"""
from __future__ import annotations

from collections import deque
from time import monotonic as _mono

from .._env import env_float

__all__ = ["Timeline", "StepAnomalySentinel", "SLO_CLASSES",
           "resolve_slo", "slo_targets", "judge_slo", "PHASES"]

# The five phases every interval of a request's life maps onto.
PHASES = ("queued", "prefill", "decode", "preempted", "handoff")

SLO_CLASSES = ("interactive", "batch")

# class -> (ttft_s, tpot_s) defaults; override per class with
# PT_SLO_<CLASS>_TTFT_S / PT_SLO_<CLASS>_TPOT_S (read per judgement so
# tests and operators can flip targets without rebuilding schedulers).
_SLO_DEFAULTS = {"interactive": (1.0, 0.1), "batch": (10.0, 1.0)}

# priority -> default SLO class when the caller didn't name one.
_PRIORITY_SLO = {"high": "interactive", "low": "batch"}


def resolve_slo(slo, priority):
    """Explicit class wins; else default from priority (high →
    interactive, low → batch, normal → no objective)."""
    if slo is not None:
        if slo not in SLO_CLASSES:
            raise ValueError(
                f"slo={slo!r}: want one of {SLO_CLASSES} or None")
        return slo
    return _PRIORITY_SLO.get(priority)


def slo_targets(slo):
    """(ttft_s, tpot_s) targets for a class, env-overridable."""
    d_ttft, d_tpot = _SLO_DEFAULTS[slo]
    up = slo.upper()
    return (env_float(f"PT_SLO_{up}_TTFT_S", d_ttft),
            env_float(f"PT_SLO_{up}_TPOT_S", d_tpot))


def judge_slo(slo, ttft_s, tpot_s, phases):
    """Judge one finished request against its class targets.

    Returns `(attained, violated_phase)` — `violated_phase` is None
    when attained, else the dominant phase of the most-overshot budget:
    a ttft miss blames the largest pre-first-token phase (queued /
    prefill / handoff / preempted), a tpot miss blames the largest
    post-first-token phase (decode / preempted / handoff / queued).
    """
    t_ttft, t_tpot = slo_targets(slo)
    over_ttft = (ttft_s / t_ttft) if (
        ttft_s is not None and t_ttft > 0 and ttft_s > t_ttft) else 0.0
    over_tpot = (tpot_s / t_tpot) if (
        tpot_s is not None and t_tpot > 0 and tpot_s > t_tpot) else 0.0
    if not over_ttft and not over_tpot:
        return True, None
    if over_ttft >= over_tpot:
        pool = ("queued", "prefill", "handoff", "preempted")
    else:
        pool = ("decode", "preempted", "handoff", "queued")
    best, best_v = pool[0], -1.0
    for p in pool:
        v = phases.get(p, 0.0)
        if v > best_v:
            best, best_v = p, v
    return False, best


class Timeline:
    """Append-only (mark, monotonic-stamp) ledger + per-phase step
    counts. Appends are single plain-list ops (GIL-atomic); every
    cross-thread handover in the stack (queue put / Event set / handoff
    payload) already orders the reads, so marks need no lock."""

    __slots__ = ("marks", "steps")

    def __init__(self, marks=None, steps=None):
        self.marks = marks if marks is not None else []
        self.steps = steps if steps is not None else {}

    # -- recording (hot path: host clock only, no locks) ---------------
    def mark(self, name, t=None):
        self.marks.append((name, _mono() if t is None else t))

    def count(self, phase, n=1):
        self.steps[phase] = self.steps.get(phase, 0) + n

    def has(self, name):
        for m, _ in self.marks:
            if m == name:
                return True
        return False

    # -- transport (KVHandoff payload / JSON) --------------------------
    def to_dict(self):
        return {"marks": [[m, t] for m, t in self.marks],
                "steps": dict(self.steps)}

    @classmethod
    def from_dict(cls, d):
        if not d:
            return None
        return cls(marks=[(str(m), float(t)) for m, t in
                          d.get("marks", ())],
                   steps=dict(d.get("steps", ()) or {}))

    # -- derived views -------------------------------------------------
    def t_start(self):
        return self.marks[0][1] if self.marks else None

    def t_end(self):
        return self.marks[-1][1] if self.marks else None

    def t_of(self, name):
        for m, t in self.marks:
            if m == name:
                return t
        return None

    def elapsed(self):
        return (self.marks[-1][1] - self.marks[0][1]) if self.marks \
            else 0.0

    def ttft(self):
        """submit → first token, across requeues and migration."""
        t0, tf = self.t_start(), self.t_of("first_token")
        return None if (t0 is None or tf is None) else tf - t0

    def tpot(self, tokens):
        """Mean per-token time after the first, over the stitched
        life (recompute after a crash counts against the budget)."""
        tf, te = self.t_of("first_token"), self.t_end()
        if tf is None or te is None or tokens <= 1:
            return None
        return (te - tf) / (tokens - 1)

    @staticmethod
    def _advance(cur, name, seen_first):
        """Phase opened by `name`, given the running phase `cur`.
        Annotation marks (spill/restore/tier hits/end) keep `cur`."""
        if name in ("submit", "requeued", "migrate"):
            return "queued", seen_first
        if name in ("admit", "resumed"):
            return ("decode" if seen_first else "prefill"), seen_first
        if name == "first_token":
            return "decode", True
        if name == "preempted":
            return "preempted", seen_first
        if name == "handoff_export":
            return "handoff", seen_first
        if name == "handoff_import":
            return "decode", True
        return cur, seen_first

    def segments(self):
        """Contiguous (phase, t0, t1) intervals tiling the timeline,
        consecutive same-phase intervals merged."""
        segs = []
        cur, t0, seen_first = None, None, False
        for name, t in self.marks:
            nxt, seen_first = self._advance(cur, name, seen_first)
            if cur is None:
                cur, t0 = (nxt or "queued"), t
                continue
            if nxt != cur:
                if t > t0:
                    segs.append((cur, t0, t))
                cur, t0 = nxt, t
        if cur is not None and self.marks[-1][1] > t0:
            segs.append((cur, t0, self.marks[-1][1]))
        return segs

    def phases(self):
        """phase -> total seconds; sums to elapsed() exactly."""
        out = {}
        for ph, a, b in self.segments():
            out[ph] = out.get(ph, 0.0) + (b - a)
        return out


class StepAnomalySentinel:
    """EWMA + MAD stall detector over the serving step-time stream.

    The pump feeds `note()` — one deque append, no math, no locks (a
    bounded deque drops the oldest sample under scrape starvation,
    which is the right failure mode for telemetry). ALL analysis
    happens in `scan()`, called from the metrics exposition path on
    the scrape thread: it drains the buffer, maintains an EWMA mean
    and an EWMA of absolute deviation (a robust stand-in for MAD), and
    flags any step slower than `mean + max(k*mad, floor_s)`. Flagged
    steps are excluded from the baseline so one stall doesn't widen
    the band that should catch the next one.
    """

    def __init__(self, warmup=20, k=8.0, floor_s=0.05, alpha=0.1,
                 maxlen=512):
        self.warmup = int(warmup)
        self.k = float(k)
        self.floor_s = env_float("PT_ANOMALY_FLOOR_S", floor_s)
        self.alpha = float(alpha)
        self._buf = deque(maxlen=int(maxlen))
        self._mean = None
        self._mad = 0.0
        self._n = 0

    # pump thread: append only
    def note(self, dt, n_prefill=0, n_decode=0):
        self._buf.append((dt, n_prefill, n_decode))

    # scrape thread: drain + judge
    def scan(self):
        out = []
        while True:
            try:
                dt, npf, ndc = self._buf.popleft()
            except IndexError:
                break
            if self._mean is not None and self._n >= self.warmup:
                thresh = self._mean + max(self.k * self._mad,
                                          self.floor_s)
                if dt > thresh:
                    out.append({
                        "step_s": round(dt, 6),
                        "mean_s": round(self._mean, 6),
                        "mad_s": round(self._mad, 6),
                        "threshold_s": round(thresh, 6),
                        "prefill_slots": npf,
                        "decode_slots": ndc,
                    })
                    self._n += 1
                    continue
            if self._mean is None:
                self._mean = dt
            else:
                self._mad += self.alpha * (abs(dt - self._mean)
                                           - self._mad)
                self._mean += self.alpha * (dt - self._mean)
            self._n += 1
        return out
