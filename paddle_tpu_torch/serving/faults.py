"""Deterministic fault injection for the serving stack.

Chaos drills against a serving runtime are only evidence when they are
*replayable*: "we killed a replica once and it looked fine" proves
nothing about the crash window that matters. A `FaultPlan` is a seeded,
declarative schedule of failures registered at the stack's real
failure sites — the places a device loss, a bad DMA, or a poisoned
input would actually surface:

  ==================  ====================================================
  point               fires at
  ==================  ====================================================
  step_launch         the decode/verify device dispatch
                      (`ServingEngine.step_launch` / `_spec_step`)
  step_finish         the async result read of a launched step
                      (`step_finish` / the spec fetch)
  suffix_prefill      a prefix-cache hit's suffix-only prefill dispatch
  tier_spill          the host tier's device->host page copy
                      (`HostTier._land`, on the copy thread)
  tier_restore        the tier's host->device restore scatter
                      (`ServingEngine._tier_restore`)
  router_dispatch     `Router.submit`, before replica selection
  handoff_export      the disaggregated-serving KV page export
                      (`HostTier.export_pages`, on the copy thread)
  handoff_import      the decode replica's KV handoff import scatter
                      (`ServingEngine._import_handoff`, before alloc)
  ==================  ====================================================

Each rule arms one point with an action — ``raise`` (an
`InjectedFault`, or a caller-supplied exception), ``delay`` (a sleep,
for timeout/overlap drills), or ``corrupt`` (a deterministic byte flip
of the payload flowing through the point, where one is plumbed) — on
the Nth matching hit, optionally for a run of hits, optionally only
when a named request id is in the batch. Hit counters are per-rule and
advance deterministically with the engine's own step count, so a drill
replays byte-for-byte from the same spec + workload.

Plans come from the ``PT_FAULTS`` environment variable or a
constructor argument. The grammar (documented in docs/reliability.md):

    PT_FAULTS="step_launch:raise@4;tier_spill:raise@1"
    rule   := point ":" action "@" first ["x" (count | "*")] [":" args]
    args   := key "=" value ("," key "=" value)*   # delay=, rid=, msg=
    spec   := (rule | "seed=" int) (";" rule)*

`Replica.kill()` is just one plan among many: it adds an infinite
``step_launch:raise`` rule and `revive()` removes it.

Counterpart of `paddle_tpu/serving/faults.py`: the same points,
actions, grammar and seeded choices. ``corrupt`` flips the same byte of
a torch tensor as of a numpy array of the same dtype and shape (the
port's tier carries torch tensors). Standard library only at import
time, no model imports — the plan can be built anywhere (tests, bench,
ops tooling) and attached to an engine, tier, or router.
"""
from __future__ import annotations

import threading
import time

from .._env import env_str
from ..observability import flight_recorder as _flight

__all__ = ["FaultPlan", "InjectedFault", "POINTS", "ACTIONS"]

POINTS = ("step_launch", "step_finish", "suffix_prefill", "tier_spill",
          "tier_restore", "router_dispatch", "handoff_export",
          "handoff_import")
ACTIONS = ("raise", "delay", "corrupt")


class InjectedFault(RuntimeError):
    """A FaultPlan rule fired with action=raise. Carries the point and
    the hit number so a recovery path (or a test) can tell injected
    failures from organic ones."""

    def __init__(self, point, hit, msg=None):
        self.point = point
        self.hit = hit
        super().__init__(
            msg or f"injected fault at {point} (hit {hit})")


class _Rule:
    __slots__ = ("point", "action", "first", "count", "delay_s", "exc",
                 "msg", "rid", "label", "matched", "fired")

    def __init__(self, point, action, first, count, delay_s, exc, msg,
                 rid, label):
        if point not in POINTS:
            raise ValueError(
                f"faults: unknown point {point!r}; want one of {POINTS}")
        if action not in ACTIONS:
            raise ValueError(
                f"faults: unknown action {action!r}; want one of {ACTIONS}")
        if first < 1:
            raise ValueError(f"faults: first={first}: hits are 1-based")
        if count is not None and count < 1:
            raise ValueError(f"faults: count={count}: want >= 1 or None")
        self.point = point
        self.action = action
        self.first = int(first)
        self.count = None if count is None else int(count)
        self.delay_s = float(delay_s)
        self.exc = exc
        self.msg = msg
        self.rid = rid
        self.label = label
        self.matched = 0            # matching fire() calls seen
        self.fired = 0              # times the action actually ran

    def describe(self):
        span = "*" if self.count is None else str(self.count)
        rid = f":rid={self.rid}" if self.rid is not None else ""
        return f"{self.point}:{self.action}@{self.first}x{span}{rid}"


class FaultPlan:
    """A seeded schedule of injected failures (module doc has the
    grammar and the point registry). Thread-safe: fire() is called from
    the pump thread, the tier's copy thread, and HTTP threads; the
    actions themselves (sleep / raise) run outside the lock."""

    def __init__(self, spec="", seed=0):
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._rules = []
        self.hits = {}              # point -> fire() calls, for drills
        self.fired = []             # (point, hit, action, label) log
        if spec:
            self._parse(spec)

    @classmethod
    def from_env(cls, env=None):
        """Plan from ``PT_FAULTS`` (None when unset/empty — the
        disabled default costs nothing and preserves seed behavior
        exactly)."""
        spec = env_str("PT_FAULTS", env=env)
        return cls(spec) if spec else None

    # -- construction --------------------------------------------------
    def _parse(self, spec):
        for seg in str(spec).split(";"):
            seg = seg.strip()
            if not seg:
                continue
            if seg.startswith("seed="):
                self.seed = int(seg[len("seed="):])
                continue
            head, at, rest = seg.partition("@")
            if not at:
                raise ValueError(
                    f"faults: rule {seg!r} has no '@first' clause")
            point, colon, action = head.partition(":")
            if not colon:
                raise ValueError(
                    f"faults: rule {seg!r} wants point:action@first")
            nth, _, args = rest.partition(":")
            first, x, cnt = nth.partition("x")
            count = 1 if not x else (None if cnt == "*" else int(cnt))
            kw = {}
            for pair in args.split(","):
                if not pair:
                    continue
                k, eq, v = pair.partition("=")
                if not eq:
                    raise ValueError(
                        f"faults: rule {seg!r}: arg {pair!r} wants k=v")
                kw[k] = v
            delay_s = float(kw.pop("delay", 0.01))
            rid = kw.pop("rid", None)
            msg = kw.pop("msg", None)
            if kw:
                raise ValueError(
                    f"faults: rule {seg!r}: unknown args {sorted(kw)}")
            self.add(point.strip(), action.strip(), first=int(first),
                     count=count, delay_s=delay_s, rid=rid, msg=msg)

    def add(self, point, action, *, first=1, count=1, delay_s=0.01,
            exc=None, msg=None, rid=None, label=None):
        """Arm one rule; returns it. `count=None` = every matching hit
        from `first` on (how `Replica.kill` models a dead engine)."""
        rule = _Rule(point, action, first, count, delay_s, exc, msg,
                     rid, label)
        with self._lock:
            self._rules.append(rule)
        return rule

    def remove(self, label):
        """Drop every rule carrying `label` (Replica.revive)."""
        with self._lock:
            self._rules = [r for r in self._rules if r.label != label]

    # -- injection -----------------------------------------------------
    def fire(self, point, value=None, rids=None):
        """One hit at `point`. Counts the hit, runs any armed actions
        (raise / sleep / corrupt), and returns `value` (possibly
        corrupted). `rids` is the request ids at the point, for
        rid-scoped rules (poison-request drills)."""
        if point not in POINTS:
            raise ValueError(
                f"faults: unknown point {point!r}; want one of {POINTS}")
        due = []
        with self._lock:
            hit = self.hits.get(point, 0) + 1
            self.hits[point] = hit
            for rule in self._rules:
                if rule.point != point:
                    continue
                if rule.rid is not None and (
                        rids is None or rule.rid not in rids):
                    continue
                rule.matched += 1
                if rule.matched < rule.first:
                    continue
                if rule.count is not None and \
                        rule.matched >= rule.first + rule.count:
                    continue
                rule.fired += 1
                due.append(rule)
                self.fired.append((point, hit, rule.action, rule.label))
        for rule in due:
            _flight.record("fault.injected", point=point, hit=hit,
                           action=rule.action, label=rule.label,
                           rid=rule.rid)
            if rule.action == "delay":
                time.sleep(rule.delay_s)
            elif rule.action == "corrupt":
                value = self._corrupt(point, hit, value)
            else:  # raise
                raise rule.exc if rule.exc is not None else \
                    InjectedFault(point, hit, rule.msg)
        return value

    def _corrupt(self, point, hit, value):
        """Deterministic single-byte flip of an array payload (a numpy
        array, or a torch tensor: the same byte of its row-major bytes)
        — a seeded stand-in for a bad DMA. Other payloads (points with
        nothing plumbed) pass through untouched."""
        import numpy as np
        if value is None or not hasattr(value, "dtype") or \
                not hasattr(value, "shape"):
            return value
        rs = np.random.RandomState(
            (self.seed * 1000003 + hit * 9176 + len(point)) % (2**31 - 1))
        if isinstance(value, np.ndarray):
            if value.size == 0:
                return value
            a = np.array(value, copy=True)
            buf = a.view(np.uint8).reshape(-1)
            buf[int(rs.randint(0, buf.size))] ^= 0xFF
            return a
        import torch
        if not isinstance(value, torch.Tensor) or value.numel() == 0:
            return value
        a = value.contiguous().clone()
        buf = a.view(-1).view(torch.uint8)
        i = int(rs.randint(0, buf.numel()))
        buf[i] = buf[i] ^ 0xFF
        return a

    # -- introspection -------------------------------------------------
    def stats(self):
        with self._lock:
            return {
                "seed": self.seed,
                "hits": dict(self.hits),
                "fired": len(self.fired),
                "rules": [{"rule": r.describe(), "matched": r.matched,
                           "fired": r.fired, "label": r.label}
                          for r in self._rules],
            }

    def __repr__(self):
        with self._lock:
            rules = ";".join(r.describe() for r in self._rules)
        return f"FaultPlan({rules!r}, seed={self.seed})"
