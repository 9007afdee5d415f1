"""Crash flight recorder (aux subsystem: observability).

A bounded ring of recent structured events — spans, compile/retrace
events, scheduler decisions, errors, step records — that can be dumped
as JSON at any moment: on demand (the serving server's
`/debug/flightrecorder`), on SIGTERM, or around a fault
(`faulthandler` is wired by `install()`). The point is that when a
serving process dies or stalls, the last few thousand events are
evidence on disk instead of vapor.

Reference: the paper stack's profiler host ring + the XLA "debug
flight recorder" idea; TPU retrace storms and host syncs are invisible
in aggregate metrics but obvious in the last N events.

Always cheap: `record()` is one dict build + deque append under a
lock. Disable entirely with PADDLE_TPU_FLIGHT=0.

Counterpart of `paddle_tpu/observability/flight_recorder.py`, carried over as a copy
(the port's host side is the reference's, held to it by the
`tests/test_torch_*.py` parity tests).
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time

from .._env import env_int, env_str

__all__ = ["FlightRecorder", "RECORDER", "record", "snapshot", "dump",
           "install", "thread_stacks"]

DEFAULT_CAPACITY = env_int("PADDLE_TPU_FLIGHT_EVENTS")


class FlightRecorder:
    def __init__(self, capacity=DEFAULT_CAPACITY, enabled=None):
        import collections
        self._ring = collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._seq = 0
        self._dropped = 0
        if enabled is None:
            enabled = env_str("PADDLE_TPU_FLIGHT", "1") != "0"
        self.enabled = enabled
        self._installed = False
        self._prev_sigterm = None

    # -- recording (hot path) -----------------------------------------
    def record(self, kind, **fields):
        """Append one event. `fields` must be JSON-serializable."""
        if not self.enabled:
            return None
        ev = {"ts": time.time(), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(ev)
        return ev

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._dropped = 0

    # -- reading -------------------------------------------------------
    def events(self, kind=None):
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def snapshot(self, reason="on_demand"):
        with self._lock:
            evs = list(self._ring)
            dropped = self._dropped
        return {
            "dumped_at": time.time(),
            "reason": reason,
            "pid": os.getpid(),
            "capacity": self._ring.maxlen,
            "dropped": dropped,
            "compile": _compile_totals(),
            "events": evs,
        }

    def dump(self, path=None, reason="on_demand"):
        """Write the snapshot as JSON; returns the path written."""
        if path is None:
            d = env_str("PADDLE_TPU_FLIGHT_DIR")
            path = os.path.join(
                d, f"pt_flightrecorder-{os.getpid()}.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(reason=reason), f)
        os.replace(tmp, path)
        return path

    # -- crash wiring --------------------------------------------------
    def install(self, dump_path=None, sigterm=True, fault=True):
        """Wire the recorder to process death: SIGTERM dumps the ring
        (then chains to the previous handler / default exit), and
        `faulthandler` is enabled so hard faults print every thread's
        stack. Main-thread only for the signal part (CPython rule);
        callers off the main thread just get faulthandler."""
        if self._installed:
            return False
        if fault:
            import faulthandler
            if not faulthandler.is_enabled():
                faulthandler.enable()
        if sigterm and threading.current_thread() is threading.main_thread():
            prev = signal.getsignal(signal.SIGTERM)

            def _on_term(signum, frame):
                try:
                    self.record("signal", signal="SIGTERM")
                    self.dump(dump_path, reason="SIGTERM")
                finally:
                    if callable(prev):
                        prev(signum, frame)
                    else:
                        signal.signal(signal.SIGTERM, signal.SIG_DFL)
                        signal.raise_signal(signal.SIGTERM)

            self._prev_sigterm = prev
            signal.signal(signal.SIGTERM, _on_term)
        self._installed = True
        return True


def thread_stacks():
    """Every live thread's current stack, formatted — the /debug/stacks
    payload (why is the pump wedged / who holds the lock)."""
    import sys
    import traceback
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(tid, '?')} (ident {tid}) ---")
        out.extend(l.rstrip("\n")
                   for l in traceback.format_stack(frame))
    return "\n".join(out)


def _compile_totals():
    """Compile-telemetry rollup embedded in every dump (lazy import:
    the recorder must not pull the kernel builds in just to record
    events)."""
    try:
        from . import compile_telemetry
        return compile_telemetry.REGISTRY.totals()
    except Exception:  # pragma: no cover — partial teardown
        return {}


RECORDER = FlightRecorder()

# module-level conveniences bound to the global recorder
record = RECORDER.record
snapshot = RECORDER.snapshot
dump = RECORDER.dump
install = RECORDER.install
