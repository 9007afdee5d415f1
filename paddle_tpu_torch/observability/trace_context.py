"""Request-scoped trace context (aux subsystem: observability).

A contextvar-propagated trace id + span stack, so every span and
structured event recorded while handling a request carries that
request's identity — across the HTTP handler, the scheduler, and the
engine, without threading an argument through every call site.

Reference: the host tracer's thread-local event chain
(paddle/fluid/platform/profiler's RecordEvent nesting); OpenTelemetry
naming is used deliberately (trace id / span id / parent id) so dumps
read like any other tracing system's.

Thread caveat: `contextvars` do NOT cross thread boundaries on their
own. Objects that hop threads (a ServingRequest moving from the HTTP
handler thread to the scheduler pump) carry their trace id as plain
state and re-`bind()` it where work resumes.

Counterpart of `paddle_tpu/observability/trace_context.py`, carried over as a copy
(the port's host side is the reference's, held to it by the
`tests/test_torch_*.py` parity tests).
"""
from __future__ import annotations

import contextvars
import itertools
import os
import time

__all__ = ["new_trace_id", "current_trace_id", "current_span_id",
           "bind", "span", "Span"]

_trace_id = contextvars.ContextVar("pt_trace_id", default=None)
_span_id = contextvars.ContextVar("pt_span_id", default=None)
_ids = itertools.count(1)


def new_trace_id(prefix="tr"):
    """Process-unique, human-greppable id: <prefix>-<pid>-<seq>."""
    return f"{prefix}-{os.getpid():x}-{next(_ids):06x}"


def new_span_id():
    return f"sp-{next(_ids):06x}"


def current_trace_id():
    return _trace_id.get()


def current_span_id():
    return _span_id.get()


class bind:
    """Bind a trace id for the dynamic extent of a with-block (or via
    explicit .attach()/.detach() when the extent is not lexical, e.g.
    around one request's share of a pump iteration).

    `parent_span` seats an inbound parent span id too, so spans opened
    inside the extent nest under a REMOTE caller's span — this is how
    a cross-host rpc hop keeps one parent/child chain."""

    def __init__(self, trace_id, parent_span=None):
        self.trace_id = trace_id
        self.parent_span = parent_span
        self._token = None
        self._span_token = None

    def attach(self):
        self._token = _trace_id.set(self.trace_id)
        if self.parent_span is not None:
            self._span_token = _span_id.set(self.parent_span)
        return self

    def detach(self):
        if self._span_token is not None:
            _span_id.reset(self._span_token)
            self._span_token = None
        if self._token is not None:
            _trace_id.reset(self._token)
            self._token = None

    def __enter__(self):
        self.attach()
        return self.trace_id

    def __exit__(self, *exc):
        self.detach()
        return False


class Span:
    """One finished span: name + wall-clock placement + identity."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t_start",
                 "dur_s", "args")

    def __init__(self, name, trace_id, span_id, parent_id, t_start,
                 dur_s, args=None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = t_start      # time.time() epoch seconds
        self.dur_s = dur_s
        self.args = args

    def to_dict(self):
        d = {"name": self.name, "trace_id": self.trace_id,
             "span_id": self.span_id, "parent_id": self.parent_id,
             "t_start": self.t_start, "dur_s": self.dur_s}
        if self.args:
            d["args"] = dict(self.args)
        return d


def record_span_event(name, dur_s, *, trace_id=None, t_end=None,
                      args=None, parent_id=None, span_id=None):
    """Record an already-measured span (no with-block) into the sinks:
    the host trace ring (when tracing is enabled) and the flight
    recorder (always; its ring is bounded). Used for phase spans whose
    start/stop straddle threads — e.g. a request's queued/prefill/
    decode phases, assembled from timestamps at finalize time."""
    sp = Span(name, trace_id or current_trace_id(),
              span_id or new_span_id(), parent_id,
              (t_end if t_end is not None else time.time()) - dur_s,
              dur_s, args)
    _emit(sp)
    return sp


def _emit(sp: Span):
    from ..utils import trace as _trace
    if _trace.enabled():
        _trace.record(sp.name, sp.dur_s, None, trace_id=sp.trace_id,
                      span_id=sp.span_id, parent_id=sp.parent_id,
                      args=sp.args, ts_end=sp.t_start + sp.dur_s)
    from . import flight_recorder as _fr
    _fr.record("span", **sp.to_dict())


class span:
    """A live span as a with-block: nests under the current span (the
    parent/child chain rides the contextvar), stamps the current trace
    id, and on exit feeds the trace ring + flight recorder.

        with trace_context.span("scheduler.feed", args={"n": 3}):
            ...
    """

    def __init__(self, name, trace_id=None, args=None):
        self.name = name
        self._explicit_trace = trace_id
        self.args = args
        self.result = None
        self._t0 = None
        self._tok = None

    def __enter__(self):
        self.parent_id = _span_id.get()
        self.span_id = new_span_id()
        self._tok = _span_id.set(self.span_id)
        self._t0 = time.perf_counter()
        self._w0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        _span_id.reset(self._tok)
        args = self.args
        if exc_type is not None:
            args = dict(args or {})
            args["error"] = exc_type.__name__
        self.result = Span(
            self.name, self._explicit_trace or _trace_id.get(),
            self.span_id, self.parent_id, self._w0, dur, args)
        _emit(self.result)
        return False
