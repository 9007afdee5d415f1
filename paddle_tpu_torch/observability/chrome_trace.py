"""chrome://tracing export of span events (aux: observability).

Builds a Trace Event Format document from span dicts (the flight
recorder's `kind == "span"` events, or `utils.trace` ring entries via
`Profiler.export`). Each trace id gets its own named row (tid) so a
request's queued → prefill → decode phases line up on one timeline,
and flow events ("s"/"f") stitch the phases of one trace together
visually even when the spans were recorded from different threads.

Counterpart of `paddle_tpu/observability/chrome_trace.py`, carried over as a copy
(the port's host side is the reference's, held to it by the
`tests/test_torch_*.py` parity tests).
"""
from __future__ import annotations

import json
import zlib

__all__ = ["chrome_trace_doc", "from_flight_recorder"]

_UNTRACED_TID = 0


def _flow_id(trace_id):
    return zlib.crc32(trace_id.encode()) & 0x7FFFFFFF


def chrome_trace_doc(spans, pid=0):
    """spans: iterables of dicts with name/t_start/dur_s and optional
    trace_id/span_id/parent_id/args. Returns the chrome-tracing
    document (dict) — `json.dump` it."""
    events = []
    tids = {}                       # trace_id -> row
    per_trace = {}                  # trace_id -> [event index]
    for sp in spans:
        trace_id = sp.get("trace_id")
        if trace_id is None:
            tid = _UNTRACED_TID
        else:
            tid = tids.setdefault(trace_id, len(tids) + 1)
        args = dict(sp.get("args") or {})
        for k in ("trace_id", "span_id", "parent_id"):
            if sp.get(k) is not None:
                args[k] = sp[k]
        ev = {"name": sp["name"], "ph": "X", "pid": pid, "tid": tid,
              "ts": sp["t_start"] * 1e6, "dur": sp["dur_s"] * 1e6}
        if args:
            ev["args"] = args
        if trace_id is not None:
            per_trace.setdefault(trace_id, []).append(len(events))
        events.append(ev)
    # rows named after their trace id; row 0 is the untraced pool
    meta = [{"name": "thread_name", "ph": "M", "pid": pid,
             "tid": _UNTRACED_TID, "args": {"name": "untraced"}}]
    for trace_id, tid in tids.items():
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": f"trace {trace_id}"}})
    # flows: chain each trace's spans in start order
    flows = []
    for trace_id, idxs in per_trace.items():
        if len(idxs) < 2:
            continue
        idxs = sorted(idxs, key=lambda i: events[i]["ts"])
        fid = _flow_id(trace_id)
        first = events[idxs[0]]
        flows.append({"name": "trace", "cat": "flow", "ph": "s",
                      "id": fid, "pid": pid, "tid": first["tid"],
                      "ts": first["ts"] + first.get("dur", 0) / 2})
        for i in idxs[1:]:
            e = events[i]
            flows.append({"name": "trace", "cat": "flow", "ph": "f",
                          "bp": "e", "id": fid, "pid": pid,
                          "tid": e["tid"],
                          "ts": e["ts"] + e.get("dur", 0) / 2})
    return {"traceEvents": meta + events + flows,
            "displayTimeUnit": "ms"}


def from_flight_recorder(recorder=None):
    """Chrome-tracing doc of every span currently in the flight
    recorder (the `/debug/trace` payload)."""
    if recorder is None:
        from . import flight_recorder as _fr
        recorder = _fr.RECORDER
    return chrome_trace_doc(recorder.events(kind="span"))


def dump_chrome_trace(path, recorder=None):
    doc = from_flight_recorder(recorder)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
