"""The span ring (counterpart of `paddle_tpu/utils/trace.py`): a
host-side event ring that `observability.trace_context` emits into.
Enable with PADDLE_TPU_TRACE=1 or trace.enable().

Events carry optional span identity (trace_id/span_id/parent_id) so a
chrome export groups a request's spans on one row.
"""
from __future__ import annotations

import collections
import os
import time
from typing import NamedTuple

_RING = collections.deque(maxlen=100_000)
_ENABLED = os.environ.get("PADDLE_TPU_TRACE", "0") == "1"


class TraceEvent(NamedTuple):
    name: str
    dur: float                  # seconds
    shape: object               # op result shape, or None
    ts_end: float               # time.time() at completion
    trace_id: object = None
    span_id: object = None
    parent_id: object = None
    args: object = None


def enable():
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def enabled():
    return _ENABLED


def record(name, dur_s, shape=None, *, trace_id=None, span_id=None,
           parent_id=None, args=None, ts_end=None):
    _RING.append(TraceEvent(name, dur_s, shape,
                            time.time() if ts_end is None else ts_end,
                            trace_id, span_id, parent_id, args))


def clear():
    _RING.clear()


def events():
    return list(_RING)


def summary(top=30):
    agg = {}
    for ev in _RING:
        tot, cnt = agg.get(ev.name, (0.0, 0))
        agg[ev.name] = (tot + ev.dur, cnt + 1)
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    lines = [f"{'op':<32}{'calls':>8}{'total_ms':>12}{'avg_us':>12}"]
    for name, (tot, cnt) in rows:
        lines.append(f"{name:<32}{cnt:>8}{tot*1e3:>12.3f}{tot/cnt*1e6:>12.1f}")
    return "\n".join(lines) if rows else "trace ring empty (PADDLE_TPU_TRACE=1)"
