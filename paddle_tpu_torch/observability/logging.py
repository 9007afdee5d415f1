"""Structured JSON logging with rate limiting (aux: observability).

One event = one JSON line: `{"ts": ..., "logger": ..., "event": ...,
**fields}`. Every event also lands in the flight recorder (bounded
ring — always safe), while the *stream* emission is rate-limited per
event type so a hot loop (the serving pump logs every step) cannot
drown a terminal or a log shipper. Dropped-line counts are carried on
the next emitted line of that type, so the suppression is visible.

Streams: by default events go only to the flight recorder; set
PADDLE_TPU_LOG=1 to emit to stderr, PADDLE_TPU_LOG_FILE=<path> to
emit to a file, or pass an explicit `stream` (tests hand a StringIO).

Counterpart of `paddle_tpu/observability/logging.py`, carried over as a copy
(the port's host side is the reference's, held to it by the
`tests/test_torch_*.py` parity tests).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

from .._env import env_str

__all__ = ["StructuredLogger", "RateLimiter", "get_logger"]


class RateLimiter:
    """Token bucket per key: `allow(key)` spends one token; buckets
    refill at `rate_per_s` up to `burst`."""

    def __init__(self, rate_per_s=20.0, burst=40):
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._lock = threading.Lock()
        self._state = {}            # key -> [tokens, last_ts]

    def allow(self, key, now=None):
        if self.rate <= 0:
            return True
        now = time.monotonic() if now is None else now
        with self._lock:
            tokens, last = self._state.get(key, (self.burst, now))
            tokens = min(self.burst, tokens + (now - last) * self.rate)
            ok = tokens >= 1.0
            if ok:
                tokens -= 1.0
            self._state[key] = (tokens, now)
            return ok


def _default_stream():
    path = env_str("PADDLE_TPU_LOG_FILE")
    if path:
        return open(path, "a", buffering=1)
    if env_str("PADDLE_TPU_LOG", "0") == "1":
        return sys.stderr
    return None


class StructuredLogger:
    def __init__(self, name, stream="auto", rate_per_s=20.0, burst=40,
                 recorder=None):
        self.name = name
        self.stream = _default_stream() if stream == "auto" else stream
        self._limiter = RateLimiter(rate_per_s, burst)
        self._lock = threading.Lock()
        self._dropped = {}          # event type -> suppressed count
        if recorder is None:
            from . import flight_recorder as _fr
            recorder = _fr.RECORDER
        self._recorder = recorder

    def event(self, event, level="info", **fields):
        """Emit one structured event. Returns True when the line
        reached the stream (False: no stream, or rate-limited —
        either way the flight recorder got it)."""
        self._recorder.record("log", event=event, level=level,
                              logger=self.name, **fields)
        if self.stream is None:
            return False
        if not self._limiter.allow(event):
            with self._lock:
                self._dropped[event] = self._dropped.get(event, 0) + 1
            return False
        rec = {"ts": round(time.time(), 6), "logger": self.name,
               "level": level, "event": event}
        rec.update(fields)
        with self._lock:
            dropped = self._dropped.pop(event, 0)
            if dropped:
                rec["rate_limited_dropped"] = dropped
            line = json.dumps(rec, default=str)
            try:
                self.stream.write(line + "\n")
            except Exception:       # a dead log pipe must not kill serving
                return False
        return True


_loggers = {}
_loggers_lock = threading.Lock()


def get_logger(name, **kwargs):
    """Process-wide logger cache; kwargs only apply on first creation."""
    with _loggers_lock:
        lg = _loggers.get(name)
        if lg is None:
            lg = _loggers[name] = StructuredLogger(name, **kwargs)
        return lg
