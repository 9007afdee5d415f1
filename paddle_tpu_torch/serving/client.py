"""Stdlib HTTP client for the serving frontend (`serving/server.py`).

Token-id in, token-id out — the wire protocol is tokenizer-free, like
the server. Streaming completions iterate Server-Sent-Events as the
engine emits chunks; everything else is one JSON round trip. Responses
carry an OpenAI-style `usage` block (`prompt_tokens`,
`completion_tokens`, `cached_tokens` — the prompt prefix the server's
KV cache served without prefill compute).

Backpressure: a full server queue is HTTP 429 with `Retry-After`
(`BackpressureError.retry_after_s` on the server side). With
`retries=N` (opt-in; default 0 preserves raise-immediately) the client
honors that hint — bounded retries with jittered sleeps — before
surfacing `ServingHTTPError`.

The same bounded budget also retries **connection-level** failures —
refused, reset, or dropped before any response byte arrived
(`ConnectionError`, `http.client.RemoteDisconnected`) — so a rolling
replica restart behind the router is invisible to callers. This is
safe for this protocol because a completion request is idempotent
(deterministic generation for the given parameters) and streams are
only ever retried before the first streamed byte.

Counterpart of `paddle_tpu/serving/client.py`, carried over as a copy
(the port's host side is the reference's, held to it by the
`tests/test_torch_*.py` parity tests).
"""
from __future__ import annotations

import http.client
import json
import random
import time

__all__ = ["ServingClient", "ServingHTTPError"]

# connection-level failures worth retrying: the server never saw the
# request (refused) or dropped it before responding (reset / remote
# disconnected during a restart). ConnectionError covers Refused,
# Reset, Aborted, and BrokenPipe.
_CONN_ERRORS = (ConnectionError, http.client.RemoteDisconnected)


class ServingHTTPError(RuntimeError):
    """Non-2xx response; carries the status, decoded body, and (for
    429) the server's Retry-After hint in seconds."""

    def __init__(self, status, body, retry_after_s=None):
        self.status = status
        self.body = body
        self.retry_after_s = retry_after_s
        msg = body.get("error", body) if isinstance(body, dict) else body
        super().__init__(f"HTTP {status}: {msg}")

    @property
    def retriable(self):
        return self.status in (429, 503)


def _retry_after(resp):
    try:
        v = resp.getheader("Retry-After")
        return float(v) if v is not None else None
    except (TypeError, ValueError):
        return None


class ServingClient:
    def __init__(self, host="127.0.0.1", port=8000, timeout=120.0,
                 retries=0, retry_cap_s=5.0, _rng=None):
        self.host = host
        self.port = port
        self.timeout = timeout
        # opt-in bounded retry on 429 backpressure and Retry-After-
        # carrying 503s (crash-loop breaker); never on bare-503
        # shutdown or 4xx request errors — those don't heal by waiting
        self.retries = int(retries)
        self.retry_cap_s = float(retry_cap_s)
        self._rng = _rng if _rng is not None else random.Random()

    def _request(self, method, path, body=None):
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        headers = {}
        payload = None
        if body is not None:
            payload = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        conn.request(method, path, body=payload, headers=headers)
        return conn, conn.getresponse()

    def _with_retries(self, fn):
        """Run fn(); retry (at most `self.retries` extra times) on 429
        backpressure and on 503s that carry Retry-After (the crash-
        loop breaker: the replica heals on revive, so a single-replica
        deployment is retried instead of surfaced) — sleeping out the
        server's hint, capped and jittered to decorrelate a thundering
        herd — and on connection refused/reset/disconnect with a short
        exponential backoff (a replica restarting behind the router).
        A bare 503 (draining shutdown) and everything else raise
        immediately — those don't heal by waiting."""
        attempt = 0
        while True:
            try:
                return fn()
            except ServingHTTPError as e:
                healing = e.status == 429 or (
                    e.status == 503 and e.retry_after_s is not None)
                if not healing or attempt >= self.retries:
                    raise
                hint = e.retry_after_s if e.retry_after_s is not None \
                    else 1.0
                time.sleep(min(hint, self.retry_cap_s)
                           * (0.5 + self._rng.random()))
                attempt += 1
            except _CONN_ERRORS:
                if attempt >= self.retries:
                    raise
                time.sleep(min(0.05 * (2 ** attempt), self.retry_cap_s)
                           * (0.5 + self._rng.random()))
                attempt += 1

    def _json_call(self, method, path, body=None):
        conn, resp = self._request(method, path, body)
        try:
            data = resp.read()
            try:
                decoded = json.loads(data)
            except json.JSONDecodeError:
                decoded = data.decode(errors="replace")
            if resp.status >= 400:
                raise ServingHTTPError(resp.status, decoded,
                                       retry_after_s=_retry_after(resp))
            return decoded
        finally:
            conn.close()

    # -- endpoints ----------------------------------------------------
    def healthz(self):
        return self._json_call("GET", "/healthz")

    def readyz(self):
        """Readiness probe; raises ServingHTTPError(503) while the
        server is paused or draining (liveness stays 200)."""
        return self._json_call("GET", "/readyz")

    def metrics(self):
        """JSON snapshot of the server's metrics registry."""
        return self._json_call("GET", "/metrics?format=json")

    def debug_requests(self, last=50):
        """Recent terminal requests with their stitched timelines
        (/debug/requests?last=N); behind a router each entry carries
        its `replica` tag."""
        return self._json_call("GET", f"/debug/requests?last={int(last)}")

    def debug_pulse(self, window=None, signals=None):
        """The pulse plane's ring time-series (/debug/pulse): windowed
        to the last `window` seconds, filtered to signal-name prefixes
        in `signals`; behind a router one payload per replica."""
        q = []
        if window is not None:
            q.append(f"window={int(window)}")
        if signals:
            q.append("signals=" + ",".join(signals))
        return self._json_call(
            "GET", "/debug/pulse" + ("?" + "&".join(q) if q else ""))

    def metrics_text(self):
        """Prometheus text exposition."""
        conn, resp = self._request("GET", "/metrics")
        try:
            body = resp.read().decode()
            if resp.status >= 400:
                raise ServingHTTPError(resp.status, body)
            return body
        finally:
            conn.close()

    def complete(self, prompt_ids, **params):
        """Blocking completion; returns the response dict
        ({"tokens": [...], "state": ..., "usage": {...}, ...})."""
        body = dict(params, prompt=list(map(int, prompt_ids)),
                    stream=False)
        return self._with_retries(
            lambda: self._json_call("POST", "/v1/completions", body))

    def stream_complete(self, prompt_ids, **params):
        """Generator of SSE event dicts: token chunks as
        {"tokens": [...]}, then a final {"done": true, ...} event
        carrying the usage block. 429 retries happen before the first
        byte is yielded (a stream, once started, is never replayed)."""
        body = dict(params, prompt=list(map(int, prompt_ids)),
                    stream=True)

        def _open():
            conn, resp = self._request("POST", "/v1/completions", body)
            if resp.status >= 400:
                try:
                    data = resp.read()
                    try:
                        decoded = json.loads(data)
                    except json.JSONDecodeError:
                        decoded = data.decode(errors="replace")
                    raise ServingHTTPError(
                        resp.status, decoded,
                        retry_after_s=_retry_after(resp))
                finally:
                    conn.close()
            return conn, resp

        conn, resp = self._with_retries(_open)
        try:
            # http.client undoes the chunked framing; reassemble SSE
            # events (data: <json>\n\n) line by line
            for line in resp:
                line = line.strip()
                if line.startswith(b"data: "):
                    yield json.loads(line[len(b"data: "):])
        finally:
            conn.close()
