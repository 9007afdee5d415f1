"""Stdlib-only HTTP frontend for the serving runtime.

`ServingServer` mounts a `RequestScheduler` behind a
`ThreadingHTTPServer` (one thread per connection — the engine itself
stays single-threaded behind the scheduler's pump):

  * `POST /v1/completions` — JSON body; `"stream": true` streams
    Server-Sent-Events over chunked transfer, one event per emitted
    token chunk; an `X-Request-Id` header (or generated id) becomes
    the request's trace id, echoed back and stamped on every span;
  * `GET /healthz` — liveness + queue/occupancy snapshot;
  * `GET /readyz` — readiness: 503 while paused or draining, so the
    router (or any external LB) takes the replica out of rotation
    before shutdown; liveness above stays 200 throughout;
  * `GET /metrics` — Prometheus text exposition, serving registry +
    compile telemetry + device telemetry (`pt_mfu`, `pt_device_*`) +
    training health (`?format=json` returns the JSON snapshot);
  * `GET /debug/flightrecorder` — JSON dump of the crash flight
    recorder ring (`?dump=1` also writes it to disk);
  * `GET /debug/trace` — chrome://tracing JSON of recent spans, one
    named row per request id;
  * `GET /debug/pulse` — the telemetry pulse plane's ring time-series
    (`?window=` seconds, `?signals=` name-prefix filter); `?stream=1`
    switches to a Server-Sent-Events live feed (one payload per
    sample interval, `?count=N` to stop after N events) — the feed
    `tools/ptop.py` renders;
  * `GET /debug/fleet/trace` — fleet mode: ONE chrome trace merging
    router + every worker process, remote timestamps rebased by the
    per-worker clock-offset estimate, flow arrows stitching each
    request's spans across processes (404 without a FleetPlane);
  * `GET /debug/fleet/flightrecorder` — fleet mode: every process's
    flight ring in one document, per-host sections plus one merged
    skew-corrected stream (404 without a FleetPlane);
  * `GET /debug/stacks` — every live thread's Python stack (who is
    holding the pump / a lock right now).

Malformed numeric query values (`last=`/`window=`/`dump=`/...) are a
400, never a handler-thread traceback.

Backpressure maps to HTTP: a full queue is 429 with Retry-After,
shutdown is 503, a request the engine can never run is 400, a
deadline that expires before the first token is 504.

Everything runs under `JAX_PLATFORMS=cpu` too, so an in-process test
can drive a real server end-to-end without a chip.

Counterpart of `paddle_tpu/serving/server.py`, carried over as a copy
(the port's host side is the reference's, held to it by the
`tests/test_torch_*.py` parity tests).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .._env import env_bool, env_float
from ..observability import chrome_trace as _chrome
from ..observability import compile_telemetry as _compile
from ..observability import device_telemetry as _devtel
from ..observability import flight_recorder as _flight
from ..observability import health as _health
from ..observability import trace_context as _tc
from .router import Router
from .scheduler import (BackpressureError, RequestScheduler,
                        SchedulerClosedError)

__all__ = ["ServingServer", "CompletionHandler", "METRIC_NAMES"]

# The metric families `/metrics` renders (their `# TYPE` names), in
# order: the serving registry, then the compile, device and health
# telemetry. They are the reference's, which tests/test_torch_runtime.py
# holds this list to; `chip_smoke.py` checks each on the card. On the
# CPU the port leaves out `pt_mfu` and `pt_mfu_peak` (no step is
# costed there); a card adds `pt_device_bytes_in_use` and its peers.
METRIC_NAMES = (
    "pt_engine_restart_seconds", "pt_engine_restarts", "pt_goodput_tokens",
    "pt_handoff_bytes", "pt_handoff_exports", "pt_handoff_failures",
    "pt_handoff_imports", "pt_handoff_seconds", "pt_logit_rows",
    "pt_logit_rows_skipped", "pt_pad_tokens", "pt_phase_decode_seconds",
    "pt_phase_handoff_seconds", "pt_phase_preempted_seconds",
    "pt_phase_prefill_seconds", "pt_phase_queued_seconds",
    "pt_pipeline_depth", "pt_poison_quarantined", "pt_prefix_cached_pages",
    "pt_prefix_evictions", "pt_prefix_hit_rate", "pt_prefix_hits",
    "pt_prefix_lookups", "pt_prefix_tier_copy_errors", "pt_prefix_tier_drops",
    "pt_prefix_tier_hits", "pt_prefix_tier_restores", "pt_prefix_tier_spills",
    "pt_prefix_tokens_reused", "pt_process_start_time_seconds",
    "pt_ragged_tokens", "pt_requests_requeued", "pt_scrape_self_seconds",
    "pt_serving_active_requests", "pt_serving_batch_occupancy",
    "pt_serving_device_steps", "pt_serving_e2e_seconds",
    "pt_serving_generated_tokens", "pt_serving_kv_pages_free",
    "pt_serving_kv_pages_total", "pt_serving_page_allocs",
    "pt_serving_preemptions", "pt_serving_prefill_tokens",
    "pt_serving_queue_depth", "pt_serving_queue_depth_peak",
    "pt_serving_queue_depth_priority", "pt_serving_requests_accepted",
    "pt_serving_requests_cancelled", "pt_serving_requests_completed",
    "pt_serving_requests_expired", "pt_serving_requests_failed",
    "pt_serving_requests_rejected", "pt_serving_requests_started",
    "pt_serving_slots", "pt_serving_step_seconds", "pt_serving_tpot_seconds",
    "pt_serving_ttft_seconds", "pt_step_anomalies",
    "pt_step_host_gap_seconds", "pt_tier_host_bytes", "pt_tier_pages",
    "pt_tokens", "pt_compile_total", "pt_compile_retraces_total",
    "pt_compile_seconds_total", "pt_compile_cache_hits_total",
    "pt_compile_fn_total", "pt_compile_fn_retraces_total",
    "pt_compile_fn_seconds_total", "pt_mfu", "pt_mfu_peak", "pt_step_flops",
    "pt_step_bytes", "pt_roofline_intensity", "pt_roofline_ridge",
    "pt_peak_flops_per_s", "pt_peak_hbm_bytes_per_s", "pt_fn_flops",
    "pt_fn_bytes_accessed", "pt_fn_hbm_bytes", "pt_fn_flops_issued_total",
    "pt_device_live_bytes", "pt_device_live_arrays",
    "pt_device_live_peak_bytes", "pt_train_nonfinite_total",
    "pt_train_nonfinite_values_total", "pt_amp_found_inf_total",
)


class _BadQuery(ValueError):
    """A malformed /debug/* query value — mapped to HTTP 400."""


class CompletionHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "paddle-tpu-serving/0.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    @property
    def sched(self) -> RequestScheduler:
        return self.server.scheduler

    # -- helpers ------------------------------------------------------
    def _json(self, code, obj, headers=()):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _chunk(self, data: bytes):
        self.wfile.write(b"%X\r\n" % len(data) + data + b"\r\n")

    def _event(self, obj):
        self._chunk(b"data: " + json.dumps(obj).encode() + b"\n\n")
        self.wfile.flush()

    @staticmethod
    def _query_params(query):
        params = {}
        for part in query.split("&"):
            if part:
                k, _, v = part.partition("=")
                params[k] = v
        return params

    @staticmethod
    def _query_int(params, key, default=None):
        """Integer query value or `default`; a non-integer value is a
        _BadQuery (HTTP 400), never a handler-thread ValueError."""
        v = params.get(key)
        if v is None or v == "":
            return default
        try:
            return int(v)
        except ValueError:
            raise _BadQuery(
                f"query parameter {key}={v!r}: want an integer") \
                from None

    # -- routes -------------------------------------------------------
    def do_GET(self):
        try:
            self._route_get()
        except _BadQuery as e:
            self._json(400, {"error": f"bad request: {e}"})

    def _route_get(self):
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            st = self.sched.stats()
            st["status"] = "draining" if st.pop("closed") else "ok"
            self._json(200, st)
        elif path == "/readyz":
            # readiness ≠ liveness: a paused or draining scheduler is
            # alive (healthz 200) but must stop receiving traffic
            ready, detail = self.sched.readiness()
            self._json(200 if ready else 503,
                       {"ready": ready, "detail": detail})
        elif path == "/metrics":
            if "format=json" in query:
                snap = self.sched.metrics_snapshot()
                snap["pt_compile"] = _compile.snapshot()
                snap["pt_device"] = _devtel.snapshot()
                snap["pt_health"] = _health.snapshot()
                self._json(200, snap)
            else:
                # scrape-cadence device telemetry: render_prometheus
                # polls the memory accountant (live-array walk) here,
                # on the HTTP thread — never on the pump's step path.
                # A mounted Router aggregates every replica's registry
                # with replica="<id>" labels behind the same method
                body = (self.sched.render_prometheus()
                        + _compile.render_prometheus()
                        + _devtel.render_prometheus()
                        + _health.render_prometheus()).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
        elif path == "/debug/flightrecorder":
            snap = _flight.snapshot()
            if self._query_int(self._query_params(query), "dump", 0):
                snap["path"] = _flight.dump(reason="/debug/flightrecorder")
            self._json(200, snap)
        elif path == "/debug/trace":
            self._json(200, _chrome.from_flight_recorder())
        elif path == "/debug/requests":
            # recent terminal requests with their stitched timelines;
            # a mounted Router aggregates across replicas (each entry
            # tagged replica="<id>") behind the same duck-typed method
            last = self._query_int(self._query_params(query), "last", 50)
            self._json(200,
                       {"requests": self.sched.recent_requests(last)})
        elif path == "/debug/pulse":
            # pulse plane: windowed ring time-series (JSON), or an SSE
            # live feed with ?stream=1 (one payload per interval);
            # a mounted Router nests per-replica payloads
            params = self._query_params(query)
            window = self._query_int(params, "window")
            signals = [s for s in
                       (params.get("signals") or "").split(",") if s] \
                or None
            if self._query_int(params, "stream", 0):
                self._pulse_stream(window, signals,
                                   self._query_int(params, "count"))
            else:
                self._json(200, self.sched.pulse(window=window,
                                                 signals=signals))
        elif path == "/debug/fleet/trace":
            # fleet mode only: one merged, skew-corrected chrome trace
            # across router + every worker process. Duck-typed off the
            # mounted scheduler (a Router with a FleetPlane attached);
            # anything else is a 404, same as an unknown route
            fn = getattr(self.sched, "fleet_trace", None)
            doc = fn() if fn is not None else None
            if doc is None:
                self._json(404, {"error": "no fleet plane attached"})
            else:
                self._json(200, doc)
        elif path == "/debug/fleet/flightrecorder":
            fn = getattr(self.sched, "fleet_flightrecorder", None)
            doc = fn() if fn is not None else None
            if doc is None:
                self._json(404, {"error": "no fleet plane attached"})
            else:
                self._json(200, doc)
        elif path == "/debug/stacks":
            body = _flight.thread_stacks().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._json(404, {"error": f"no route {path!r}"})

    def _pulse_stream(self, window, signals, count):
        """SSE live feed of the pulse plane: one full windowed payload
        per sample interval (`ptop --stream` replaces its frame with
        each event). `count=N` closes after N events — how tests and
        one-shot captures bound the stream."""
        sched = self.sched
        plane = getattr(sched, "_pulse", None)
        interval = plane.interval_s if plane is not None \
            else env_float("PT_PULSE_INTERVAL_S")
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        sent = 0
        try:
            while True:
                self._event(sched.pulse(window=window, signals=signals))
                sent += 1
                if count is not None and sent >= count:
                    break
                time.sleep(interval)
            self._chunk(b"")        # terminating zero-length chunk
        except (BrokenPipeError, ConnectionResetError):
            # dashboard went away: stop streaming to it
            self.close_connection = True

    def do_POST(self):
        if self.path.partition("?")[0] != "/v1/completions":
            self._json(404, {"error": f"no route {self.path!r}"})
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(n) or b"{}")
            prompt = body["prompt"]
            if not isinstance(prompt, list) or \
                    not all(isinstance(t, int) for t in prompt):
                raise ValueError(
                    "prompt must be a list of token ids (ints); this "
                    "server is tokenizer-free")
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            self._json(400, {"error": f"bad request: {e}"})
            return
        stream = bool(body.get("stream", False))
        # request-scoped trace id: honor the client's X-Request-Id so
        # its spans correlate with the caller's own tracing; otherwise
        # mint one. Echoed back on every response.
        trace_id = self.headers.get("X-Request-Id") or _tc.new_trace_id("req")
        try:
            with _tc.bind(trace_id):
                sr = self.sched.submit(
                    prompt,
                    max_new_tokens=int(body.get("max_tokens", 16)),
                    eos_id=body.get("eos_id"),
                    temperature=float(body.get("temperature", 0.0)),
                    top_k=int(body.get("top_k", 0)),
                    top_p=float(body.get("top_p", 1.0)),
                    seed=body.get("seed"),
                    logprobs=bool(body.get("logprobs", False)),
                    priority=body.get("priority", "normal"),
                    slo=body.get("slo"),
                    ttl_s=body.get("ttl_s"),
                    trace_id=trace_id)
        except BackpressureError as e:
            self._json(429, {"error": str(e)},
                       headers=(("Retry-After",
                                 str(max(int(e.retry_after_s), 1))),))
            return
        except SchedulerClosedError as e:
            # a crash-loop breaker's 503 carries Retry-After (the
            # replica heals on revive); a draining shutdown does not
            ra = getattr(e, "retry_after_s", None)
            self._json(503, {"error": str(e)},
                       headers=() if ra is None else
                       (("Retry-After", str(max(int(ra), 1))),))
            return
        except (TypeError, ValueError) as e:
            self._json(400, {"error": str(e)})
            return
        if stream:
            self._stream(sr)
        else:
            self._blocking(sr)

    def _final(self, sr):
        out = {"id": sr.rid, "state": sr.state,
               "tokens": sr.output, "n": len(sr.req.output),
               "trace_id": sr.trace_id,
               # OpenAI-style usage block; cached_tokens is the prompt
               # prefix served from the KV cache instead of prefill
               "usage": {
                   "prompt_tokens": len(sr.req.prompt),
                   "completion_tokens": len(sr.req.output),
                   "cached_tokens":
                       int(getattr(sr.req, "cached_tokens", 0) or 0)}}
        if sr.req.logprobs is not None:
            out["logprobs"] = sr.req.logprobs
        if env_bool("PT_SERVE_TIMING"):
            tl = getattr(sr, "timeline", None)
            if tl is not None and tl.marks:
                out["timing"] = {
                    "e2e_s": round(tl.elapsed(), 6),
                    "ttft_s": (None if tl.ttft() is None
                               else round(tl.ttft(), 6)),
                    "phases": {k: round(v, 6)
                               for k, v in tl.phases().items()},
                    "slo": getattr(sr, "slo", None),
                    "slo_attained": getattr(sr, "slo_attained", None),
                    "violated_phase": getattr(sr, "violated_phase",
                                              None)}
        return out

    def _blocking(self, sr):
        hdrs = (("X-Request-Id", sr.trace_id),)
        try:
            sr.result()
        except Exception:  # terminal state carries the story
            pass
        if sr.state == "expired" and not sr.req.output:
            self._json(504, {"error": str(sr.error), "id": sr.rid,
                             "state": "expired"}, headers=hdrs)
            return
        if sr.state == "failed":
            self._json(500, {"error": str(sr.error), "id": sr.rid,
                             "state": "failed"}, headers=hdrs)
            return
        self._json(200, self._final(sr), headers=hdrs)

    def _stream(self, sr):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("X-Request-Id", sr.trace_id)
        self.end_headers()
        try:
            try:
                for chunk in sr.stream():
                    self._event({"id": sr.rid, "tokens": chunk})
            except Exception as e:  # deadline/engine failure mid-stream
                self._event({"id": sr.rid, "error": str(e),
                             "state": sr.state, "done": True})
            else:
                self._event(dict(self._final(sr), done=True))
            self._chunk(b"")        # terminating zero-length chunk
        except (BrokenPipeError, ConnectionResetError):
            # client went away: stop paying for its tokens
            sr.cancel()
            self.close_connection = True


class ServingServer:
    """Own the scheduler + HTTP listener pair.

    Accepts a ready-made RequestScheduler, a `Router` (scale-out mode:
    the same HTTP surface fans across its replica pool, /metrics
    aggregates per-replica series), or a bare ServingEngine (wrapped
    with `max_queue`). `port=0` binds an ephemeral port — read it back
    from `.port` (how the tests run hermetically)."""

    def __init__(self, engine_or_scheduler, host="127.0.0.1", port=8000,
                 max_queue=64):
        if isinstance(engine_or_scheduler, (RequestScheduler, Router)):
            self.scheduler = engine_or_scheduler
        else:
            self.scheduler = RequestScheduler(engine_or_scheduler,
                                              max_queue=max_queue)
        self.httpd = ThreadingHTTPServer((host, port), CompletionHandler)
        self.httpd.daemon_threads = True
        self.httpd.scheduler = self.scheduler
        self._thread = None

    @property
    def host(self):
        return self.httpd.server_address[0]

    @property
    def port(self):
        return self.httpd.server_address[1]

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def start(self):
        # crash evidence: SIGTERM dumps the flight-recorder ring,
        # faulthandler prints all stacks on a hard fault (idempotent;
        # signal part is skipped off the main thread)
        _flight.install()
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            name="pt-serving-http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self.httpd.serve_forever()

    def stop(self, drain=True, timeout=None):
        """Graceful stop: close admissions and drain (or cancel)
        in-flight work first, so streaming responses complete; then
        tear down the listener. Returns True if the pump exited."""
        done = self.scheduler.shutdown(drain=drain, timeout=timeout)
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        return done

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
