"""Fleet observability (counterpart of
`paddle_tpu/observability/fleet_obs.py`, carried over as a copy).

The fleet plane (`serving/fleet.py`) runs one serving process per
host; every observability surface below it — trace context, flight
recorder, chrome traces, pulse rings — is strictly per-process. This
module holds the pure, transport-free pieces that turn those
per-process artifacts into ONE fleet-wide story on the rank-0 router:

  * `ClockSkewEstimator` — NTP-style per-peer offset estimation from
    the `(t_send, t_remote, t_recv)` triples every rpc round trip
    yields for free (`RpcAgent.on_clock_sample`). The raw offset of
    one exchange is `t_remote - (t_send + t_recv)/2`; its uncertainty
    is half the round trip net of the server's hold time. Offsets are
    EWMA-smoothed (`PT_FLEET_CLOCK_ALPHA`) so a single congested
    round trip cannot yank the timeline, and `rebase()` maps any
    remote wall-clock stamp onto the router's clock.
  * `stitch_fleet_trace` — merge per-process span sections into one
    chrome-tracing document: one process row (`pid`) per
    `replica@host` section, every remote timestamp skew-corrected
    through the section's offset, and flow arrows chaining each trace
    id's spans ACROSS processes in corrected start order — the
    request's rpc hop becomes a visible arrow instead of two
    unrelated rows.
  * `merge_flight_sections` — the `/debug/fleet/flightrecorder`
    payload: per-host flight-recorder sections plus one merged,
    skew-corrected chronological event list (`ts_fleet` on every
    event names the router-clock time).
  * `write_fleet_bundle` — one fleet capture bundle directory: a
    top-level `meta.json` (trigger, trace ids, per-peer clock
    offsets, roster) plus one subdirectory per host holding that
    worker's flight dump, pulse window, and request ring.

Pure stdlib, no sockets, no serving imports — the fleet plane feeds
sections in; everything here is arithmetic and JSON shaping, so it
unit-tests without a fleet.
"""
from __future__ import annotations

import json
import os
import threading
import time
import zlib

from .._env import env_float

__all__ = ["ClockSkewEstimator", "stitch_fleet_trace",
           "merge_flight_sections", "write_fleet_bundle"]


class ClockSkewEstimator:
    """EWMA-smoothed per-peer clock offset, fed one rpc round trip at
    a time. Thread-safe: samples arrive from whatever threads issue
    rpc calls (the heartbeat/obs pollers, scrape threads, dispatch).

    Sign convention: `offset(peer)` is how far the PEER's wall clock
    runs ahead of ours, so `rebase(peer, t_remote)` = `t_remote -
    offset(peer)` places a remote stamp on the local timeline.
    """

    def __init__(self, alpha=None):
        self.alpha = float(alpha if alpha is not None
                           else env_float("PT_FLEET_CLOCK_ALPHA"))
        self._lock = threading.Lock()
        self._peers = {}   # peer -> {"offset_s", "uncertainty_s", "samples"}

    def sample(self, peer, t_send, t_remote, t_recv, hold_s=0.0):
        """Fold one exchange into the estimate. `t_send`/`t_recv` are
        local wall stamps bracketing the round trip; `t_remote` the
        peer's wall stamp while it held the request; `hold_s` how long
        the peer held it (subtracted from the uncertainty bound).
        Returns the smoothed (offset_s, uncertainty_s)."""
        raw = float(t_remote) - (float(t_send) + float(t_recv)) / 2.0
        unc = max(float(t_recv) - float(t_send) - float(hold_s), 0.0) / 2.0
        a = self.alpha
        with self._lock:
            st = self._peers.get(peer)
            if st is None:
                st = {"offset_s": raw, "uncertainty_s": unc, "samples": 0}
                self._peers[peer] = st
            else:
                st["offset_s"] += a * (raw - st["offset_s"])
                st["uncertainty_s"] += a * (unc - st["uncertainty_s"])
            st["samples"] += 1
            return st["offset_s"], st["uncertainty_s"]

    def offset(self, peer):
        """Smoothed offset in seconds; 0.0 for a never-sampled peer
        (an uncorrected merge beats a refused one)."""
        with self._lock:
            st = self._peers.get(peer)
            return float(st["offset_s"]) if st else 0.0

    def uncertainty(self, peer):
        with self._lock:
            st = self._peers.get(peer)
            return float(st["uncertainty_s"]) if st else 0.0

    def rebase(self, peer, t):
        """A remote wall-clock stamp, expressed on the local clock."""
        return float(t) - self.offset(peer)

    def snapshot(self):
        with self._lock:
            return {p: dict(st) for p, st in self._peers.items()}


# ---------------------------------------------------------------------------
# cross-host trace stitching


def _flow_id(trace_id):
    return zlib.crc32(str(trace_id).encode()) & 0x7FFFFFFF


def stitch_fleet_trace(sections):
    """Merge per-process span sections into one chrome-tracing doc.

    `sections` is a list of dicts:

        {"label": "router" | "r0@hostA", "offset_s": 0.0,
         "spans": [span dicts (name/t_start/dur_s/trace_id/...)]}

    Each section becomes its own process row (pid = section index,
    process_name = label); inside a section each trace id gets a named
    thread row (row 0 = untraced). Every timestamp is rebased by the
    section's `offset_s` BEFORE merging, so one trace's spans order
    correctly across hosts with skewed clocks, and flow arrows chain
    each trace id's spans across all sections in corrected start
    order."""
    events = []
    meta = []
    per_trace = {}                  # trace_id -> [event index]
    for pid, sec in enumerate(sections):
        label = str(sec.get("label") or f"section{pid}")
        off = float(sec.get("offset_s") or 0.0)
        args = {"name": label}
        if sec.get("offset_s") is not None:
            args["clock_offset_s"] = off
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": args})
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": "untraced"}})
        tids = {}
        for sp in sec.get("spans") or []:
            trace_id = sp.get("trace_id")
            if trace_id is None:
                tid = 0
            else:
                tid = tids.get(trace_id)
                if tid is None:
                    tid = len(tids) + 1
                    tids[trace_id] = tid
                    meta.append({"name": "thread_name", "ph": "M",
                                 "pid": pid, "tid": tid,
                                 "args": {"name": f"trace {trace_id}"}})
            ev_args = dict(sp.get("args") or {})
            for k in ("trace_id", "span_id", "parent_id"):
                if sp.get(k) is not None:
                    ev_args[k] = sp[k]
            ev_args["section"] = label
            ev = {"name": sp["name"], "ph": "X", "pid": pid, "tid": tid,
                  "ts": (float(sp["t_start"]) - off) * 1e6,
                  "dur": float(sp["dur_s"]) * 1e6,
                  "args": ev_args}
            if trace_id is not None:
                per_trace.setdefault(trace_id, []).append(len(events))
            events.append(ev)
    # flows: one chain per trace id across ALL processes, in
    # skew-corrected start order — the rpc/bulk hop rendered as arrows.
    # Anchored at span STARTS (a start ts is inside its slice, so the
    # viewer still binds it): phase spans nest (request.queued encloses
    # prefill/decode), and a midpoint anchor would run a chain backward
    # through an enclosing span, breaking the monotone ordering the
    # corrected start sort establishes.
    flows = []
    for trace_id, idxs in per_trace.items():
        if len(idxs) < 2:
            continue
        idxs = sorted(idxs, key=lambda i: events[i]["ts"])
        fid = _flow_id(trace_id)
        first = events[idxs[0]]
        flows.append({"name": "trace", "cat": "fleet", "ph": "s",
                      "id": fid, "pid": first["pid"],
                      "tid": first["tid"], "ts": first["ts"]})
        for i in idxs[1:]:
            e = events[i]
            flows.append({"name": "trace", "cat": "fleet", "ph": "f",
                          "bp": "e", "id": fid, "pid": e["pid"],
                          "tid": e["tid"], "ts": e["ts"]})
    return {"traceEvents": meta + events + flows,
            "displayTimeUnit": "ms",
            "fleet": {"sections": [str(s.get("label")) for s in sections]}}


# ---------------------------------------------------------------------------
# merged flight-recorder dump


def merge_flight_sections(sections):
    """The `/debug/fleet/flightrecorder` payload: each section's full
    flight snapshot under its label, plus one merged chronological
    event list where every event carries its `source` label and a
    skew-corrected `ts_fleet` (router-clock seconds).

    `sections`: [{"label", "offset_s", "uncertainty_s", "flight":
    <flight_recorder snapshot>}]."""
    out_sections = {}
    merged = []
    for sec in sections:
        label = str(sec.get("label") or "?")
        off = float(sec.get("offset_s") or 0.0)
        flight = sec.get("flight") or {}
        out_sections[label] = {
            "offset_s": off,
            "uncertainty_s": float(sec.get("uncertainty_s") or 0.0),
            "pid": flight.get("pid"),
            "dropped": flight.get("dropped", 0),
            "events": flight.get("events") or [],
        }
        for ev in flight.get("events") or []:
            e = dict(ev)
            e["source"] = label
            e["ts_fleet"] = float(ev.get("ts", 0.0)) - off
            merged.append(e)
    merged.sort(key=lambda e: e["ts_fleet"])
    return {"fleet": True, "merged_at": time.time(),
            "sections": out_sections, "events": merged}


# ---------------------------------------------------------------------------
# fleet capture bundles


def _safe_label(label):
    return "".join(c if c.isalnum() or c in "@-_." else "_"
                   for c in str(label)) or "section"


def _write_json(path, doc):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def write_fleet_bundle(root, name, meta, sections):
    """Write ONE fleet capture bundle: `<root>/<name>/meta.json` plus
    one subdirectory per section (`router/`, `r0@hostA/`, ...) each
    holding that process's `flight.json` / `pulse.json` /
    `requests.json`. Every file lands atomically (tmp + replace), so
    a reader never sees a torn document. Returns the bundle path."""
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    roster = []
    for sec in sections:
        label = _safe_label(sec.get("label"))
        sub = os.path.join(path, label)
        os.makedirs(sub, exist_ok=True)
        roster.append({
            "label": label,
            "offset_s": float(sec.get("offset_s") or 0.0),
            "uncertainty_s": float(sec.get("uncertainty_s") or 0.0),
            "host": sec.get("host"),
            "replica_id": sec.get("replica_id"),
        })
        _write_json(os.path.join(sub, "flight.json"),
                    sec.get("flight") or {})
        _write_json(os.path.join(sub, "pulse.json"),
                    sec.get("pulse") or {})
        _write_json(os.path.join(sub, "requests.json"),
                    {"requests": sec.get("requests") or []})
    doc = dict(meta)
    doc["fleet"] = True
    doc["sections"] = roster
    _write_json(os.path.join(path, "meta.json"), doc)
    return path
