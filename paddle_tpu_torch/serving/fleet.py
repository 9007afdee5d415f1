"""Fleet plane: multi-host disaggregated serving over the rpc layer
(counterpart of `paddle_tpu/serving/fleet.py`; the host side is the
reference's, the engines are the port's).

The serving stack below this module is a complete single-host runtime
— role-specialized replicas, KV handoff, SLO/pulse observability — but
every replica lives in the router's process. This module fronts
replicas running in OTHER processes (other hosts) behind the exact
same `Replica` duck-type, so `Router` gains multi-host disaggregation
with zero structural changes:

  * `FleetWorker` — the worker-process entrypoint. Wraps one local
    `Replica` behind an rpc-served endpoint (submit / stats / load /
    pause / resume / drain / kill / revive / recent_requests /
    metrics) on `distributed/rpc.py`'s named-worker control plane,
    plus a **bulk channel** (a dedicated TCP server speaking
    `serving/wire.py` frames — length-framed, chunked, no pickle for
    page payloads) that streams token frames back to the router and
    ships KV pages host-to-host. Registers in the `_TCPStore`
    rendezvous and beats a store-key heartbeat.
  * `RemoteReplica` — the router-side proxy satisfying the `Replica`
    duck-type. Requests come back as `RemoteRequest` handles that
    duck-type `ServingRequest` (stream/result/cancel, terminal
    states, `_streamed`), so failover, handoff migration and the SLO
    plane all work unchanged. Transport loss marks the replica dead
    and fails its in-flight requests exactly like an engine crash —
    the router's existing breaker/failover path takes over.
  * `KVHandoff` over the bulk channel — a prefill worker's exported
    pages stay put until the decode worker fetches them DIRECTLY from
    the source's bulk endpoint (`RemoteHandoffRef`): the router moves
    a ~100-byte reference, the pages move host-to-host once.
  * `FleetPages` — the kvtier multi-host follow-on: budget-evicted
    prefix pages spill to the peer that the consistent-hash prefix
    affinity names as owner (a DETERMINISTIC ring — the router's
    in-process ring hashes strings, which Python salts per process),
    and a short local match fetches missing chain blocks back from
    the owner. The fleet becomes one global prefix cache:
    `pt_fleet_spill_pages_total`, fetch-on-miss through the same bulk
    channel.
  * `FleetPlane` / `connect_fleet` — router-side bring-up: hosts the
    rendezvous store, waits for every worker's registration, builds
    the `RemoteReplica` pool, and monitors heartbeats (a worker whose
    beat stalls past `PT_FLEET_HB_MISS_S` is marked dead).

Env knobs: `PT_FLEET_HB_S` (beat interval, default 0.5),
`PT_FLEET_HB_MISS_S` (liveness timeout, default 3),
`PT_FLEET_CALL_TIMEOUT_S` (control-plane call timeout, default 30),
`PT_FLEET_RETRIES` (idempotent-call retries, default 2),
`PT_FLEET_FETCH_TIMEOUT_S` (per-page fetch-on-miss budget, default 1),
`PT_FLEET_FETCH_MAX` (blocks fetched per match, default 8).

Trust model is inherited from `distributed/rpc.py`: the control plane
is pickle over a trusted network. The bulk channel never unpickles —
JSON control frames + raw array bytes only — but it authenticates
nothing; run the fleet on a private interconnect.

KV payloads cross the bulk channel as CPU tensors: on the card, the
export and import are the host tier's paths (`kvtier.py`,
`handoff.py`), so the socket carries what an in-process handoff
carries, byte for byte. The frames are the reference's, so a port
worker and a JAX worker exchange handoffs and pages; the control plane
pickles functions by reference, so each package's router drives only
its own package's workers.

Worker processes launch via ``python -m paddle_tpu_torch.serving.fleet
--spec '<json>'`` (see `spawn_worker`); the model/engine imports
happen inside that entrypoint, so this module keeps the serving
package's import-cycle-free contract.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import socket
import sys
import threading
import time
from collections import OrderedDict

from .._env import env_float, env_int, env_str
from ..distributed import rpc as _rpc
from ..observability import fleet_obs as _fobs
from ..observability import flight_recorder as _flight
from ..observability import trace_context as _tc
from . import wire as _wire
from .kvcache import block_hash as _block_hash
from .metrics import MetricsRegistry
from .replica import ReplicaKilledError
from .scheduler import (BackpressureError, CrashLoopError,
                        DeadlineExceededError, PoisonedRequestError,
                        SchedulerClosedError, SchedulerError)
from .timeline import Timeline

__all__ = ["FleetWorker", "FleetPages", "FleetPlane", "RemoteReplica",
           "RemoteRequest", "RemoteHandoffRef", "connect_fleet",
           "spawn_worker", "ROUTER_NAME"]

# rank 0 of the fleet's rpc world is always the router process
ROUTER_NAME = "router"


# ---------------------------------------------------------------------------
# rpc endpoints: module-level functions so pickle ships them by
# REFERENCE (the worker resolves `paddle_tpu_torch.serving.fleet._rpc_*`
# against its own import of this module). Every worker in a process
# registers in _WORKERS under its fleet name.

_WORKERS = {}


def _worker(name):
    w = _WORKERS.get(name)
    if w is None:
        raise RuntimeError(f"fleet: no worker {name!r} in this process "
                           f"(have {sorted(_WORKERS)})")
    return w


def _rpc_submit(name, prompt_ids, params):
    return _worker(name).handle_submit(prompt_ids, params)


def _rpc_cancel(name, rid):
    return _worker(name).handle_cancel(rid)


def _rpc_stats(name):
    return _worker(name).replica.stats()


def _rpc_load(name):
    return _worker(name).replica.load()


def _rpc_ready(name):
    return _worker(name).replica.ready()


def _rpc_recent_requests(name, n):
    return _worker(name).replica.recent_requests(n)


def _rpc_pause(name):
    _worker(name).replica.pause()
    return True


def _rpc_resume(name):
    _worker(name).replica.resume()
    return True


def _rpc_drain(name, timeout):
    return _worker(name).replica.drain(timeout=timeout)


def _rpc_shutdown(name, drain, timeout):
    return _worker(name).shutdown(drain=drain, timeout=timeout)


def _rpc_kill(name):
    _worker(name).replica.kill()
    return True


def _rpc_revive(name):
    _worker(name).replica.revive()
    return True


def _rpc_render_prometheus(name):
    return _worker(name).replica.scheduler.render_prometheus()


def _rpc_metrics_snapshot(name):
    return _worker(name).replica.scheduler.metrics_snapshot()


def _rpc_pulse(name, window, signals):
    sched = _worker(name).replica.scheduler
    if hasattr(sched, "pulse"):
        return sched.pulse(window=window, signals=signals)
    return {"enabled": False}


def _rpc_obs_snapshot(name, window):
    return _worker(name).obs_snapshot(window)


def _rpc_obs_triggers(name):
    return _worker(name).obs_triggers()


# ---------------------------------------------------------------------------
# bulk-channel clients (stdlib socket + serving/wire framing)


def _bulk_connect(addr, timeout):
    s = socket.create_connection(tuple(addr), timeout=timeout)
    s.settimeout(timeout)
    return s


def _fetch_handoff(addr, rid, timeout=None, acct=None):
    """Pull one exported KVHandoff from a worker's bulk endpoint —
    the host-to-host half of a decode migration."""
    timeout = timeout if timeout is not None \
        else env_float("PT_FLEET_CALL_TIMEOUT_S")
    acct = acct if acct is not None else _wire.WireAccount()
    t0 = time.perf_counter()
    with _bulk_connect(addr, timeout) as s:
        _wire.send_json(s, {"op": "handoff", "rid": str(rid)}, acct=acct)
        head = _wire.recv_json(s, acct=acct)
        if not head.get("ok"):
            raise _wire.WireError(
                f"fleet: worker holds no handoff for rid {rid!r}")
        h = _wire.recv_handoff(s, acct=acct)
    _tc.record_span_event(
        "wire.handoff_fetch", time.perf_counter() - t0,
        args={"rid": str(rid), "bytes": acct.rx_bytes + acct.tx_bytes,
              "frames": acct.frames})
    return h


def _push_handoff(addr, h, timeout=None, acct=None):
    """Push a locally-held KVHandoff to a worker's bulk endpoint (the
    local-replica -> remote-replica migration direction). Returns the
    payload bytes framed."""
    timeout = timeout if timeout is not None \
        else env_float("PT_FLEET_CALL_TIMEOUT_S")
    acct = acct if acct is not None else _wire.WireAccount()
    t0 = time.perf_counter()
    with _bulk_connect(addr, timeout) as s:
        _wire.send_json(s, {"op": "handoff_put"}, acct=acct)
        n = _wire.send_handoff(s, h, acct=acct)
        ack = _wire.recv_json(s, acct=acct)
        if not ack.get("ok"):
            raise _wire.WireError("fleet: handoff_put refused")
    _tc.record_span_event(
        "wire.handoff_push", time.perf_counter() - t0,
        args={"rid": str(getattr(h, "rid", "")),
              "bytes": acct.rx_bytes + acct.tx_bytes,
              "frames": acct.frames})
    return n


def _fetch_page(addr, key, timeout, acct=None):
    """Fetch one spilled prefix page by chained hash from its owner.
    Returns {parent, block, depth, payload} or None on a clean miss."""
    acct = acct if acct is not None else _wire.WireAccount()
    t0 = time.perf_counter()
    with _bulk_connect(addr, timeout) as s:
        _wire.send_json(s, {"op": "page_get", "key": int(key)},
                        acct=acct)
        head = _wire.recv_json(s, acct=acct)
        if not head.get("ok"):
            return None
        payload = {"k": _wire.recv_array(s, acct=acct),
                   "v": _wire.recv_array(s, acct=acct),
                   "ks": _wire.recv_array(s, acct=acct),
                   "vs": _wire.recv_array(s, acct=acct)}
        _tc.record_span_event(
            "wire.page_fetch", time.perf_counter() - t0,
            args={"bytes": acct.rx_bytes + acct.tx_bytes,
                  "frames": acct.frames})
        return {"parent": int(head["parent"]),
                "block": tuple(int(t) for t in head["block"]),
                "depth": int(head["depth"]), "payload": payload}


def _push_page(addr, parent, block, depth, payload, timeout,
               acct=None):
    """Ship one evicted prefix page to its owning peer. Returns bytes
    framed."""
    acct = acct if acct is not None else _wire.WireAccount()
    t0 = time.perf_counter()
    with _bulk_connect(addr, timeout) as s:
        _wire.send_json(s, {"op": "page_put", "parent": int(parent),
                            "block": [int(t) for t in block],
                            "depth": int(depth)}, acct=acct)
        n = 0
        for part in ("k", "v", "ks", "vs"):
            n += _wire.send_array(s, payload.get(part), acct=acct)
        ack = _wire.recv_json(s, acct=acct)
        if not ack.get("ok"):
            raise _wire.WireError("fleet: page_put refused")
    _tc.record_span_event(
        "wire.page_spill", time.perf_counter() - t0,
        args={"bytes": acct.rx_bytes + acct.tx_bytes,
              "frames": acct.frames})
    return n


class RemoteHandoffRef:
    """A KVHandoff that still lives on its exporting worker. Carries
    the flight-record metadata (`nbytes`/`pages`) so `Router._migrate`
    needs no change; resolves lazily into the real payload on first
    field access — which only happens when a LOCAL replica imports it
    (remote targets receive the reference and fetch source-direct)."""

    def __init__(self, addr, rid, nbytes=0, pages=0):
        self.addr = tuple(addr)
        self.rid = str(rid)
        self.nbytes = int(nbytes)
        self.pages = int(pages)
        self._payload = None
        self._rlock = threading.Lock()

    def resolve(self):
        with self._rlock:
            if self._payload is None:
                # _rlock's entire job is making concurrent resolvers
                # wait for the ONE bulk fetch instead of issuing N;
                # nothing else is ever guarded by it
                self._payload = _fetch_handoff(self.addr, self.rid)
            return self._payload

    def __getattr__(self, name):
        # only fields NOT set in __init__ land here: the KVHandoff
        # surface (k/v/ks/vs/output/next_token/length/...)
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.resolve(), name)

    def __repr__(self):
        return (f"RemoteHandoffRef(addr={self.addr}, rid={self.rid!r}, "
                f"nbytes={self.nbytes}, pages={self.pages})")


# ---------------------------------------------------------------------------
# global prefix-page cache (worker side)


def _ring_point(s):
    """Deterministic 64-bit signed ring point. The router's in-process
    `_HashRing` uses `hash()` on strings — salted per process, fine
    for routing, useless for cross-host ownership agreement. blake2b
    gives every worker the identical ring."""
    d = hashlib.blake2b(s.encode(), digest_size=8).digest()
    v = int.from_bytes(d, "little")
    return v - (1 << 64) if v >= (1 << 63) else v


class FleetPages:
    """Multi-host prefix-page exchange over one worker's `HostTier`.

    Spill: the tier's budget evictions (`on_drop`, invoked outside the
    tier lock) enqueue to a bounded queue; a pump thread ships each
    page to the peer the deterministic consistent-hash ring names as
    the key's owner — the same replica the router's prefix affinity
    sends that prefix's PROMPTS to, so pages land where their hits
    are. Fetch: a local tier match that ends short of the prompt's cap
    asks the owner for the missing chain blocks (`fetch_missing`,
    bounded by PT_FLEET_FETCH_MAX pages and PT_FLEET_FETCH_TIMEOUT_S
    each), verifies (parent, block) raw, and inserts them locally.
    Peer-originated entries are flagged so budget pressure drops them
    without re-spilling (no ping-pong).
    """

    def __init__(self, worker):
        self.worker = worker
        self.tier = worker.replica.engine.host_tier
        self._self_rid = worker.replica.replica_id
        self._points = None          # built lazily: sorted [(pt, rid)]
        self._peers = {}             # replica_id -> meta dict
        self._ring_lock = threading.Lock()
        self._q = queue.Queue(maxsize=env_int("PT_FLEET_SPILL_QUEUE"))
        self._stop = threading.Event()
        self._thread = None
        r = worker.replica.registry
        self.spill_pages = r.counter(
            "pt_fleet_spill_pages",
            "Evicted prefix pages shipped to their owning peer.")
        self.spill_bytes = r.counter(
            "pt_fleet_spill_bytes",
            "Bytes of prefix pages shipped to peers.")
        self.spill_drops = r.counter(
            "pt_fleet_spill_drops",
            "Evicted pages NOT shipped (queue full, peer unreachable, "
            "or self-owned).")
        self.fetch_pages = r.counter(
            "pt_fleet_fetch_pages",
            "Prefix pages fetched from a peer on a local tier miss.")
        self.fetch_misses = r.counter(
            "pt_fleet_fetch_misses",
            "Fetch-on-miss attempts that found no page at the owner.")
        self.recv_pages = r.counter(
            "pt_fleet_recv_pages",
            "Prefix pages landed here by a peer's spill.")
        self.page_serves = r.counter(
            "pt_fleet_page_serves",
            "Spilled pages served to a fetching peer.")
        self.tier.on_drop = self.on_drop
        self.tier.fetch_missing = self.fetch_missing

    # -- ring ----------------------------------------------------------
    def _ensure_ring(self):
        with self._ring_lock:
            if self._points is not None:
                return self._points, dict(self._peers)
        # Build OUTSIDE the lock: membership is a store/rpc round trip
        # per peer, and holding _ring_lock across the network would
        # stall the spill loop and every owner_of() caller on one slow
        # peer. Racing callers each fetch an equivalent snapshot; the
        # first to publish wins and the rest discard theirs.
        agent = self.worker.agent
        peers = {}
        for info in agent.all_worker_infos():
            if info.rank == 0:
                continue             # the router owns no pages
            meta = self.worker.store.get(f"fleet/meta/{info.name}")
            peers[meta["replica_id"]] = meta
        pts = []
        for rid, meta in peers.items():
            # ring membership mirrors the router's: only replicas
            # that take NEW prompts own prefix keys
            if meta["role"] not in ("prefill", "both"):
                continue
            for i in range(64):
                pts.append((_ring_point(f"{rid}|{i}"), rid))
        pts.sort()
        with self._ring_lock:
            if self._points is None:
                self._points = pts
                self._peers = peers
            return self._points, dict(self._peers)

    def owner_of(self, key):
        pts, _ = self._ensure_ring()
        if not pts:
            return None
        import bisect
        i = bisect.bisect_left(pts, (int(key),))
        return pts[i % len(pts)][1]

    # -- spill side (tier copy/pump threads enqueue; pump ships) -------
    def on_drop(self, entries):
        """Tier hook: budget-evicted (key, entry) pairs, lock already
        released. Enqueue-or-drop — never block the calling thread."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._spill_loop, daemon=True,
                name=f"pt-fleet-spill-{self.worker.name}")
            self._thread.start()
        for key, e in entries:
            try:
                self._q.put_nowait((key, e))
            except queue.Full:
                self.spill_drops.inc()

    def _spill_loop(self):
        timeout = env_float("PT_FLEET_FETCH_TIMEOUT_S") * 5
        while not self._stop.is_set():
            try:
                key, e = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                owner = self.owner_of(key)
                if owner is None or owner == self._self_rid:
                    self.spill_drops.inc()
                    continue
                _, peers = self._ensure_ring()
                meta = peers.get(owner)
                if meta is None:
                    self.spill_drops.inc()
                    continue
                n = _push_page((meta["bulk_ip"], meta["bulk_port"]),
                               e["parent"], e["block"], e["depth"],
                               e["payload"], timeout,
                               acct=self.worker.wire_acct("bulk"))
                self.spill_pages.inc()
                self.spill_bytes.inc(n)
                _flight.record("fleet.spill", owner=owner, bytes=n,
                               depth=e["depth"])
            except Exception as err:  # noqa: BLE001 — a lost spill is a miss
                self.spill_drops.inc()
                _flight.record("fleet.spill_error", error=repr(err))
            finally:
                self._q.task_done()

    # -- fetch side (engine admission path, outside the tier lock) -----
    def fetch_missing(self, parent, block_idx, tokens):
        """Tier hook: the local chain walk ended at `block_idx` with
        chain hash `parent`; continue it through the owning peers.
        Returns chain-order payloads (possibly empty)."""
        ps = self.tier.page_size
        limit = (len(tokens) - 1) // ps
        budget = env_int("PT_FLEET_FETCH_MAX")
        timeout = env_float("PT_FLEET_FETCH_TIMEOUT_S")
        out = []
        b = int(block_idx)
        while b < limit and len(out) < budget:
            block = tuple(int(t) for t in tokens[b * ps:(b + 1) * ps])
            key = _block_hash(parent, block)
            owner = self.owner_of(key)
            if owner is None or owner == self._self_rid:
                break                # a local miss IS the answer here
            _, peers = self._ensure_ring()
            meta = peers.get(owner)
            if meta is None:
                break
            try:
                entry = _fetch_page((meta["bulk_ip"], meta["bulk_port"]),
                                    key, timeout,
                                    acct=self.worker.wire_acct("bulk"))
            except Exception:  # noqa: BLE001 — peer down == miss
                self.fetch_misses.inc()
                break
            if entry is None or entry["parent"] != parent \
                    or entry["block"] != block:
                self.fetch_misses.inc()
                break
            self.tier.insert(parent, block, b, entry["payload"],
                             fleet=True)
            out.append(entry["payload"])
            self.fetch_pages.inc()
            parent = key
            b += 1
        if out:
            _flight.record("fleet.fetch", pages=len(out))
        return out

    # -- serve side (bulk handler) -------------------------------------
    def serve_page(self, conn, key):
        e = self.tier.peek(int(key))
        acct = self.worker.wire_acct("bulk")
        if e is None:
            _wire.send_json(conn, {"ok": False}, acct=acct)
            return
        t0 = time.perf_counter()
        _wire.send_json(conn, {"ok": True, "parent": int(e["parent"]),
                               "block": [int(t) for t in e["block"]],
                               "depth": int(e["depth"])}, acct=acct)
        for part in ("k", "v", "ks", "vs"):
            _wire.send_array(conn, e["payload"].get(part), acct=acct)
        self.page_serves.inc()
        _tc.record_span_event(
            "wire.page_serve", time.perf_counter() - t0,
            args={"bytes": acct.tx_bytes, "frames": acct.frames,
                  "worker": self.worker.name})

    def land_page(self, conn, head):
        acct = self.worker.wire_acct("bulk")
        t0 = time.perf_counter()
        payload = {"k": _wire.recv_array(conn, acct=acct),
                   "v": _wire.recv_array(conn, acct=acct),
                   "ks": _wire.recv_array(conn, acct=acct),
                   "vs": _wire.recv_array(conn, acct=acct)}
        ok = self.tier.insert(
            int(head["parent"]),
            tuple(int(t) for t in head["block"]),
            int(head["depth"]), payload, fleet=True)
        if ok:
            self.recv_pages.inc()
        _wire.send_json(conn, {"ok": bool(ok)}, acct=acct)
        _tc.record_span_event(
            "wire.page_land", time.perf_counter() - t0,
            args={"bytes": acct.rx_bytes, "frames": acct.frames,
                  "worker": self.worker.name})

    def stop(self):
        self._stop.set()
        # the tier's copy thread lives as long as the process: hooks left
        # on the tier would keep this worker, its replica and its
        # engine's weights alive after the worker closes
        if self.tier.on_drop == self.on_drop:
            self.tier.on_drop = None
        if self.tier.fetch_missing == self.fetch_missing:
            self.tier.fetch_missing = None


# ---------------------------------------------------------------------------
# worker process


class FleetWorker:
    """One fleet member: a local `Replica` served over the rpc control
    plane plus a bulk channel for token streams and KV pages. See the
    module docstring for the topology; `run_worker`/`spawn_worker` for
    the process entrypoint. Multiple FleetWorkers may share a process
    (loopback tests drive the full wire path that way)."""

    def __init__(self, name, replica, *, master_endpoint, rank,
                 world_size, host=None, bulk_bind=None):
        self.name = str(name)
        self.replica = replica
        self.host = str(host or socket.gethostname())
        # the host tag rides the replica so every metric and /debug
        # payload the router aggregates carries host= next to replica=
        replica.host = self.host
        self._requests = {}          # rid -> live ServingRequest
        self._req_lock = threading.Lock()
        # exported handoffs kept for peer fetch (NOT popped on read: a
        # refused admission retries the fetch from the next candidate)
        self._handoffs = OrderedDict()
        # handoff payloads pushed TO this worker ahead of a submit
        self._kv_imports = {}
        self._stop = threading.Event()
        # heartbeat has its OWN stop: the heartbeat-loss drill silences
        # the beat while the worker keeps serving (a network partition
        # between worker and store, not a worker death)
        self._hb_stop = threading.Event()
        r = replica.registry
        self.stream_serves = r.counter(
            "pt_fleet_stream_serves",
            "Token streams served to the router over the bulk channel.")
        self.handoff_serves = r.counter(
            "pt_fleet_handoff_serves",
            "KV handoffs served to a fetching peer over the bulk "
            "channel.")
        self.handoff_wire_bytes = r.counter(
            "pt_fleet_handoff_wire_bytes",
            "KV handoff payload bytes actually framed onto the bulk "
            "socket.")
        self._wire_counters = {}     # chan -> (tx, rx, frames)
        _WORKERS[self.name] = self
        # every worker leaves evidence: the flight ring dumps on
        # SIGTERM/fault, and the router's fleet capture pulls the same
        # ring over rpc (install() is idempotent + thread-safe)
        _flight.install()

        # bulk channel first: its advertised endpoint rides the meta
        bind = bulk_bind or env_str("PT_RPC_BIND")
        self._bulk_srv = socket.create_server((bind, 0))
        self._bulk_srv.settimeout(0.2)
        ip, port = self._bulk_srv.getsockname()[:2]
        if ip in ("0.0.0.0", "::"):
            ip = _rpc._routable_ip()
        self.bulk_addr = (ip, int(port))
        self._bulk_thread = threading.Thread(
            target=self._bulk_serve, daemon=True,
            name=f"pt-fleet-bulk-{self.name}")
        self._bulk_thread.start()

        # rendezvous: meta is published BEFORE the agent barrier, so
        # once ANY worker's rendezvous completes every peer's meta is
        # readable without blocking
        mhost, mport = str(master_endpoint).rsplit(":", 1)
        self.store = _rpc._TCPStore(mhost, int(mport), False)
        self.store.set(f"fleet/meta/{self.name}", {
            "name": self.name,
            "replica_id": replica.replica_id,
            "role": replica.role,
            "host": self.host,
            "page_size": int(replica.page_size),
            "max_queue": int(replica.max_queue),
            "bulk_ip": ip, "bulk_port": int(port),
        })
        self.agent = _rpc.RpcAgent(self.name, int(rank), int(world_size),
                                   self.store)

        # heartbeat: a monotonically increasing store key — seq-based,
        # so router-side liveness needs no clock agreement
        self._hb_thread = threading.Thread(
            target=self._heartbeat, daemon=True,
            name=f"pt-fleet-hb-{self.name}")
        self._hb_thread.start()

        # global prefix cache rides the replica's host tier when one
        # is enabled
        tier = getattr(replica.engine, "host_tier", None)
        self.pages = FleetPages(self) \
            if tier is not None and tier.enabled else None
        _flight.record("fleet.worker_up", worker=self.name,
                       replica=replica.replica_id, host=self.host)

    # -- wire accounting -----------------------------------------------
    def wire_acct(self, chan):
        """A fresh per-transfer `WireAccount` bound to this worker's
        per-channel wire counters: the local tallies feed span byte
        counts, the bound counters feed the symmetric
        pt_wire_{tx,rx}_bytes / pt_wire_frames series the router
        surfaces per replica@host."""
        c = self._wire_counters.get(chan)
        if c is None:
            r = self.replica.registry
            c = (r.counter("pt_wire_tx_bytes",
                           "Bytes framed onto fleet sockets (header + "
                           "payload).", labels={"chan": chan}),
                 r.counter("pt_wire_rx_bytes",
                           "Bytes received off fleet sockets (header + "
                           "payload).", labels={"chan": chan}),
                 r.counter("pt_wire_frames",
                           "Frames moved over fleet sockets, both "
                           "directions.", labels={"chan": chan}))
            # benign race: the registry dedups by (name, labels), so
            # two threads landing here cache the same counter objects
            self._wire_counters[chan] = c
        return _wire.WireAccount(tx=c[0], rx=c[1], frames=c[2])

    # -- heartbeat -----------------------------------------------------
    def _heartbeat(self):
        interval = env_float("PT_FLEET_HB_S")
        seq = 0
        while not self._hb_stop.wait(0 if seq == 0 else interval):
            try:
                self.store.set(f"fleet/hb/{self.name}", seq)
            except (ConnectionError, OSError, TimeoutError):
                pass                 # master gone; shutdown will follow
            seq += 1

    def stop_heartbeat(self):
        """Test hook for the heartbeat-loss drill: the worker keeps
        serving but its beat goes silent, so the router must degrade
        it without dropping requests."""
        self._hb_stop.set()

    # -- bulk channel ---------------------------------------------------
    def _bulk_serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._bulk_srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._bulk_handle, args=(conn,),
                             daemon=True).start()
        try:
            self._bulk_srv.close()
        except OSError:
            pass

    def _bulk_handle(self, conn):
        try:
            with conn:
                head = _wire.recv_json(conn,
                                       acct=self.wire_acct("control"))
                op = head.get("op")
                if op == "stream":
                    self._serve_stream(conn, str(head.get("rid")))
                elif op == "handoff":
                    self._serve_handoff(conn, str(head.get("rid")))
                elif op == "handoff_put":
                    acct = self.wire_acct("bulk")
                    t0 = time.perf_counter()
                    h = _wire.recv_handoff(conn, acct=acct)
                    with self._req_lock:
                        self._kv_imports[str(h.rid)] = h
                    _wire.send_json(conn, {"ok": True}, acct=acct)
                    _tc.record_span_event(
                        "wire.handoff_land",
                        time.perf_counter() - t0,
                        args={"rid": str(h.rid),
                              "bytes": acct.rx_bytes,
                              "frames": acct.frames,
                              "worker": self.name})
                elif op == "page_put" and self.pages is not None:
                    self.pages.land_page(conn, head)
                elif op == "page_get" and self.pages is not None:
                    self.pages.serve_page(conn, head.get("key", 0))
                else:
                    _wire.send_json(conn, {"ok": False,
                                           "error": f"bad op {op!r}"})
        except (ConnectionError, OSError) as e:
            _flight.record("fleet.bulk_error", worker=self.name,
                           error=repr(e))

    def _serve_stream(self, conn, rid):
        """Forward one request's token chunks as JSON frames, then a
        terminal frame carrying everything the router-side handle
        mirrors (state, error, full output, stitched timeline, SLO
        verdict, handoff reference metadata)."""
        with self._req_lock:
            sr = self._requests.get(rid)
        if sr is None:
            _wire.send_json(conn, {"t": "end", "state": "failed",
                                   "error": {"type": "KeyError",
                                             "msg": f"no request {rid}"},
                                   "output": []})
            return
        self.stream_serves.inc()
        acct = self.wire_acct("stream")
        t0 = time.perf_counter()
        err = None
        try:
            for chunk in sr.stream():
                _wire.send_json(conn, {"t": "chunk",
                                       "toks": [int(t) for t in chunk]},
                                acct=acct)
        except Exception as e:  # noqa: BLE001 — shipped as the terminal error
            err = {"type": type(e).__name__, "msg": str(e)}
        h = sr.handoff
        frame = {
            "t": "end", "state": sr.state, "error": err,
            "output": [int(t) for t in sr.output],
            "logprobs": getattr(sr.req, "logprobs", None),
            "cached_tokens": int(getattr(sr.req, "cached_tokens", 0) or 0),
            "timeline": sr.timeline.to_dict()
            if sr.timeline is not None else None,
            "slo": sr.slo, "slo_attained": sr.slo_attained,
            "violated_phase": sr.violated_phase,
            "handoff": None if h is None else {
                "nbytes": int(h.nbytes), "pages": int(h.pages)},
        }
        if h is not None:
            with self._req_lock:
                self._handoffs[rid] = h
                while len(self._handoffs) > 64:
                    self._handoffs.popitem(last=False)
        with self._req_lock:
            self._requests.pop(rid, None)
        _wire.send_json(conn, frame, acct=acct)
        # worker half of the stream: same span name as the router's
        # reader half, so the stitched fleet trace shows the transfer
        # from both ends of the socket
        _tc.record_span_event(
            "wire.stream", time.perf_counter() - t0,
            trace_id=sr.trace_id,
            args={"rid": rid, "bytes": acct.tx_bytes,
                  "frames": acct.frames, "worker": self.name})

    def _serve_handoff(self, conn, rid):
        with self._req_lock:
            h = self._handoffs.get(rid)
        if h is None:
            _wire.send_json(conn, {"ok": False})
            return
        acct = self.wire_acct("bulk")
        t0 = time.perf_counter()
        _wire.send_json(conn, {"ok": True}, acct=acct)
        n = _wire.send_handoff(conn, h, acct=acct)
        dt = time.perf_counter() - t0
        self.handoff_serves.inc()
        self.handoff_wire_bytes.inc(n)
        # the socket hop lands in the same histogram the in-process
        # export path observes: pt_handoff_seconds measures time spent
        # MOVING handoffs, whichever transport carried them
        self.replica.registry.histogram(
            "pt_handoff_seconds",
            "Handoff export/transfer wall time.").observe(dt)
        _tc.record_span_event(
            "wire.handoff", dt,
            args={"rid": rid, "bytes": acct.tx_bytes,
                  "frames": acct.frames, "worker": self.name})
        _flight.record("fleet.handoff_serve", worker=self.name,
                       rid=rid, bytes=n, seconds=round(dt, 6))

    # -- rpc-facing handlers -------------------------------------------
    def handle_submit(self, prompt_ids, params):
        # the rpc layer binds the inbound trace meta around dispatch;
        # re-bind from params too so the in-process harness path (no
        # rpc hop) keeps the same worker-side trace identity
        tid = (params or {}).get("trace_id")
        if tid and _tc.current_trace_id() != tid:
            with _tc.bind(tid):
                return self._handle_submit(prompt_ids, params)
        return self._handle_submit(prompt_ids, params)

    def _handle_submit(self, prompt_ids, params):
        params = dict(params)
        ref = params.pop("kv_import_ref", None)
        token = params.pop("kv_import_token", None)
        kv_import = None
        if token is not None:
            with self._req_lock:
                kv_import = self._kv_imports.pop(str(token), None)
            if kv_import is None:
                raise SchedulerClosedError(
                    f"fleet: no pushed handoff payload {token!r}")
        elif ref is not None:
            try:
                kv_import = _fetch_handoff(tuple(ref["addr"]),
                                           ref["rid"],
                                           acct=self.wire_acct("bulk"))
            except (ConnectionError, OSError, TimeoutError) as e:
                # source worker gone or payload expired: refuse this
                # candidate crisply so _migrate tries the next one
                raise SchedulerClosedError(
                    f"fleet: handoff fetch failed: {e}") from e
        sr = self.replica.submit(prompt_ids, kv_import=kv_import,
                                 **params)
        rid = str(sr.rid)
        with self._req_lock:
            self._requests[rid] = sr
        return {"rid": sr.rid, "trace_id": sr.trace_id,
                "priority": sr.priority, "slo": sr.slo,
                "output": [int(t) for t in sr.output]}

    def handle_cancel(self, rid):
        with self._req_lock:
            sr = self._requests.get(str(rid))
        return sr.cancel() if sr is not None else False

    # -- fleet observability -------------------------------------------
    def obs_snapshot(self, window=None):
        """One rpc: everything the router needs to merge this worker
        into a fleet trace, flight dump, or capture bundle. Spans ride
        the flight snapshot (kind == "span" events)."""
        sched = self.replica.scheduler
        if hasattr(sched, "pulse"):
            pulse = sched.pulse(window=window)
        else:
            pulse = {"enabled": False}
        return {
            "name": self.name,
            "replica_id": self.replica.replica_id,
            "host": self.host,
            "role": self.replica.role,
            "t_wall": time.time(),
            "flight": _flight.snapshot(reason="fleet.obs"),
            "pulse": pulse,
            "requests": self.replica.recent_requests(64),
        }

    def obs_triggers(self):
        """Light poll target for the plane's obs loop: cumulative
        pulse-trigger totals plus the trace ids in flight. The rpc
        round trips that carry this also feed the router's clock-skew
        estimator — polling IS the sampling cadence."""
        plane = getattr(self.replica.scheduler, "_pulse", None)
        if plane is None:
            return {"triggers": {}, "bundles": [], "trace_ids": []}
        plane.maybe_sample()
        return plane.trigger_state()

    # -- lifecycle -----------------------------------------------------
    def serve_forever(self):
        """Block until a shutdown rpc (or local close) stops the
        worker — the `python -m paddle_tpu_torch.serving.fleet` main loop."""
        self._stop.wait()
        # grace for the in-flight shutdown rpc reply to flush
        time.sleep(0.2)
        self.close()

    def shutdown(self, drain=True, timeout=None):
        ok = self.replica.shutdown(drain=drain, timeout=timeout)
        self._stop.set()
        return ok

    def close(self):
        self._stop.set()
        self._hb_stop.set()
        if self.pages is not None:
            self.pages.stop()
        try:
            self.agent.stop()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
        try:
            self._bulk_srv.close()
        except OSError:
            pass
        if _WORKERS.get(self.name) is self:
            _WORKERS.pop(self.name, None)

    def __repr__(self):
        return (f"FleetWorker({self.name!r}, "
                f"replica={self.replica.replica_id!r}, "
                f"host={self.host!r})")


# ---------------------------------------------------------------------------
# router side


class _ReqView:
    """Duck-types the engine-level `Request` fields the HTTP frontend
    reads off a handle (`prompt/output/logprobs/cached_tokens`)."""

    __slots__ = ("rid", "prompt", "output", "logprobs", "cached_tokens")

    def __init__(self, rid, prompt, output):
        self.rid = rid
        self.prompt = list(prompt)
        self.output = list(output)
        self.logprobs = None
        self.cached_tokens = 0


_ERROR_TYPES = {
    "BackpressureError": BackpressureError,
    "SchedulerClosedError": SchedulerClosedError,
    "CrashLoopError": CrashLoopError,
    "DeadlineExceededError": DeadlineExceededError,
    "PoisonedRequestError": PoisonedRequestError,
    "ReplicaKilledError": ReplicaKilledError,
    "SchedulerError": SchedulerError,
    "TimeoutError": TimeoutError,
}


def _rebuild_error(err):
    if err is None:
        return None
    cls = _ERROR_TYPES.get(err.get("type"))
    msg = err.get("msg", "")
    if cls is not None:
        return cls(msg)
    return RuntimeError(f"{err.get('type', 'RemoteError')}: {msg}")


class RemoteRequest:
    """Router-side handle over one request running on a fleet worker.
    Duck-types `ServingRequest`: same terminal states, same
    `stream()/result()/cancel()` semantics, its own `_streamed` flag
    (the point of no replay is when THIS consumer saw a chunk — the
    worker forwarding frames to us does not count). A background
    reader drains the worker's bulk-channel token frames into a local
    queue; transport loss before terminal flips the request to
    "failed" exactly like an engine crash, which is what arms the
    router's failover."""

    def __init__(self, replica, prompt_ids, spec):
        self._replica = replica
        self.rid = spec["rid"]
        self.trace_id = spec.get("trace_id")
        self.priority = spec.get("priority", "normal")
        self.slo = spec.get("slo")
        self.req = _ReqView(self.rid, prompt_ids,
                            spec.get("output") or [])
        self.state = "queued"
        self.error = None
        self.t_first_token = None
        self.timeline = None
        self.slo_attained = None
        self.violated_phase = None
        self.handoff = None
        self._streamed = False
        self.chunks = queue.Queue()
        self._done = threading.Event()
        self._term_lock = threading.Lock()
        self._sock = None
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"pt-fleet-req-{self.rid}")
        self._reader.start()

    @property
    def output(self):
        return list(self.req.output)

    # -- reader ---------------------------------------------------------
    def _read_loop(self):
        acct = self._replica.wire_acct("stream")
        t0 = time.perf_counter()
        try:
            s = socket.create_connection(
                self._replica.bulk_addr,
                timeout=env_float("PT_FLEET_CALL_TIMEOUT_S"))
            # streaming can idle arbitrarily long behind a deep queue;
            # liveness belongs to the heartbeat monitor, which closes
            # this socket when the worker is declared dead
            s.settimeout(None)
            self._sock = s
            _wire.send_json(s, {"op": "stream", "rid": str(self.rid)},
                            acct=acct)
            while True:
                fr = _wire.recv_json(s, acct=acct)
                t = fr.get("t")
                if t == "chunk":
                    toks = [int(x) for x in fr.get("toks") or []]
                    if self.t_first_token is None:
                        self.t_first_token = time.monotonic()
                    self.req.output.extend(toks)
                    self.chunks.put(toks)
                elif t == "end":
                    self._finish(fr)
                    # router half of the stream transfer (the worker
                    # records its half under the same span name)
                    _tc.record_span_event(
                        "wire.stream", time.perf_counter() - t0,
                        trace_id=self.trace_id,
                        args={"rid": str(self.rid),
                              "bytes": acct.rx_bytes,
                              "frames": acct.frames,
                              "worker": self._replica._worker})
                    return
                else:
                    raise _wire.WireError(
                        f"fleet: unexpected stream frame {t!r}")
        except Exception as e:  # noqa: BLE001 — any reader death fails the req
            self._transport_dead(e)
        finally:
            sock, self._sock = self._sock, None
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass

    def _finish(self, fr):
        with self._term_lock:
            if self._done.is_set():
                return
            self.req.output = [int(t) for t in fr.get("output") or []]
            self.req.logprobs = fr.get("logprobs")
            self.req.cached_tokens = int(fr.get("cached_tokens") or 0)
            tl = fr.get("timeline")
            self.timeline = Timeline.from_dict(tl) if tl else None
            self.slo = fr.get("slo", self.slo)
            self.slo_attained = fr.get("slo_attained")
            self.violated_phase = fr.get("violated_phase")
            h = fr.get("handoff")
            if h is not None:
                self.handoff = RemoteHandoffRef(
                    self._replica.bulk_addr, str(self.rid),
                    nbytes=h.get("nbytes", 0), pages=h.get("pages", 0))
            err = fr.get("error")
            if err is not None:
                # worker-side failure context survives the frame: the
                # NEXT sever on this replica names it (a crash usually
                # errors one request before it kills the transport)
                self._replica.last_error = (
                    f"{err.get('type', 'Error')}: {err.get('msg', '')}")
            self.error = _rebuild_error(err)
            self.state = fr.get("state", "failed")
            self._done.set()
            self.chunks.put(None)
        self._replica._forget(self.rid)

    def _transport_dead(self, reason):
        """The wire to the worker died before a terminal frame: fail
        the request like an engine crash, carrying the trace id and
        the worker's last known error so the router-side exception
        names WHAT died over there, not just that the socket closed.
        Never-streamed handles then ride the router's existing
        failover (token-identical replay); mid-stream ones surface
        the error."""
        last = self._replica.last_error
        with self._term_lock:
            if self._done.is_set():
                return
            msg = (f"fleet: worker {self._replica._worker!r} lost "
                   f"mid-request: {reason} [trace {self.trace_id}]")
            if last:
                msg += f"; last worker error: {last}"
            err = SchedulerError(msg)
            err.trace_id = self.trace_id
            err.worker_error = last
            self.error = err
            self.state = "failed"
            self._done.set()
            self.chunks.put(None)
        self._replica._forget(self.rid)
        _flight.record("fleet.sever", rid=str(self.rid),
                       worker=self._replica._worker,
                       trace_id=self.trace_id, reason=str(reason),
                       worker_error=last, streamed=self._streamed)

    def _sever(self, reason):
        """Heartbeat monitor path: close the stream socket so the
        blocked reader fails NOW instead of waiting on a dead peer."""
        sock = self._sock
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._transport_dead(reason)

    # -- consumption ----------------------------------------------------
    def stream(self, timeout=None):
        while True:
            chunk = self.chunks.get(timeout=timeout)
            if chunk is None:
                if self.error is not None:
                    raise self.error
                return
            self._streamed = True
            yield chunk

    def result(self, timeout=None):
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(f"request {self.rid}: not done")
        if self.error is not None:
            raise self.error
        return self.output

    def cancel(self):
        if self._done.is_set():
            return False
        try:
            return bool(self._replica._call(_rpc_cancel,
                                            (str(self.rid),)))
        except (ConnectionError, OSError, TimeoutError):
            return False


class _RemoteScheduler:
    """The `replica.scheduler` surface the router's aggregation paths
    consume (/metrics, /debug/requests, /debug/pulse, ledger stats) —
    each method one idempotent rpc with a degraded fallback, so one
    dead worker never breaks a pool-wide scrape."""

    def __init__(self, rep):
        self._rep = rep

    def render_prometheus(self):
        try:
            return self._rep._call(_rpc_render_prometheus,
                                   retries=self._rep._retries)
        except (ConnectionError, OSError, TimeoutError):
            return ""

    def metrics_snapshot(self):
        try:
            return self._rep._call(_rpc_metrics_snapshot,
                                   retries=self._rep._retries)
        except (ConnectionError, OSError, TimeoutError):
            return {}

    def recent_requests(self, n=50):
        try:
            return self._rep._call(_rpc_recent_requests, (int(n),),
                                   retries=self._rep._retries)
        except (ConnectionError, OSError, TimeoutError):
            return []

    def pulse(self, window=None, signals=None):
        try:
            return self._rep._call(_rpc_pulse, (window, signals),
                                   retries=self._rep._retries)
        except (ConnectionError, OSError, TimeoutError):
            return {"enabled": False}

    def stats(self):
        return self._rep.stats()

    # registry-surface alias: this object doubles as the proxy's
    # `registry`, and registry consumers call snapshot()
    snapshot = metrics_snapshot


_DEAD_LOAD = 1 << 30


class RemoteReplica:
    """`Replica` duck-type over a fleet worker: every control call is
    an rpc to the worker's agent; submits return `RemoteRequest`
    handles fed by the worker's bulk channel. Transport failures
    degrade, never crash the router: submit translates to
    `SchedulerClosedError` (the dispatch plan spills to the next
    candidate), stats/load return worst-case values, and a dead
    marking (heartbeat loss or connection refusal) fails in-flight
    requests through the same path an engine crash would take."""

    def __init__(self, agent, worker_name, meta):
        self._agent = agent
        self._worker = str(worker_name)
        self.replica_id = str(meta["replica_id"])
        self.role = meta.get("role", "both")
        self.page_size = int(meta["page_size"])
        self.max_queue = int(meta.get("max_queue", 64))
        self.host = meta.get("host")
        self.bulk_addr = (meta["bulk_ip"], int(meta["bulk_port"]))
        self._dead = threading.Event()
        self._dead_reason = None
        # last worker-side error string seen on this replica's wire
        # (terminal stream frames); attached to sever exceptions.
        # Plain attribute: single writer per frame, torn reads benign
        self.last_error = None
        self._live = {}
        self._live_lock = threading.Lock()
        # wire accounting: counters live on the fleet plane's registry
        # (installed by FleetPlane); bare local tallies until then
        self._wire_registry = None
        self._wire_counters = {}
        self._retries = env_int("PT_FLEET_RETRIES")
        self._timeout = env_float("PT_FLEET_CALL_TIMEOUT_S")
        self._last_stats = {
            "replica_id": self.replica_id, "role": self.role,
            "ready": False, "closed": False, "paused": False,
            "queued": 0, "inflight": 0, "active": 0,
            "engine_waiting": 0, "device_steps": 0, "preemptions": 0,
            "requests": {"submitted": 0, "started": 0, "completed": 0,
                         "failed": 0, "cancelled": 0, "expired": 0,
                         "requeued": 0, "handoff": 0},
        }
        self.scheduler = _RemoteScheduler(self)
        self.registry = self.scheduler

    def wire_acct(self, chan):
        """Router-side mirror of `FleetWorker.wire_acct`: a fresh
        account bound to pt_wire_* counters on the plane registry, or
        tallies-only when no plane installed one (in-process tests)."""
        c = self._wire_counters.get(chan)
        if c is None:
            r = self._wire_registry
            if r is None:
                return _wire.WireAccount()
            c = (r.counter("pt_wire_tx_bytes",
                           "Bytes framed onto fleet sockets (header + "
                           "payload).", labels={"chan": chan}),
                 r.counter("pt_wire_rx_bytes",
                           "Bytes received off fleet sockets (header + "
                           "payload).", labels={"chan": chan}),
                 r.counter("pt_wire_frames",
                           "Frames moved over fleet sockets, both "
                           "directions.", labels={"chan": chan}))
            self._wire_counters[chan] = c
        return _wire.WireAccount(tx=c[0], rx=c[1], frames=c[2])

    # -- rpc plumbing ---------------------------------------------------
    def _call(self, fn, args=(), timeout=None, retries=0):
        if self._dead.is_set():
            raise ConnectionError(
                f"fleet: worker {self._worker!r} is dead "
                f"({self._dead_reason})")
        timeout = self._timeout if timeout is None else timeout
        last = None
        for attempt in range(int(retries) + 1):
            try:
                fut = self._agent.invoke(self._worker, fn,
                                         (self._worker,) + tuple(args),
                                         {}, timeout)
                return fut.wait(timeout + 5.0)
            except (ConnectionRefusedError,) as e:
                # nobody listening on a known port: the process is gone
                self._mark_dead(f"connection refused: {e}")
                raise
            except (ConnectionError, OSError, TimeoutError) as e:
                last = e
                if attempt < retries:
                    time.sleep(min(0.05 * (2 ** attempt), 0.5))
        raise last

    def _forget(self, rid):
        with self._live_lock:
            self._live.pop(str(rid), None)

    def _mark_dead(self, reason):
        """Liveness lost (heartbeat stall / connection refused): fail
        every in-flight request so the router's breaker and failover
        react exactly as they would to a local engine crash."""
        if self._dead.is_set():
            return
        self._dead_reason = reason
        self._dead.set()
        with self._live_lock:
            live = list(self._live.values())
            self._live.clear()
        for rr in live:
            rr._sever(reason)
        _flight.record("fleet.worker_dead", worker=self._worker,
                       replica=self.replica_id, reason=str(reason),
                       inflight=len(live))

    @property
    def alive(self):
        return not self._dead.is_set()

    # -- Replica duck-type ---------------------------------------------
    def prefill_eligible(self):
        return self.role in ("prefill", "both")

    def decode_eligible(self):
        return self.role in ("decode", "both")

    def stats(self):
        try:
            st = self._call(_rpc_stats, retries=self._retries)
        except (ConnectionError, OSError, TimeoutError):
            st = dict(self._last_stats)
            st.update(ready=False, closed=self._dead.is_set(),
                      queued=0, inflight=0, active=0)
            st["host"] = self.host
            return st
        st["host"] = self.host
        self._last_stats = dict(st)
        return st

    def load(self):
        try:
            return int(self._call(_rpc_load, retries=self._retries))
        except (ConnectionError, OSError, TimeoutError):
            return _DEAD_LOAD       # sorts last in every spill order

    def ready(self):
        try:
            return bool(self._call(_rpc_ready, retries=self._retries))
        except (ConnectionError, OSError, TimeoutError):
            return False

    def recent_requests(self, n=50):
        return self.scheduler.recent_requests(n)

    def submit(self, prompt_ids, **params):
        if self._dead.is_set():
            raise SchedulerClosedError(
                f"fleet: worker {self._worker!r} is dead "
                f"({self._dead_reason})")
        prompt_ids = [int(t) for t in prompt_ids]
        kv_import = params.pop("kv_import", None)
        if kv_import is not None:
            if isinstance(kv_import, RemoteHandoffRef):
                # reference only: the worker fetches the pages straight
                # from the source worker's bulk endpoint (host-to-host)
                params["kv_import_ref"] = {
                    "addr": list(kv_import.addr), "rid": kv_import.rid}
            else:
                # the payload lives in THIS process (local-replica
                # source): push it over the bulk channel, then submit
                # by token
                try:
                    _push_handoff(self.bulk_addr, kv_import,
                                  acct=self.wire_acct("bulk"))
                except (ConnectionError, OSError, TimeoutError) as e:
                    raise SchedulerClosedError(
                        f"fleet: handoff push to {self._worker!r} "
                        f"failed: {e}") from e
                params["kv_import_token"] = str(kv_import.rid)
        try:
            # a router-side span per dispatch: the rpc ships its trace
            # meta, so the worker's spans nest under this one in the
            # stitched fleet trace
            with _tc.span("fleet.submit",
                          args={"worker": self._worker,
                                "replica": self.replica_id}):
                spec = self._call(_rpc_submit, (prompt_ids, params))
        except (ConnectionError, OSError, TimeoutError) as e:
            raise SchedulerClosedError(
                f"fleet: worker {self._worker!r} unreachable: "
                f"{e}") from e
        rr = RemoteRequest(self, prompt_ids, spec)
        with self._live_lock:
            self._live[str(rr.rid)] = rr
        return rr

    # -- operational controls ------------------------------------------
    def pause(self):
        try:
            self._call(_rpc_pause, retries=self._retries)
        except (ConnectionError, OSError, TimeoutError):
            pass

    def resume(self):
        try:
            self._call(_rpc_resume, retries=self._retries)
        except (ConnectionError, OSError, TimeoutError):
            pass

    def drain(self, timeout=None):
        try:
            rpc_to = (timeout or 60.0) + 10.0
            return bool(self._call(_rpc_drain, (timeout,),
                                   timeout=rpc_to))
        except (ConnectionError, OSError, TimeoutError):
            return False

    def shutdown(self, drain=True, timeout=None):
        try:
            rpc_to = (timeout or 60.0) + 10.0
            return bool(self._call(_rpc_shutdown, (drain, timeout),
                                   timeout=rpc_to))
        except (ConnectionError, OSError, TimeoutError):
            # a dead worker is as shut down as it will ever be
            return self._dead.is_set()

    def kill(self):
        self._call(_rpc_kill)

    def revive(self):
        self._call(_rpc_revive)

    def __repr__(self):
        state = "dead" if self._dead.is_set() else "up"
        return (f"RemoteReplica({self.replica_id!r}, "
                f"worker={self._worker!r}, host={self.host!r}, {state})")


class FleetPlane:
    """Router-side fleet bring-up and liveness. Hosts the rendezvous
    store as rpc rank 0, waits for every expected worker's meta,
    builds the `RemoteReplica` pool (`.replicas` goes straight into
    `Router(...)`), and runs the heartbeat monitor: a worker whose
    store-key beat stalls past PT_FLEET_HB_MISS_S is marked dead —
    in-flight requests fail over, the breaker opens, dispatch skips
    it. Sequence-based liveness: no cross-host clock agreement
    needed."""

    def __init__(self, master_endpoint, workers, *, metrics=None,
                 hb_timeout_s=None, capture_dir=None):
        workers = list(workers)
        host, port = str(master_endpoint).rsplit(":", 1)
        self.master_endpoint = f"{host}:{int(port)}"
        self._store = _rpc._TCPStore(host, int(port), True)
        try:
            self._agent = _rpc.RpcAgent(ROUTER_NAME, 0,
                                        len(workers) + 1, self._store)
        except BaseException:
            self._store.stop()
            raise
        self.registry = metrics if isinstance(metrics, MetricsRegistry) \
            else MetricsRegistry()
        self.workers_gauge = self.registry.gauge(
            "pt_fleet_workers", "Fleet workers registered.")
        self.workers_alive = self.registry.gauge(
            "pt_fleet_workers_alive",
            "Fleet workers currently passing heartbeat liveness.")
        self.hb_misses = self.registry.counter(
            "pt_fleet_heartbeat_misses",
            "Workers declared dead after a stalled heartbeat.")
        self.replicas = []
        for name in workers:
            meta = self._store.get(f"fleet/meta/{name}")
            self.replicas.append(RemoteReplica(self._agent, name, meta))
        self.workers_gauge.set(len(self.replicas))
        self.workers_alive.set(len(self.replicas))
        self._hb_timeout = float(
            hb_timeout_s if hb_timeout_s is not None
            else env_float("PT_FLEET_HB_MISS_S"))
        self._stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="pt-fleet-monitor")
        self._monitor.start()

        # -- fleet observability ---------------------------------------
        # clock-skew estimation rides every rpc reply; the obs loop
        # polls worker trigger totals and fires fleet capture bundles
        self.clock = _fobs.ClockSkewEstimator()
        self._clock_gauges = {}      # worker -> (offset_g, unc_g)
        self._agent.on_clock_sample = self._on_clock_sample
        for rep in self.replicas:
            rep._wire_registry = self.registry
        self.capture_dir = capture_dir if capture_dir is not None \
            else (env_str("PT_FLEET_CAPTURE_DIR") or None)
        self.capture_max = env_int("PT_FLEET_CAPTURE_MAX")
        self.capture_min_s = env_float("PT_FLEET_CAPTURE_MIN_S")
        self.fleet_bundles = []
        self.fleet_captures = self.registry.counter(
            "pt_fleet_capture_bundles",
            "Fleet-wide capture bundles written on a worker pulse "
            "trigger.")
        self._bundle_lock = threading.Lock()
        self._bundle_last_t = 0.0
        self._trig_seen = {}         # worker -> last trigger totals
        self._obs_interval = env_float("PT_FLEET_OBS_POLL_S")
        # separate thread from _monitor_loop on purpose: an rpc stall
        # polling one worker must not delay heartbeat liveness checks
        self._obs_thread = threading.Thread(
            target=self._obs_loop, daemon=True, name="pt-fleet-obs")
        self._obs_thread.start()

    def replica(self, name_or_rid):
        for rep in self.replicas:
            if name_or_rid in (rep._worker, rep.replica_id):
                return rep
        return None

    # -- liveness -------------------------------------------------------
    def _hb_seq(self, name):
        # the plane hosts the master store: read the key directly
        # instead of dialing our own socket once per worker per tick
        st = self._store
        with st._cv:
            return st._data.get(f"fleet/hb/{name}")

    def _monitor_loop(self):
        interval = env_float("PT_FLEET_HB_S")
        seen = {}                    # worker -> (seq, t_last_change)
        while not self._stop.wait(interval):
            now = time.monotonic()
            n_alive = 0
            for rep in self.replicas:
                if rep._dead.is_set():
                    continue
                name = rep._worker
                seq = self._hb_seq(name)
                prev = seen.get(name)
                if prev is None or seq != prev[0]:
                    seen[name] = (seq, now)
                    n_alive += 1
                elif now - prev[1] > self._hb_timeout:
                    self.hb_misses.inc()
                    rep._mark_dead(
                        f"heartbeat stalled > {self._hb_timeout:g}s")
                else:
                    n_alive += 1
            self.workers_alive.set(n_alive)

    # -- fleet observability --------------------------------------------
    def _on_clock_sample(self, peer, t_send, t_remote, t_recv,
                         hold_s=0.0):
        """RpcAgent hook: one NTP-style sample per rpc reply. Feeds
        the EWMA estimator and the per-host offset gauges."""
        off, unc = self.clock.sample(peer, t_send, t_remote, t_recv,
                                     hold_s)
        g = self._clock_gauges.get(peer)
        if g is None:
            rep = self.replica(peer)
            host = (rep.host if rep is not None else None) or peer
            g = (self.registry.gauge(
                     "pt_fleet_clock_offset_seconds",
                     "EWMA-smoothed clock offset of a worker host "
                     "relative to the router (positive = worker clock "
                     "ahead).", labels={"host": host}),
                 self.registry.gauge(
                     "pt_fleet_clock_uncertainty_seconds",
                     "Half-RTT uncertainty bound on the worker "
                     "clock-offset estimate.", labels={"host": host}))
            # benign race: registry dedups by (name, labels)
            self._clock_gauges[peer] = g
        g[0].set(off)
        g[1].set(unc)

    def _obs_loop(self):
        """Poll each alive worker's pulse-trigger totals (one light
        rpc per worker per tick — the same round trips keep the clock
        estimator fed) and pull ONE fleet capture bundle when any
        worker reports a new trigger fire."""
        while not self._stop.wait(self._obs_interval):
            fired = None
            trace_ids = []
            for rep in self.replicas:
                if rep._dead.is_set():
                    continue
                try:
                    st = rep._call(_rpc_obs_triggers,
                                   timeout=self._obs_interval * 2)
                except (ConnectionError, OSError, TimeoutError):
                    continue
                cur = st.get("triggers") or {}
                prev = self._trig_seen.get(rep._worker)
                self._trig_seen[rep._worker] = cur
                if prev is None:
                    continue         # first poll: baseline only
                for trig in sorted(cur):
                    if float(cur[trig]) > float(prev.get(trig, 0)):
                        if fired is None:
                            fired = (trig, rep._worker)
                        break
                trace_ids.extend(st.get("trace_ids") or [])
            if fired is not None:
                try:
                    self._fleet_capture(fired[0], fired[1], trace_ids)
                except Exception as e:  # noqa: BLE001 — capture is best-effort
                    _flight.record("fleet.capture_error",
                                   trigger=fired[0], error=repr(e))

    def _fleet_capture(self, trigger, worker, trace_ids):
        """Rank 0's incident response: pull every worker's flight dump
        + pulse window + request ring into ONE bundle dir with
        per-host subdirs. Rate-limited; returns the path or None."""
        if self.capture_dir is None:
            return None
        now = time.monotonic()
        with self._bundle_lock:
            if len(self.fleet_bundles) >= self.capture_max:
                return None
            if self.fleet_bundles \
                    and now - self._bundle_last_t < self.capture_min_s:
                return None
            self._bundle_last_t = now
            seq = len(self.fleet_bundles)
            # reserve the slot before the (slow, networked) pull so a
            # second trigger in the same window rate-limits against it
            self.fleet_bundles.append(None)
        sections = self.obs_sections()
        stamp = time.strftime("%Y%m%d-%H%M%S")
        name = f"fleet-{stamp}-{seq:03d}-{trigger}-{os.getpid()}"
        meta = {"trigger": trigger, "worker": worker,
                "at": time.time(), "pid": os.getpid(),
                "trace_ids": list(dict.fromkeys(trace_ids)),
                "clock": self.clock.snapshot()}
        path = _fobs.write_fleet_bundle(self.capture_dir, name, meta,
                                        sections)
        with self._bundle_lock:
            self.fleet_bundles[seq] = path
        self.fleet_captures.inc()
        _flight.record("fleet.bundle", trigger=trigger, worker=worker,
                       path=path, trace_ids=meta["trace_ids"] or None)
        return path

    def obs_sections(self, window=None):
        """One section per fleet process: the router's own flight ring
        plus every alive worker's obs snapshot pulled over rpc (all
        network round trips happen OUTSIDE any lock). Each worker
        section carries the clock offset used to rebase it."""
        sections = [{
            "label": ROUTER_NAME,
            "host": socket.gethostname(),
            "replica_id": None,
            "offset_s": 0.0, "uncertainty_s": 0.0,
            "flight": _flight.snapshot(reason="fleet.obs"),
            "pulse": {"enabled": False},
            "requests": [],
        }]
        for rep in self.replicas:
            if rep._dead.is_set():
                continue
            try:
                snap = rep._call(_rpc_obs_snapshot, (window,))
            except (ConnectionError, OSError, TimeoutError):
                continue             # a dead worker is just absent
            snap["label"] = (f"{snap.get('replica_id')}"
                             f"@{snap.get('host')}")
            snap["offset_s"] = self.clock.offset(rep._worker)
            snap["uncertainty_s"] = self.clock.uncertainty(rep._worker)
            sections.append(snap)
        return sections

    def fleet_trace(self):
        """GET /debug/fleet/trace: one merged chrome-trace document,
        one process row per replica@host (plus the router), remote
        timestamps rebased onto the router clock, cross-process flow
        arrows per trace id."""
        sections = []
        for sec in self.obs_sections():
            spans = [e for e in
                     ((sec.get("flight") or {}).get("events") or [])
                     if e.get("kind") == "span"]
            sections.append({"label": sec["label"],
                             "offset_s": sec.get("offset_s", 0.0),
                             "spans": spans})
        return _fobs.stitch_fleet_trace(sections)

    def fleet_flightrecorder(self):
        """GET /debug/fleet/flightrecorder: every process's flight
        ring in one document — per-host sections plus one merged
        stream on the skew-corrected fleet clock."""
        return _fobs.merge_flight_sections(self.obs_sections())

    # -- lifecycle ------------------------------------------------------
    def shutdown_workers(self, drain=True, timeout=None):
        """Stop every worker process's replica + serve loop (the
        Router's own shutdown() does this too when it owns the
        replicas; this is the direct path for plane-only teardown)."""
        ok = True
        for rep in self.replicas:
            ok = rep.shutdown(drain=drain, timeout=timeout) and ok
        return ok

    def close(self):
        """Tear down the control plane (monitor, agent, store). Call
        after the Router/workers are shut down."""
        self._stop.set()
        try:
            self._agent.stop()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
        self._store.stop()


def connect_fleet(master_endpoint, workers, **kw):
    """Bring up the router side of a fleet: host the rendezvous at
    `master_endpoint`, wait for the named `workers`, return a
    `FleetPlane` whose `.replicas` drop straight into `Router(...)`
    (the module docstring has the topology)."""
    return FleetPlane(master_endpoint, workers, **kw)


# ---------------------------------------------------------------------------
# worker process entrypoint


def spawn_worker(spec, *, python=None, env=None, stdout=None,
                 stderr=None):
    """Launch one fleet worker as a subprocess:
    ``python -m paddle_tpu_torch.serving.fleet --spec '<json>'``. The spec
    is a plain-JSON dict:

      {"name": "w0", "master": "127.0.0.1:29500", "rank": 1,
       "world_size": 3, "role": "prefill", "seed": 0,
       "model": {<LlamaConfig fields>}, "dtype": "float32",
       "device": "cuda", "engine": {<ServingEngine kwargs>},
       "replica": {<Replica kw>}, "host": "optional-host-label"}

    The child builds its engine deterministically from
    (model, seed, dtype) on `device` ("cuda" unless the spec says
    "cpu") — the cross-process token-identity guarantee: same spec and
    device kind, same params, same trajectories."""
    import subprocess
    cmd = [python or sys.executable, "-m", "paddle_tpu_torch.serving.fleet",
           "--spec", json.dumps(spec)]
    e = dict(os.environ)
    if env:
        e.update(env)
    return subprocess.Popen(cmd, env=e, stdout=stdout, stderr=stderr)


def run_worker(spec):
    """Build engine + replica + FleetWorker from a spawn spec and
    serve until shut down. Model/engine imports live HERE — the
    serving package stays import-cycle-free. The engine runs on the
    spec's `device`, "cuda" by default (it raises without a card)."""
    import torch

    from ..models import llama_spmd as M
    from ..models.llama import LlamaConfig
    from ..models.llama_serving import ServingEngine
    from .replica import Replica

    cfg = LlamaConfig(**spec["model"])
    dtype = getattr(torch, spec.get("dtype", "float32"))
    device = spec.get("device", "cuda")
    params = M.init_params(cfg, seed=int(spec.get("seed", 0)),
                           dtype=dtype, device=device)
    engine = ServingEngine(params, cfg, dtype=dtype, device=device,
                           **(spec.get("engine") or {}))
    replica = Replica(spec.get("replica_id", spec["name"]), engine,
                      role=spec.get("role", "both"),
                      **(spec.get("replica") or {}))
    worker = FleetWorker(spec["name"], replica,
                         master_endpoint=spec["master"],
                         rank=int(spec["rank"]),
                         world_size=int(spec["world_size"]),
                         host=spec.get("host"))
    worker.serve_forever()
    # leave a breadcrumb: crashes dump via the install()ed handlers,
    # clean exits dump here — either way the worker's flight ring
    # survives the process and its path is on stderr
    try:
        path = _flight.dump(reason="fleet.worker_exit")
        print(f"fleet: worker {spec['name']} flight dump: {path}",
              file=sys.stderr, flush=True)
    except Exception:  # noqa: BLE001 — exit breadcrumb is best-effort
        pass
    return 0


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.fleet",
        description="Run one fleet worker process.")
    ap.add_argument("--spec", required=True,
                    help="worker spec as a JSON string, or @path to a "
                         "JSON file")
    args = ap.parse_args(argv)
    raw = args.spec
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    return run_worker(json.loads(raw))


if __name__ == "__main__":
    # re-enter through the CANONICAL module: running under `-m` loads
    # this file as __main__, but inbound rpc frames reference
    # `paddle_tpu_torch.serving.fleet._rpc_*` — the worker must register in
    # THAT module's _WORKERS, not a __main__ shadow copy
    from paddle_tpu_torch.serving import fleet as _canonical
    sys.exit(_canonical.main())
