"""Named-worker function RPC: the fleet plane's control plane
(counterpart of `paddle_tpu/distributed/rpc.py`, carried over as a copy:
it is standard library only, and its frames are the reference's).

Reference surface: python/paddle/distributed/rpc/rpc.py (init_rpc /
rpc_sync / rpc_async / get_worker_info / get_all_worker_infos /
get_current_worker_info / shutdown) over a TCPStore rendezvous and a
store-backed barrier, implemented as a threaded TCP layer:

  * `_TCPStore` — master-hosted key/value rendezvous with blocking
    `get` and atomic `add` (also the barrier primitive).
  * `RpcAgent` — per-process server thread executing pickled
    `(fn, args, kwargs)` frames in a thread pool; exceptions pickle
    back and re-raise at the caller.

The wire is pickle over a trusted network, as the reference's: run it
on a private interconnect. Functions travel by reference, so a callee
resolves them against its own imports.

Fleet observability rides this wire: request frames carry an optional
trailing meta dict with the caller's `trace_id`/`span_id` (the handler
executes under that trace context), and reply frames carry the server's
receive/send wall stamps `(t1, t2)` — one NTP-style clock sample per
round trip, delivered to `RpcAgent.on_clock_sample`. Both extensions
are length-tolerant: 3-tuple requests and 2-tuple replies still
interoperate.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
import traceback
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

__all__ = [
    "init_rpc",
    "shutdown",
    "rpc_sync",
    "rpc_async",
    "get_worker_info",
    "get_all_worker_infos",
    "get_current_worker_info",
    "RpcFrameError",
]

WorkerInfo = namedtuple("WorkerInfo", ["name", "rank", "ip", "port"])

_DEFAULT_RPC_TIMEOUT = -1
_LEN = struct.Struct("<I")
_MAX_FRAME = 1 << 30


class RpcFrameError(ConnectionError):
    """A frame over the `_MAX_FRAME` cap, refused on send (before any
    bytes hit the wire — the peer never sees a half-frame) or on recv
    (before allocating the body — a corrupt length prefix fails here,
    not in a giant allocation). Subclasses ConnectionError so existing
    socket-error handling keeps treating it as a dead wire."""


def _resolve_default_timeout(timeout):
    """The reference hardcodes -1 (wait forever) as rpc_sync's default;
    PT_RPC_TIMEOUT_S overrides that default so a hung peer fails in
    bounded time fleet-wide. An EXPLICIT timeout argument always wins —
    only the sentinel consults the env."""
    if timeout is _DEFAULT_RPC_TIMEOUT or timeout == _DEFAULT_RPC_TIMEOUT:
        env = os.environ.get("PT_RPC_TIMEOUT_S", "").strip()
        if env:
            try:
                return float(env)
            except ValueError:
                raise ValueError(
                    f"PT_RPC_TIMEOUT_S={env!r}: want seconds "
                    "(float)") from None
    return timeout


def _routable_ip():
    """The address this host routes external traffic from (no packets
    are sent — UDP connect just resolves the route)."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
    except OSError:
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"


def _recv_exact(sock, n):
    # its own read loop: rpc.py stays standard library only
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("rpc wire: peer closed")
        buf += chunk
    return buf


def _send_frame(sock, payload: bytes):
    if len(payload) > _MAX_FRAME:
        raise RpcFrameError(
            f"rpc wire: refusing to send frame of {len(payload)}B — "
            f"exceeds the {_MAX_FRAME}B cap (ship bulk data over a "
            "dedicated channel, e.g. serving/wire.py)")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_frame(sock) -> bytes:
    (n,) = _LEN.unpack(_recv_exact(sock, 4))
    if n > _MAX_FRAME:
        raise RpcFrameError(
            f"rpc wire: inbound frame header claims {n}B — exceeds "
            f"the {_MAX_FRAME}B cap (corrupt stream or oversized "
            "sender)")
    return _recv_exact(sock, n)


_tc = None


def _trace_mod():
    """The observability trace-context module, imported on first use
    so `import paddle_tpu_torch.distributed` stays cheap (the
    observability package is standard library only at import)."""
    global _tc
    if _tc is None:
        from ..observability import trace_context
        _tc = trace_context
    return _tc


def _trace_meta():
    """The calling thread's trace context as an rpc meta dict (or
    None). Must run on the CALLER's thread — contextvars do not cross
    the agent's outbound pool."""
    tc = _trace_mod()
    tid = tc.current_trace_id()
    if tid is None:
        return None
    return {"trace_id": tid, "span_id": tc.current_span_id()}


# ---------------------------------------------------------------------------
# rendezvous store


class _TCPStore:
    """Master-hosted key/value store (reference core.TCPStore).

    Ops: SET key val / GET key (blocks until the key exists) / ADD key
    delta (atomic int add, returns the new value). One request per
    connection — rendezvous traffic is a handful of tiny frames, and
    connection-per-op keeps the server loop trivially robust.
    """

    def __init__(self, host, port, is_master, timeout=900.0):
        self._addr = (host, port)
        self._timeout = timeout
        self._srv = None
        if is_master:
            self._data = {}
            self._cv = threading.Condition()
            self._stop = threading.Event()
            self._srv = socket.create_server(
                (host, port), reuse_port=False)
            self._srv.settimeout(0.2)
            self._thread = threading.Thread(
                target=self._serve, name="pt-rpc-store", daemon=True)
            self._thread.start()

    # -- master side --------------------------------------------------
    def _serve(self):
        # thread-per-connection, NOT a bounded pool: GET blocks until
        # the key appears, so at world_size > pool_size every pool
        # thread can be a blocked GET while the unblocking SET sits
        # queued behind them — a rendezvous deadlock. Store traffic is
        # a handful of tiny frames per worker; threads are cheap here.
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()
        self._srv.close()

    def _handle(self, conn):
        try:
            with conn:
                op, key, val = pickle.loads(_recv_frame(conn))
                if op == "set":
                    with self._cv:
                        self._data[key] = val
                        self._cv.notify_all()
                    _send_frame(conn, pickle.dumps(None))
                elif op == "add":
                    with self._cv:
                        new = int(self._data.get(key, 0)) + int(val)
                        self._data[key] = new
                        self._cv.notify_all()
                    _send_frame(conn, pickle.dumps(new))
                elif op == "get":
                    deadline = time.monotonic() + self._timeout
                    with self._cv:
                        while key not in self._data:
                            left = deadline - time.monotonic()
                            if left <= 0 or self._stop.is_set():
                                _send_frame(conn, pickle.dumps(
                                    KeyError(key)))
                                return
                            self._cv.wait(min(left, 0.5))
                        _send_frame(conn, pickle.dumps(self._data[key]))
        except (ConnectionError, OSError, pickle.UnpicklingError):
            pass  # rendezvous peer vanished; its retry/timeout handles it

    def stop(self):
        if self._srv is not None:
            self._stop.set()
            with self._cv:
                self._cv.notify_all()
            self._thread.join(timeout=5)

    # -- client side (works on master too: it dials its own server) ---
    def _request(self, op, key, val=None, timeout=None):
        deadline = time.monotonic() + (
            self._timeout if timeout is None else timeout)
        last = None
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"rpc store: {op} {key!r} timed out") from last
            try:
                s = socket.create_connection(
                    self._addr, timeout=min(left, 5.0))
            except OSError as e:
                # master may not be listening yet during bring-up —
                # retrying an unestablished connection is always safe
                last = e
                time.sleep(0.05)
                continue
            # past this point NOTHING retries: an `add` whose reply is
            # lost after the server applied it would double-increment
            # on re-send (set/get are idempotent; add is not)
            with s:
                s.settimeout(left)
                _send_frame(s, pickle.dumps((op, key, val)))
                out = pickle.loads(_recv_frame(s))
            if isinstance(out, KeyError):
                raise TimeoutError(
                    f"rpc store: key {key!r} never appeared")
            return out

    def set(self, key, val):
        return self._request("set", key, val)

    def get(self, key, timeout=None):
        return self._request("get", key, timeout=timeout)

    def add(self, key, delta):
        return self._request("add", key, delta)


# ---------------------------------------------------------------------------
# agent


class FutureWrapper:
    """Minimal future (reference _FutureWrapper protocol: .wait())."""

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._exc = None

    def _finish(self, result=None, exc=None):
        self._result, self._exc = result, exc
        self._done.set()

    def wait(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError("rpc future: no reply within timeout")
        if self._exc is not None:
            raise self._exc
        return self._result


class RpcAgent:
    """One named worker: a server thread executing inbound calls plus a
    client side issuing calls by worker NAME. Instantiable so tests can
    run several agents in one process; the module-level API drives a
    process singleton like the reference agent."""

    def __init__(self, name, rank, world_size, store, barrier=True):
        self.name = name
        self.rank = rank
        self.world_size = world_size
        self._store = store
        self._barrier_count = 0
        # clock-sample hook: called as (peer, t_send, t_remote, t_recv,
        # hold_s) after every reply carrying server stamps — the fleet
        # plane points this at its ClockSkewEstimator
        self.on_clock_sample = None
        self._pool = ThreadPoolExecutor(
            max_workers=int(os.environ.get("PT_RPC_THREADS", "8")),
            thread_name_prefix=f"pt-rpc-{name}")
        self._caller = ThreadPoolExecutor(
            max_workers=int(os.environ.get("PT_RPC_THREADS", "8")),
            thread_name_prefix=f"pt-rpc-out-{name}")
        self._stop = threading.Event()
        # inbound calls may arrive while this process is still mid-
        # rendezvous (a peer's barrier only proves RANK 0 finished, not
        # everyone): hold them until the agent is fully wired — for
        # init_rpc, until the module-level _agent is published, so a
        # remote fn calling get_current_worker_info() can't race it
        self._ready = threading.Event()
        host = os.environ.get("PT_RPC_BIND", "127.0.0.1")
        endpoint = os.environ.get("PADDLE_WORKER_ENDPOINT")
        if endpoint:
            host, port = endpoint.rsplit(":", 1)
            self._srv = socket.create_server((host, int(port)))
        else:
            self._srv = socket.create_server((host, 0))
        self._srv.settimeout(0.2)
        ip, port = self._srv.getsockname()[:2]
        if ip in ("0.0.0.0", "::"):
            # a wildcard bind must not be PUBLISHED: peers dialing
            # 0.0.0.0 connect to their own loopback. Advertise the
            # address this host routes out of (UDP connect needs no
            # packets), falling back to the hostname's resolution.
            ip = _routable_ip()
        self._thread = threading.Thread(
            target=self._serve, name=f"pt-rpc-srv-{name}", daemon=True)
        self._thread.start()

        try:
            # rendezvous: publish self, read everyone (reference
            # _set_self_info + _exchange_all_service_infos)
            store.set(f"worker/{rank}",
                      WorkerInfo(name, rank, ip, port))
            infos, seen = [], set()
            for r in range(world_size):
                info = store.get(f"worker/{r}")
                if info.name in seen:
                    raise ValueError(
                        f"rpc: worker name {info.name!r} is not unique")
                seen.add(info.name)
                infos.append(WorkerInfo(*info))
            self._infos = {i.name: i for i in infos}
            if barrier:
                self._ready.set()
                # all servers up before anyone issues a call
                self.barrier()
        except BaseException:
            # a half-built agent must not hold its port/threads — a
            # same-process retry would die with EADDRINUSE
            self.stop()
            raise

    # -- inbound ------------------------------------------------------
    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self._pool.submit(self._handle, conn)
        self._srv.close()

    def _handle(self, conn):
        try:
            with conn:
                if not self._ready.wait(timeout=900):
                    # the gate never opened (init failed or wedged):
                    # refuse the call instead of executing against a
                    # half-initialized agent
                    _send_frame(conn, pickle.dumps(
                        ("exc", RuntimeError(
                            f"rpc: agent {self.name!r} not ready within "
                            "900s; refusing inbound call"))))
                    return
                req = pickle.loads(_recv_frame(conn))
                fn, args, kwargs = req[0], req[1], req[2]
                meta = req[3] if len(req) > 3 else None
                t1 = time.time()   # server receipt (NTP-style sample)
                tc = _trace_mod() if meta and meta.get("trace_id") \
                    else None
                try:
                    if tc is not None:
                        with tc.bind(meta["trace_id"],
                                     parent_span=meta.get("span_id")):
                            value = fn(*args, **kwargs)
                    else:
                        value = fn(*args, **kwargs)
                    out = ("ok", value, t1, time.time())
                except Exception as e:  # noqa: BLE001 — ships to caller
                    e._rpc_remote_traceback = traceback.format_exc()
                    out = ("exc", e, t1, time.time())
                try:
                    payload = pickle.dumps(out)
                except Exception as e:  # unpicklable result/exception
                    payload = pickle.dumps(
                        ("exc", RuntimeError(
                            f"rpc: result not picklable: {e}"),
                         t1, time.time()))
                _send_frame(conn, payload)
        except (ConnectionError, OSError, pickle.UnpicklingError):
            pass  # caller vanished or garbage frame; nothing to answer

    # -- outbound -----------------------------------------------------
    def _note_clock(self, to, t_send, t1, t2, t_recv):
        cb = self.on_clock_sample
        if cb is None:
            return
        try:
            cb(to, t_send, (float(t1) + float(t2)) / 2.0, t_recv,
               max(float(t2) - float(t1), 0.0))
        except Exception:
            pass  # a broken estimator must never fail the call itself

    def _call(self, to, fn, args, kwargs, timeout, meta=None):
        info = self._infos.get(to)
        if info is None:
            raise ValueError(f"rpc: unknown worker {to!r}; known: "
                             f"{sorted(self._infos)}")
        payload = pickle.dumps((fn, args or (), kwargs or {}, meta))
        t_send = time.time()
        with socket.create_connection((info.ip, info.port),
                                      timeout=timeout) as s:
            if timeout is not None:
                s.settimeout(timeout)
            _send_frame(s, payload)
            rep = pickle.loads(_recv_frame(s))
        t_recv = time.time()
        status, value = rep[0], rep[1]
        if len(rep) > 3:   # reply carries server stamps (t1, t2)
            self._note_clock(to, t_send, rep[2], rep[3], t_recv)
        if status == "exc":
            remote_tb = getattr(value, "_rpc_remote_traceback", None)
            if remote_tb:
                value.args = (f"{value.args[0] if value.args else ''}"
                              f"\n[remote traceback]\n{remote_tb}",)
            raise value
        return value

    def invoke(self, to, fn, args, kwargs, timeout):
        fut = FutureWrapper()
        eff = None if timeout is None or timeout <= 0 else timeout
        # Trace context rides contextvars, which do NOT cross the
        # _caller pool boundary — capture it here, on the caller's
        # thread, and ship it inside the frame.
        meta = _trace_meta()

        def run():
            try:
                fut._finish(result=self._call(to, fn, args, kwargs, eff,
                                              meta))
            except BaseException as e:  # noqa: BLE001 — raises at wait()
                fut._finish(exc=e)

        self._caller.submit(run)
        return fut

    # -- lifecycle ----------------------------------------------------
    def barrier(self):
        """Store barrier (reference _barrier_never_timeout rpc.py:268):
        master flags first and leaves last so its store outlives every
        waiter."""
        if self.world_size < 2:
            return
        prefix = f"barrier/{self._barrier_count}/"
        self._barrier_count += 1
        if self.rank == 0:
            self._store.add(prefix + "0", 1)
            for r in range(1, self.world_size):
                self._store.get(prefix + str(r))
        else:
            self._store.get(prefix + "0")
            self._store.add(prefix + str(self.rank), 1)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self._pool.shutdown(wait=True)
        self._caller.shutdown(wait=True)

    def worker_info(self, name=None):
        if name is None:
            return self._infos[self.name]
        return self._infos[name]

    def all_worker_infos(self):
        return sorted(self._infos.values(), key=lambda i: i.rank)


_agent = None


def init_rpc(name, rank=None, world_size=None, master_endpoint=None):
    """reference rpc.py:86 init_rpc — TCPStore rendezvous at the master,
    WorkerInfo exchange, start server, barrier until every peer is up."""
    global _agent
    if _agent is not None:
        raise RuntimeError("rpc: already initialized; call shutdown() first")
    rank = int(os.environ["PADDLE_TRAINER_ID"]) if rank is None else rank
    world_size = (int(os.environ["PADDLE_TRAINERS_NUM"])
                  if world_size is None else world_size)
    master_endpoint = (master_endpoint
                       or os.environ["PADDLE_MASTER_ENDPOINT"])
    host, port = master_endpoint.rsplit(":", 1)
    timeout = float(os.environ.get("FLAGS_stop_check_timeout", "900"))
    store = _TCPStore(host, int(port), rank == 0, timeout=timeout)
    try:
        # publish the agent BEFORE the all-up barrier: our server
        # thread starts serving during rendezvous, and a fast peer may
        # deliver a call (which resolves module state like
        # get_current_worker_info through _agent) the moment ITS
        # barrier completes — publishing after would race that call
        # into 'init_rpc() has not been called'
        agent = RpcAgent(name, rank, world_size, store, barrier=False)
        _agent = agent
        agent._ready.set()   # inbound handlers may now resolve _agent
        agent.barrier()
    except BaseException:
        _agent = None
        # a failed init must release the master port so a corrected
        # retry in this process doesn't hit EADDRINUSE; the half-built
        # agent must release its port/threads too
        try:
            agent.stop()
        except Exception:   # incl. NameError when RpcAgent() itself threw
            pass
        store.stop()
        raise
    return _agent


def _require_agent():
    if _agent is None:
        raise RuntimeError("rpc: init_rpc() has not been called")
    return _agent


def rpc_sync(to, fn, args=None, kwargs=None, timeout=_DEFAULT_RPC_TIMEOUT):
    """Blocking call of fn(*args, **kwargs) on worker `to` (rpc.py:160).
    The default timeout is wait-forever (-1) unless PT_RPC_TIMEOUT_S
    sets a fleet-wide bound; an explicit `timeout` always wins."""
    timeout = _resolve_default_timeout(timeout)
    return _require_agent().invoke(to, fn, args, kwargs, timeout).wait()


def rpc_async(to, fn, args=None, kwargs=None, timeout=_DEFAULT_RPC_TIMEOUT):
    """Non-blocking variant returning a future with .wait() (rpc.py:206).
    Same PT_RPC_TIMEOUT_S default resolution as rpc_sync."""
    timeout = _resolve_default_timeout(timeout)
    return _require_agent().invoke(to, fn, args, kwargs, timeout)


def get_worker_info(name):
    return _require_agent().worker_info(name)


def get_all_worker_infos():
    return _require_agent().all_worker_infos()


def get_current_worker_info():
    return _require_agent().worker_info()


def shutdown():
    """Barrier (all outstanding work done everywhere), stop the server,
    destroy the agent (rpc.py:316). Master's store stops last.

    The agent stays PUBLISHED through the barrier: a fast rank reaches
    shutdown while slower peers are still issuing calls, and those
    inbound calls may resolve module state (get_current_worker_info) —
    un-publishing first made them fail with 'init_rpc() has not been
    called' under load (the start-side twin of this race is handled by
    the _ready gate)."""
    global _agent
    if _agent is None:
        return
    agent = _agent
    agent.barrier()          # every peer is done issuing work
    _agent = None
    agent.stop()
    if agent.rank == 0:
        agent._store.stop()
