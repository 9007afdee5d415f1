"""The serving runtime over the continuous-batching engine
(`models.llama_serving.ServingEngine`), counterpart of
`paddle_tpu/serving`:

  * `metrics`   — counters, gauges and histograms; Prometheus text and
                  a JSON snapshot; `EngineMetrics` is the hook object
                  the engine's step loop reports into;
  * `kvcache`   — the ref-counted page pool and the prefix cache;
  * `kvtier`    — the host-RAM KV tier and the preemption stash;
  * `handoff`   — `KVHandoff`, the KV payload of disaggregated
                  prefill / decode;
  * `faults`    — a seeded `FaultPlan` (PT_FAULTS or a constructor
                  argument) armed at the stack's real failure sites;
  * `timeline`  — per-request phase timelines, SLO classes and the
                  step-time anomaly sentinel;
  * `scheduler` — the thread-safe request queue: priorities, deadlines,
                  cancellation, backpressure, the synchronous and
                  pipelined pumps and crash recovery;
  * `replica`   — one engine + scheduler + metrics behind the surface
                  the router dispatches to;
  * `router`    — prefix-affinity dispatch over N replicas, failover and
                  drain;
  * `wire`      — length-framed socket framing for the fleet bulk
                  channel: JSON control frames and raw array bytes,
                  never pickle (the reference's frames, byte for byte);
  * `fleet`     — the multi-host plane over `distributed/rpc.py`:
                  `FleetWorker` processes serve replicas remotely,
                  `RemoteReplica` proxies satisfy the `Replica`
                  duck-type for an unchanged `Router`, KV handoffs and
                  spilled prefix pages move host to host over the bulk
                  channel (one global prefix cache);
  * `server`    — the stdlib HTTP frontend (`/v1/completions`,
                  `/healthz`, `/readyz`, `/metrics`, `/debug/*`);
  * `client`    — the stdlib HTTP client, SSE streaming included.

On the CPU: `RequestScheduler(ServingEngine(params, cfg, device="cpu"))`,
then `ServingServer(sched, port=0)` and `ServingClient(url).complete(...)`;
a fleet: `FleetWorker`s over `Replica`s, `connect_fleet(endpoint, names)`
and `Router(plane.replicas, fleet=plane)`.
No module here imports the engine at import time.
"""
from __future__ import annotations

from . import (  # noqa: F401
    client, faults, fleet, handoff, kvcache, kvtier, metrics, replica,
    router, scheduler, server, timeline, wire,
)
from .client import ServingClient, ServingHTTPError  # noqa: F401
from .faults import FaultPlan, InjectedFault  # noqa: F401
from .fleet import (  # noqa: F401
    FleetPages, FleetPlane, FleetWorker, RemoteHandoffRef, RemoteReplica,
    RemoteRequest, connect_fleet, spawn_worker,
)
from .handoff import KVHandoff  # noqa: F401
from .kvcache import PagePool, PrefixCache  # noqa: F401
from .kvtier import HostTier  # noqa: F401
from .metrics import (  # noqa: F401
    Counter, EngineMetrics, Gauge, Histogram, MetricsRegistry,
)
from .replica import (  # noqa: F401
    Replica, ReplicaKilledError, build_replicas,
)
from .router import Router, RouterRequest, prefix_key  # noqa: F401
from .scheduler import (  # noqa: F401
    BackpressureError, CrashLoopError, DeadlineExceededError,
    PoisonedRequestError, RequestScheduler, SchedulerClosedError,
    SchedulerError, ServingRequest,
)
from .server import ServingServer  # noqa: F401
from .timeline import (  # noqa: F401
    StepAnomalySentinel, Timeline, judge_slo, resolve_slo, slo_targets,
)
from .wire import WireError  # noqa: F401

__all__ = [
    "client", "faults", "fleet", "handoff", "kvcache", "kvtier",
    "metrics", "replica", "router", "scheduler", "server", "timeline",
    "wire",
    "Timeline", "StepAnomalySentinel",
    "resolve_slo", "slo_targets", "judge_slo",
    "ServingClient", "ServingHTTPError",
    "FaultPlan", "InjectedFault", "KVHandoff",
    "PagePool", "PrefixCache", "HostTier",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "EngineMetrics",
    "Replica", "ReplicaKilledError", "build_replicas",
    "Router", "RouterRequest", "prefix_key",
    "RequestScheduler", "ServingRequest", "SchedulerError",
    "BackpressureError", "DeadlineExceededError", "SchedulerClosedError",
    "PoisonedRequestError", "CrashLoopError",
    "ServingServer",
    "WireError", "FleetWorker", "FleetPages", "FleetPlane",
    "RemoteReplica", "RemoteRequest", "RemoteHandoffRef",
    "connect_fleet", "spawn_worker",
]
