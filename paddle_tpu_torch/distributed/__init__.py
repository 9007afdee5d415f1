"""Distributed runtime (counterpart of `paddle_tpu/distributed`).

`rpc` — named-worker function RPC and its rendezvous store, the fleet
plane's control plane (`serving/fleet.py`). The collectives come with
ROADMAP.md Queue 1 item 12.
"""
from . import rpc  # noqa: F401
from .rpc import (  # noqa: F401
    RpcFrameError, get_all_worker_infos, get_current_worker_info,
    get_worker_info, init_rpc, rpc_async, rpc_sync, shutdown,
)

__all__ = list(rpc.__all__)
