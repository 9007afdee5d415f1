"""Distributed runtime (counterpart of `paddle_tpu/distributed`).

`rpc` — named-worker function RPC and its rendezvous store, the fleet
plane's control plane (`serving/fleet.py`). `env` — the process group
(`init_parallel_env`, ranks, the global mesh); `collective` — the
collectives over a mesh axis's group, and their differentiable forms;
`launch` — starting the ranks (`spawn`, `python -m
paddle_tpu_torch.distributed.launch`). `fleet`, `sharding` and
`parallel_wrappers` are ROADMAP.md Queue 1 item 12b.
"""
from . import collective, env, rpc  # noqa: F401
from .collective import (  # noqa: F401
    Group, ReduceOp, all_gather, all_reduce, alltoall, alltoall_single,
    barrier, broadcast, get_backend, get_group, new_group, p2p_ppermute,
    recv, reduce_scatter, send,
)
from .env import (  # noqa: F401
    get_rank, get_world_size, init_parallel_env,
)
from .rpc import (  # noqa: F401
    RpcFrameError, get_all_worker_infos, get_current_worker_info,
    get_worker_info, init_rpc, rpc_async, rpc_sync, shutdown,
)

__all__ = list(rpc.__all__) + [
    "Group", "ReduceOp", "all_gather", "all_reduce", "alltoall",
    "alltoall_single", "barrier", "broadcast", "get_backend", "get_group",
    "get_rank", "get_world_size", "init_parallel_env", "new_group",
    "p2p_ppermute", "recv", "reduce_scatter", "send"]
