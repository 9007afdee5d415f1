"""Distributed runtime (counterpart of `paddle_tpu/distributed`).

`rpc` — named-worker function RPC and its rendezvous store, the fleet
plane's control plane (`serving/fleet.py`). `env` — the process group
(`init_parallel_env`, ranks, the global mesh); `collective` — the
collectives over a mesh axis's group, and their differentiable forms;
`launch` — starting the ranks (`spawn`, `python -m
paddle_tpu_torch.distributed.launch`); `fleet` — the fleet facade
(`fleet.init` builds the rank mesh from a strategy's degrees);
`parallel_wrappers` — `DataParallel`; `sharding` —
`group_sharded_parallel`, the ZeRO stages the parallel Trainer honours.
The parameter server (`ps`), `auto_parallel` and `extras` are ROADMAP.md
Queue 1 item 12c.
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
from . import fleet  # noqa: F401,E402
from .parallel_wrappers import DataParallel  # noqa: F401,E402
from .sharding import group_sharded_parallel, save_group_sharded_model  # noqa: F401,E402

__all__ = list(rpc.__all__) + [
    "Group", "ReduceOp", "all_gather", "all_reduce", "alltoall",
    "alltoall_single", "barrier", "broadcast", "get_backend", "get_group",
    "get_rank", "get_world_size", "init_parallel_env", "new_group",
    "p2p_ppermute", "recv", "reduce_scatter", "send", "fleet",
    "DataParallel", "group_sharded_parallel", "save_group_sharded_model"]
