"""The fleet facade (counterpart of `paddle_tpu/distributed/fleet`;
reference: python/paddle/distributed/fleet/fleet.py).

`fleet.init(strategy)` joins the process group (`init_parallel_env`,
from the launcher's environment) and builds the rank mesh from
`hybrid_configs`' degrees and the world size, by the JAX package's
rules: a pp axis when pp_degree > 1, then dp, then tp (mp_degree) when
> 1; a dp_degree that does not cover the world is widened to it. Degrees
that ask for more ranks than the world has raise ValueError (the JAX
package shrinks dp to fit; a port rank never trains alone).
`HybridCommunicateGroup` answers with this rank's coordinates and the
real `Group` of each axis (the JAX package's answers rank 0 and
axis-name groups: ROADMAP.md Queue 3). `distributed_model` wraps the
model in `DataParallel`; the parallel `Trainer` trains it on the mesh.

The parameter-server roles (a server role maker, `init_server`,
`run_server`, `init_worker`) stand on the reference's
`distributed/ps_impl.py`, which is not ported: they raise
NotImplementedError naming ROADMAP.md Queue 1 item 12c.
"""
from __future__ import annotations

import os

from .. import collective as _C
from .. import env as _env
from ...parallel.mesh import create_mesh


def _ps_not_ported(what):
    return NotImplementedError(
        f"paddle_tpu_torch: {what} stands on the parameter-server runtime "
        "(the reference's distributed/ps_impl.py), which is not ported "
        "yet (ROADMAP.md, Queue 1 item 12c)")


class DistributedStrategy:
    """reference: paddle.distributed.fleet.DistributedStrategy (protobuf);
    here a plain config object with the same field names."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1, "ep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.lamb = False
        self.dgc = False
        self.find_unused_parameters = False


class HybridCommunicateGroup:
    """Topology (reference: fleet/base/topology.py) over the rank mesh:
    each axis's size, this rank's coordinate on it and its group (a
    group of this rank alone for an axis the mesh lacks)."""

    def __init__(self, mesh):
        self._mesh = mesh
        self._shape = dict(mesh.shape)

    def _axis(self, name, default=1):
        return self._shape.get(name, default)

    def _group(self, name):
        if name in self._shape:
            return self._mesh.group(name)
        return _C.Group([self._mesh.rank], axis_name=name)

    def get_data_parallel_world_size(self):
        return self._axis("dp")

    def get_model_parallel_world_size(self):
        return self._axis("tp")

    def get_pipe_parallel_world_size(self):
        return self._axis("pp")

    def get_sharding_parallel_world_size(self):
        return self._axis("dp")  # sharding rides the dp axis

    def get_data_parallel_rank(self):
        return self._mesh.coord("dp")

    def get_model_parallel_rank(self):
        return self._mesh.coord("tp")

    def get_stage_id(self):
        return self._mesh.coord("pp")

    def get_sharding_parallel_rank(self):
        return self._mesh.coord("dp")

    def get_data_parallel_group(self):
        return self._group("dp")

    def get_model_parallel_group(self):
        return self._group("tp")

    def get_pipe_parallel_group(self):
        return self._group("pp")

    def get_sharding_parallel_group(self):
        return self._group("dp")

    def get_check_parallel_group(self, *a):
        return _C.get_group()

    def topology(self):
        return self._shape


class PaddleCloudRoleMaker:
    """Role resolution for parameter-server launches (reference:
    fleet/base/role_maker.py): PT_PS_ROLE (preferred) or TRAINING_ROLE;
    'server' / 'pserver' puts this process in the server tier, anything
    else makes it a worker."""

    def __init__(self, is_collective=False, **kwargs):
        self._is_collective = is_collective
        role = os.environ.get("PT_PS_ROLE",
                              os.environ.get("TRAINING_ROLE", "worker"))
        self._role = role.lower()

    def is_server(self):
        return not self._is_collective and \
            self._role in ("server", "pserver", "ps")

    def is_worker(self):
        return not self.is_server()


class UserDefinedRoleMaker:
    """Explicit-role variant (reference: fleet/base/role_maker.py):
    role is 'server' / 'pserver' or 'worker' (case-insensitive)."""

    def __init__(self, current_id=0, role="worker", worker_num=1,
                 server_endpoints=None, **k):
        self.current_id = current_id
        self.worker_num = worker_num
        self.server_endpoints = server_endpoints or []
        self._role = str(role).lower()

    def is_server(self):
        return self._role in ("server", "pserver", "ps")

    def is_worker(self):
        return not self.is_server()


class _Fleet:
    def __init__(self):
        self._strategy = None
        self._hcg = None
        self._mesh = None
        self._is_initialized = False
        self._role_maker = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO"):
        self._role_maker = role_maker
        if role_maker is not None and role_maker.is_server():
            raise _ps_not_ported("fleet.init with a server role")
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        _env.init_parallel_env()
        n = _env.get_world_size()
        dp = int(hc.get("dp_degree", 1) or 1)
        tp = int(hc.get("mp_degree", 1) or 1)
        pp = int(hc.get("pp_degree", 1) or 1)
        if dp * tp * pp > n:
            raise ValueError(
                f"fleet.init: hybrid_configs ask for dp {dp} x mp {tp} x pp "
                f"{pp} = {dp * tp * pp} ranks and the world has {n}: start "
                "the ranks with `python -m paddle_tpu_torch.distributed."
                "launch --nproc N --backend ...`")
        if dp * tp * pp != n:
            if n % (tp * pp) == 0:
                dp = n // (tp * pp)
            else:
                tp = pp = 1
                dp = n
        axes = {}
        if pp > 1:
            axes["pp"] = pp
        axes["dp"] = dp
        if tp > 1:
            axes["tp"] = tp
        self._mesh = create_mesh(axes)
        self._hcg = HybridCommunicateGroup(self._mesh)
        self._is_initialized = True
        return self

    def is_first_worker(self):
        return _env.get_rank() == 0

    def worker_index(self):
        return _env.get_rank()

    def worker_num(self):
        return _env.get_world_size()

    def get_hybrid_communicate_group(self):
        return self._hcg

    def get_mesh(self):
        return self._mesh

    def pipeline_schedule(self):
        """The schedule of strategy.pipeline_configs['schedule_mode']
        ('F-then-B' is GPipe, '1F1B', 'interleave'; 1F1B with a
        virtual_pp_degree > 1 is the interleaved schedule), for
        `models.llama_spmd.make_train_step(schedule=)`. An unknown mode
        raises ValueError."""
        cfgs = getattr(self._strategy, "pipeline_configs", None) or {}
        mode = str(cfgs.get("schedule_mode", "F-then-B"))
        table = {"1f1b": "1f1b", "f-then-b": "gpipe",
                 "interleave": "interleave"}
        if mode.lower() not in table:
            # never silently downgrade: a user who asked for a schedule
            # that is not implemented must not find out from the memory
            # profile of another
            raise ValueError(
                f"pipeline_configs schedule_mode={mode!r} is not "
                "supported: use '1F1B', 'F-then-B' (GPipe), or "
                "'interleave'")
        sched = table[mode.lower()]
        if sched == "1f1b" and self.virtual_pp_degree() > 1:
            sched = "interleave"
        return sched

    def virtual_pp_degree(self):
        """hybrid_configs' virtual pipeline degree (chunks a stage); 1 =
        the plain schedules."""
        hc = getattr(self._strategy, "hybrid_configs", None) or {}
        pp_cfgs = hc.get("pp_configs") or {}
        if isinstance(pp_cfgs, dict) and "virtual_pp_degree" in pp_cfgs:
            return int(pp_cfgs["virtual_pp_degree"] or 1)
        return int(hc.get("virtual_pp_degree", 1) or 1)

    def distributed_model(self, model):
        from ..parallel_wrappers import DataParallel
        return DataParallel(model)

    def distributed_optimizer(self, optimizer, strategy=None):
        return optimizer

    def distributed_scaler(self, scaler):
        return scaler

    @property
    def worker_endpoints(self):
        return [f"proc{i}" for i in range(_env.get_world_size())]

    def barrier_worker(self):
        _C.barrier()

    # the parameter-server entry points (reference: fleet.init_server /
    # run_server / init_worker / stop_worker over the_one_ps)
    def is_server(self):
        return self._role_maker is not None and self._role_maker.is_server()

    def is_worker(self):
        return self._role_maker is None or self._role_maker.is_worker()

    def init_server(self, tables=None, **kw):
        raise _ps_not_ported("fleet.init_server")

    def run_server(self):
        raise _ps_not_ported("fleet.run_server")

    def init_worker(self, n_tables=1):
        raise _ps_not_ported("fleet.init_worker")

    def stop_worker(self):
        """Nothing to stop: no parameter-server client is ever started."""

    def save_inference_model(self, *a, **k):
        pass

    def save_persistables(self, *a, **k):
        pass


fleet = _Fleet()
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
distributed_scaler = fleet.distributed_scaler
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_server = fleet.is_server
is_worker = fleet.is_worker
init_server = fleet.init_server
run_server = fleet.run_server
init_worker = fleet.init_worker
stop_worker = fleet.stop_worker

from ...parallel.pp import LayerDesc, SharedLayerDesc, PipelineLayer  # noqa: E402,F401
from ...parallel.tp import (  # noqa: E402,F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding,
)


class meta_parallel:
    """Namespace parity: fleet.meta_parallel.* layers."""
    ColumnParallelLinear = ColumnParallelLinear
    RowParallelLinear = RowParallelLinear
    VocabParallelEmbedding = VocabParallelEmbedding
    ParallelCrossEntropy = ParallelCrossEntropy
    LayerDesc = LayerDesc
    SharedLayerDesc = SharedLayerDesc
    PipelineLayer = PipelineLayer


def _rng_state():
    from ..._core.state import prng
    return prng._eager_counter, [e[1] for e in prng._ctx_stack]


def _set_rng_state(state):
    from ..._core.state import prng
    prng._eager_counter = state[0]
    for e, c in zip(prng._ctx_stack, state[1]):
        e[1] = c


def recompute(function, *args, **kwargs):
    """reference: fleet.recompute, activation rematerialisation:
    `function(*args, **kwargs)` under `torch.utils.checkpoint`
    (non-reentrant), so its activations are recomputed in the backward;
    a Layer's parameters get their gradients as in a plain call. The
    recompute draws the same keys as the first run (the key stream's
    counters are set back for it)."""
    from torch.utils.checkpoint import checkpoint
    from ..._core.tensor import Tensor
    kwargs.pop("preserve_rng_state", None)
    kwargs.pop("use_reentrant", None)
    where = [i for i, a in enumerate(args) if isinstance(a, Tensor)]
    first = {}

    def pure(*raws):
        rebuilt = list(args)
        for i, r in zip(where, raws):
            rebuilt[i] = Tensor(r, stop_gradient=args[i].stop_gradient)
        saved = None
        if "rng" in first:
            saved = _rng_state()
            _set_rng_state(first["rng"])
        else:
            first["rng"] = _rng_state()
        try:
            out = function(*rebuilt, **kwargs)
        finally:
            if saved is not None:
                _set_rng_state(saved)
        if isinstance(out, (list, tuple)):
            return type(out)(o._value if isinstance(o, Tensor) else o
                             for o in out)
        return out._value if isinstance(out, Tensor) else out

    out = checkpoint(pure, *(args[i]._value for i in where),
                     use_reentrant=False)
    if isinstance(out, (list, tuple)):
        return type(out)(Tensor(o) if hasattr(o, "shape") else o
                         for o in out)
    return Tensor(out)


Fleet = _Fleet  # class name export (reference: base/fleet_base.Fleet)


class Role:
    """reference: fleet Role enum (WORKER/SERVER)."""
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class CommunicateTopology:
    """reference: fleet.base.topology.CommunicateTopology: named-axis
    rank bookkeeping."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "sep", "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._names = list(hybrid_group_names)
        self._dims = list(dims)

    def get_hybrid_group_names(self):
        return self._names

    def get_dim(self, axis_name):
        return self._dims[self._names.index(axis_name)]

    def world_size(self):
        n = 1
        for d in self._dims:
            n *= d
        return n

    def get_rank(self, **axis_ranks):
        rank, stride = 0, 1
        for name, dim in zip(reversed(self._names), reversed(self._dims)):
            rank += axis_ranks.get(name, 0) * stride
            stride *= dim
        return rank

    def get_coord(self, rank):
        coord = []
        for name, dim in zip(reversed(self._names), reversed(self._dims)):
            coord.append(rank % dim)
            rank //= dim
        return list(reversed(coord))


class UtilBase:
    """reference: fleet.UtilBase: barrier / all-gather utilities over the
    world."""

    def barrier(self, comm_world="worker"):
        _C.barrier()

    def all_gather(self, input, comm_world="worker"):
        import torch.distributed as dist
        n = _env.get_world_size()
        if n == 1:
            return [input]
        out = [None] * n
        dist.all_gather_object(out, input)
        return out

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        import numpy as np
        import torch
        from ..._core.tensor import Tensor
        op = {"sum": _C.ReduceOp.SUM, "max": _C.ReduceOp.MAX,
              "min": _C.ReduceOp.MIN}.get(mode, _C.ReduceOp.SUM)
        if isinstance(input, Tensor):
            return Tensor(_C.all_reduce(input._value.clone(), op))
        t = torch.as_tensor(np.asarray(input))
        return _C.all_reduce(t.clone(), op).numpy().tolist()

    def get_file_shard(self, files):
        r, w = _env.get_rank(), max(_env.get_world_size(), 1)
        return files[r::w]

    def print_on_rank(self, message, rank_id=0):
        if _env.get_rank() == rank_id:
            print(message)


_PS_DATAGEN = "MultiSlot*DataGenerator (the parameter-server dataset feed)"


class MultiSlotDataGenerator:
    def __init__(self, *a, **kw):
        raise _ps_not_ported(_PS_DATAGEN)


class MultiSlotStringDataGenerator:
    def __init__(self, *a, **kw):
        raise _ps_not_ported(_PS_DATAGEN)


from . import utils  # noqa: E402,F401  (fleet.utils: LocalFS/HDFSClient/recompute)
