"""Distributed environment state (counterpart of
`paddle_tpu/distributed/env.py`).

The JAX package is single-controller: one process drives every chip and
a "rank" is a host. Here a rank is a process on `torch.distributed`, one
per card over NCCL, or several on the CPU (or sharing one card) over
gloo. `init_parallel_env` joins the process group from the rank
environment that `distributed/launch.py` sets (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `PT_DIST_INIT`, `PT_DIST_BACKEND`), or from its
arguments; a failed rendezvous raises rather than leaving a rank to
train alone."""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

_global_mesh = None


def init_parallel_env(backend=None, init_method=None, rank=None,
                      world_size=None, timeout_s=120.0):
    """Join the process group; returns this process's rank.

    backend: "nccl" (one rank per card) or "gloo" (CPU ranks, or ranks
    sharing one card, whose CUDA tensors `collective.py` stages through
    pinned host buffers). None reads `PT_DIST_BACKEND`; with neither set
    it raises: the backend is never chosen here. init_method: a
    `file://` or `tcp://` URL (None reads `PT_DIST_INIT`). rank and
    world_size default to `RANK` and `WORLD_SIZE`.

    A process without `WORLD_SIZE` and without arguments is a world of
    one: nothing is initialised and 0 is returned. A rendezvous that
    fails (or times out after `timeout_s`) raises RuntimeError."""
    if dist.is_initialized():
        return dist.get_rank()
    env_world = os.environ.get("WORLD_SIZE")
    if world_size is None and env_world is None and init_method is None:
        return 0
    backend = backend or os.environ.get("PT_DIST_BACKEND")
    if backend not in ("nccl", "gloo"):
        raise ValueError(
            "init_parallel_env: name the backend, 'nccl' (one rank per "
            "card) or 'gloo' (CPU ranks, or ranks sharing a card), as "
            f"backend= or PT_DIST_BACKEND (got {backend!r})")
    init_method = init_method or os.environ.get("PT_DIST_INIT")
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    world_size = int(world_size if world_size is not None
                     else env_world or 1)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    try:
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(
            f"init_parallel_env: the rendezvous failed (backend={backend}, "
            f"init_method={init_method}, rank={rank}, world_size="
            f"{world_size}); refusing to continue as a single-process "
            "trainer") from e
    return rank


def get_rank(group=None):
    return dist.get_rank(group) if dist.is_initialized() else 0


def get_world_size(group=None):
    return dist.get_world_size(group) if dist.is_initialized() else 1


def is_initialized():
    return dist.is_initialized()


def set_global_mesh(mesh):
    global _global_mesh
    _global_mesh = mesh


def get_global_mesh():
    return _global_mesh
