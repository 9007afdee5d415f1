"""Collective communication on torch tensors (counterpart of
`paddle_tpu/distributed/collective.py`).

The JAX package runs one program over a mesh and GSPMD inserts the
collectives; here each rank is a process and every collective is an
explicit call on `torch.distributed`, over a `Group` (one per mesh axis,
`parallel/mesh.py`). Paddle's surface: `all_reduce`, `all_gather`,
`reduce_scatter`, `broadcast`, `alltoall`, `alltoall_single`, `send`,
`recv`, `barrier`, `p2p_ppermute` (the ring transfer of `lax.ppermute`),
`new_group`, `get_group`, `get_backend`. Ranks in a group are named by
their global rank (`send`, `recv`, `broadcast`) or, for `p2p_ppermute`,
by their index in the group, as mesh-axis indices are in JAX.

Backends. NCCL carries CUDA tensors, one rank per card. Gloo carries
CPU tensors; ranks sharing one card run gloo, and every collective here
stages their CUDA tensors through pinned host buffers and copies the
result back to the card (gloo takes CUDA tensors for only a few ops).
The backend is the process group's, as `init_parallel_env` was given it.

Differentiable collectives, for what a train step differentiates:
`copy_to_group` (identity forward, all-reduce backward) and
`reduce_from_group` (all-reduce forward, identity backward), Megatron's
pair; `gather_from_group` (all-gather forward, this rank's block of
the gradient backward) and `scatter_to_group` (the converse);
`all_to_all` (backward: the inverse all-to-all); `ppermute`
(backward: the inverse permutation). Under activation checkpointing a
layer's collectives run again in the recompute, in the same order on
every rank.

Counters, plain integers on this module as the kernels' launches are:
`calls`, `bytes_sent` (what this rank puts on the wire under the ring
algorithms: 2 (n-1)/n of the buffer for an all-reduce, (n-1) pieces
for an all-gather, (n-1)/n of the input for a reduce-scatter or an
all-to-all, the tensor for a send, a broadcast's source or a ppermute
to another rank) and `seconds` (host clock around each call, staging
copies included; an NCCL call returns when it is queued)."""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from . import env

calls = 0
bytes_sent = 0
seconds = 0.0


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT}


class Group:
    """A set of ranks and its process group. `ranks` are global ranks in
    the group's order; `rank` is this process's index in it (-1 when it
    is not a member); `axis_name` names the mesh axis it spans."""

    def __init__(self, ranks, process_group=None, axis_name=None, id=0):
        self.ranks = [int(r) for r in ranks]
        self.process_group = process_group
        self.axis_name = axis_name
        self.id = id
        self._backend = None

    @property
    def nranks(self):
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self):
        me = env.get_rank()
        return self.ranks.index(me) if me in self.ranks else -1

    def get_group_rank(self, rank):
        return self.ranks.index(rank)

    @property
    def backend(self):
        if self._backend is None:
            self._backend = dist.get_backend(self.process_group)
        return self._backend

    def __repr__(self):
        return f"Group(axis={self.axis_name!r}, ranks={self.ranks})"


_world = None


def new_group(ranks=None, backend=None, timeout=None, axis_name=None):
    """A group over `ranks` (global ranks; None: every rank). Every rank
    of the world calls it, in the same order, members or not."""
    if ranks is None:
        return get_group()
    ranks = [int(r) for r in ranks]
    pg = None
    if dist.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(ranks, backend=backend, **kw)
    return Group(ranks, pg, axis_name, id=len(ranks))


def get_group(gid=0):
    """The world's group."""
    global _world
    n = env.get_world_size()
    if _world is None or _world.nranks != n:
        _world = Group(range(n), dist.group.WORLD if dist.is_initialized()
                       else None, id=0)
    return _world


def _group(group):
    return get_group() if group is None else group


def _live(group, opname):
    """True when the collective must communicate (more than one rank)."""
    if group.nranks == 1:
        return False
    if not dist.is_initialized():
        raise RuntimeError(
            f"{opname} over {group}: torch.distributed is not initialised; "
            "call init_parallel_env (or start the ranks with "
            "paddle_tpu_torch.distributed.launch)")
    return True


def _staged(group, t):
    """Whether `t` must go through a host buffer: a CUDA tensor on a
    gloo group."""
    return t.is_cuda and group.backend == "gloo"


def _host(t, copy=True):
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if copy:
        h.copy_(t)
    return h


def _wire(group, t, copy=True):
    """The buffer the backend reads or writes for `t`: t itself (made
    contiguous), or a pinned host copy of it."""
    t = t.contiguous()
    return _host(t, copy) if _staged(group, t) else t


class _Clock:
    def __init__(self, nbytes):
        self.nbytes = nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global calls, bytes_sent, seconds
        calls += 1
        bytes_sent += int(self.nbytes)
        seconds += time.perf_counter() - self.t0
        return False


def _nbytes(t):
    return t.numel() * t.element_size()


# ---------------------------------------------------------------- Paddle API
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce `tensor` over the group, IN PLACE; returns it. AVG is a
    sum divided by the group's size (gloo has no average)."""
    group = _group(group)
    if not _live(group, "all_reduce"):
        return tensor
    if op not in _TORCH_OP and op != ReduceOp.AVG:
        raise NotImplementedError(
            f"all_reduce op {op!r}: SUM/MAX/MIN/PROD/AVG are supported")
    n = group.nranks
    with _Clock(2 * (n - 1) * _nbytes(tensor) // n):
        w = _wire(group, tensor)
        dist.all_reduce(w, op=_TORCH_OP.get(op, dist.ReduceOp.SUM),
                        group=group.process_group)
        if w is not tensor:
            tensor.copy_(w)
    if op == ReduceOp.AVG:
        tensor.div_(n)
    return tensor


# bytes of one flat buffer `all_reduce_coalesced` sends at a time
BUCKET_BYTES = 256 << 20


def all_reduce_coalesced(tensors, group=None, op=ReduceOp.SUM):
    """all_reduce of a list of tensors, IN PLACE, through flat buffers of
    up to BUCKET_BYTES (one call a bucket, tensors of one dtype a
    bucket). Returns the list."""
    group = _group(group)
    if not tensors or not _live(group, "all_reduce"):
        return tensors
    bucket, size = [], 0

    def flush():
        if len(bucket) == 1 and bucket[0].is_contiguous():
            all_reduce(bucket[0], op, group)
        elif bucket:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            all_reduce(flat, op, group)
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
        bucket.clear()

    for t in tensors:
        nb = _nbytes(t)
        if bucket and (bucket[0].dtype != t.dtype
                       or bucket[0].device != t.device
                       or size + nb > BUCKET_BYTES):
            flush()
            size = 0
        bucket.append(t)
        size += nb
    flush()
    return tensors


def _gather(tensor, group):
    """Every rank's `tensor`, in group order."""
    n = group.nranks
    with _Clock((n - 1) * _nbytes(tensor)):
        w = _wire(group, tensor)
        outs = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(outs, w, group=group.process_group)
        if w is not tensor:
            outs = [o.to(tensor.device) for o in outs]
    return outs


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Paddle's form extends `tensor_list` with every rank's tensor;
    with tensor_list None the pieces come back stacked on a new leading
    axis (`lax.all_gather`)."""
    group = _group(group)
    pieces = _gather(tensor, group) if _live(group, "all_gather") \
        else [tensor.clone()]
    if isinstance(tensor_list, list):
        tensor_list.extend(pieces)
        return tensor_list
    return torch.stack(pieces)


def all_gather_cat(tensor, group=None, dim=0):
    """Every rank's `tensor` concatenated along `dim`, in group order
    (the tiled all-gather)."""
    group = _group(group)
    if not _live(group, "all_gather"):
        return tensor
    return torch.cat(_gather(tensor, group), dim=dim)


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Paddle's form (tensor_list given): `tensor` becomes the reduction
    of every rank's tensor_list[rank], IN PLACE. Without tensor_list,
    this rank's dim-0 block of the reduced `tensor` is returned
    (`lax.psum_scatter(..., tiled=True)`). Over gloo this is an
    all-reduce and a slice."""
    group = _group(group)
    n, me = group.nranks, max(group.rank, 0)
    src = torch.stack(list(tensor_list)) if tensor_list is not None \
        else tensor
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({src.shape[0]}) does not "
                         f"divide over {n} ranks")
    if not _live(group, "reduce_scatter"):
        out = src[0] if tensor_list is not None else src
    elif group.backend == "gloo":
        red = all_reduce(src.clone(), op, group)
        out = red.chunk(n)[me]
        if tensor_list is not None:
            out = out[0]
    else:
        if op not in _TORCH_OP:
            raise NotImplementedError(f"reduce_scatter op {op!r}")
        flat = src.contiguous()
        out = torch.empty((flat.shape[0] // n, *flat.shape[1:]),
                          dtype=flat.dtype, device=flat.device)
        with _Clock((n - 1) * _nbytes(flat) // n):
            dist.reduce_scatter_tensor(out, flat, op=_TORCH_OP[op],
                                       group=group.process_group)
        if tensor_list is not None:
            out = out[0]
    if tensor_list is not None:
        tensor.copy_(out)
        return tensor
    return out


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Every rank's `tensor` becomes global rank `src`'s, IN PLACE."""
    group = _group(group)
    if not _live(group, "broadcast"):
        return tensor
    with _Clock(_nbytes(tensor) if env.get_rank() == src else 0):
        w = _wire(group, tensor)
        dist.broadcast(w, src, group=group.process_group)
        if w is not tensor:
            tensor.copy_(w)
    return tensor


def _a2a_single(out, inp, group, in_split_sizes=None, out_split_sizes=None):
    n = group.nranks
    with _Clock((n - 1) * _nbytes(inp) // n):
        wi = _wire(group, inp)
        wo = _wire(group, out, copy=False)
        dist.all_to_all_single(wo, wi, out_split_sizes, in_split_sizes,
                               group=group.process_group)
        if wo is not out:
            out.copy_(wo)
    return out


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Dim-0 blocks of `in_tensor` go to each rank in turn; the blocks
    received fill `out_tensor` (or a new tensor) in rank order."""
    group = _group(group)
    if not _live(group, "alltoall_single"):
        if out_tensor is not None:
            return out_tensor.copy_(in_tensor)
        return in_tensor.clone()
    if out_tensor is None:
        rows = sum(out_split_sizes) if out_split_sizes else in_tensor.shape[0]
        out_tensor = torch.empty((rows, *in_tensor.shape[1:]),
                                 dtype=in_tensor.dtype,
                                 device=in_tensor.device)
    return _a2a_single(out_tensor, in_tensor, group, in_split_sizes,
                       out_split_sizes)


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """in_tensor_list[j] goes to rank j; the tensor from rank i lands in
    out_tensor_list[i] (extended when empty, returned either way). A
    single tensor is split into dim-0 blocks, one a rank, and the
    received blocks come back in its shape (`lax.all_to_all` over dim
    0)."""
    group = _group(group)
    if torch.is_tensor(in_tensor_list):
        return alltoall_single(in_tensor_list, group=group)
    ins = list(in_tensor_list)
    if len({(t.shape, t.dtype) for t in ins}) > 1:
        raise ValueError("alltoall: every tensor of the list must have "
                         "one shape and dtype")
    got = alltoall_single(torch.stack(ins), group=group).unbind(0)
    if out_tensor_list is None:
        return list(got)
    if len(out_tensor_list) == 0:
        out_tensor_list.extend(got)
    else:
        for o, g in zip(out_tensor_list, got):
            o.copy_(g)
    return out_tensor_list


def send(tensor, dst=0, group=None, sync_op=True):
    """Send to global rank `dst`."""
    group = _group(group)
    if not _live(group, "send"):
        return tensor
    with _Clock(_nbytes(tensor)):
        dist.send(_wire(group, tensor), dst, group=group.process_group)
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive from global rank `src` into `tensor`, IN PLACE."""
    group = _group(group)
    if not _live(group, "recv"):
        return tensor
    with _Clock(0):
        w = _wire(group, tensor, copy=False)
        dist.recv(w, src, group=group.process_group)
        if w is not tensor:
            tensor.copy_(w)
    return tensor


def exchange(sends, recvs, group=None):
    """Point-to-point transfers posted together and then awaited, so
    ranks that send to each other cannot block each other: `sends` is
    a list of (tensor, peer), `recvs` of (tensor, peer), peers by their
    index in the group; received tensors are written IN PLACE."""
    group = _group(group)
    if not (sends or recvs):
        return
    if not _live(group, "exchange"):
        raise ValueError("exchange: a group of one rank has no peer")
    nbytes = sum(_nbytes(t) for t, _ in sends)
    with _Clock(nbytes):
        ops, back = [], []
        for t, peer in sends:
            ops.append(dist.P2POp(dist.isend, _wire(group, t),
                                  group.ranks[peer], group.process_group))
        for t, peer in recvs:
            w = _wire(group, t, copy=False)
            ops.append(dist.P2POp(dist.irecv, w, group.ranks[peer],
                                  group.process_group))
            back.append((t, w))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for t, w in back:
            if w is not t:
                t.copy_(w)


def _ppermute(x, perm, group):
    """lax.ppermute: rank `src` of the group sends x to rank `dst` for
    each (src, dst) of `perm`; a rank nobody sends to gets zeros."""
    me = group.rank
    out = torch.zeros_like(x)
    sends = [(x, d) for s, d in perm if s == me and d != me]
    recvs = [(out, s) for s, d in perm if d == me and s != me]
    if any(s == me and d == me for s, d in perm):
        out.copy_(x)
    if group.nranks > 1:
        exchange(sends, recvs, group)
    return out


def p2p_ppermute(x, perm, group=None):
    """Ring / point-to-point transfer: each (src, dst) pair of `perm`
    (ranks by their index in the group) moves src's `x` to dst."""
    return _ppermute(x.contiguous(), list(perm), _group(group))


def barrier(group=None):
    group = _group(group)
    if _live(group, "barrier"):
        dist.barrier(group=group.process_group)


def get_backend(group=None):
    """The process group's backend ("nccl" or "gloo"); "none" for a
    world of one process that was never initialised."""
    if not dist.is_initialized():
        return "none"
    return _group(group).backend


def reset_counters():
    global calls, bytes_sent, seconds
    calls, bytes_sent, seconds = 0, 0, 0.0


def counters():
    return {"calls": calls, "bytes_sent": bytes_sent, "seconds": seconds}


# ---------------------------------------------------------- differentiable
def _all_to_all(x, group, split_dim, concat_dim):
    """lax.all_to_all(tiled=True): x's `split_dim` cut into one block a
    rank, block j sent to rank j; the blocks received concatenated
    along `concat_dim` in rank order."""
    n = group.nranks
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} ({x.shape[split_dim]})"
                         f" does not divide over {n} ranks")
    inp = torch.stack(x.chunk(n, split_dim)).contiguous()
    out = _a2a_single(torch.empty_like(inp), inp, group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), group=ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = group, dim
        return all_gather_cat(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return g.chunk(group.nranks, dim)[group.rank].contiguous(), None, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = group, dim
        return x.chunk(group.nranks, dim)[group.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return all_gather_cat(g.contiguous(), group, dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = group, split_dim, concat_dim
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g.contiguous(), group, concat_dim,
                           split_dim), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.args = perm, group
        return _ppermute(x.contiguous(), perm, group)

    @staticmethod
    def backward(ctx, g):
        perm, group = ctx.args
        inv = [(d, s) for s, d in perm]
        return _ppermute(g.contiguous(), inv, group), None, None


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.dep
        return g, torch.zeros(shape, dtype=dtype, device=device)


def tie(a, dep):
    """`a`, with `dep` made part of its backward (zero gradient): a rank
    that received a transfer it does not use still runs the transfer's
    backward, as the ranks that do use theirs wait for it."""
    return _Tie.apply(a, dep)


def copy_to_group(x, group):
    """Identity forward; the gradient all-reduced over `group` (where a
    replicated input enters a computation split over the group)."""
    if _group(group).nranks == 1:
        return x
    return _CopyToGroup.apply(x, _group(group))


def reduce_from_group(x, group):
    """All-reduce (sum) forward; the gradient passed through (where a
    split computation's partial results become replicated again)."""
    if _group(group).nranks == 1:
        return x
    return _ReduceFromGroup.apply(x, _group(group))


def gather_from_group(x, group, dim=-1):
    """Every rank's block of `dim` concatenated in group order; the
    gradient cut back to this rank's block (where a split result must
    become whole)."""
    if _group(group).nranks == 1:
        return x
    return _GatherFromGroup.apply(x, _group(group), dim % x.dim())


def scatter_to_group(x, group, dim=-1):
    """This rank's block of `dim` of a replicated `x`; the gradient
    gathered whole again (where a replicated input enters a computation
    split over the group along that dim)."""
    g = _group(group)
    if g.nranks == 1:
        return x
    if x.shape[dim] % g.nranks:
        raise ValueError(f"scatter_to_group: dim {dim} ({x.shape[dim]}) "
                         f"does not divide over {g.nranks} ranks")
    return _ScatterToGroup.apply(x, g, dim % x.dim())


def all_to_all(x, group, split_dim, concat_dim):
    """Differentiable tiled all-to-all; its backward is the inverse
    all-to-all (split and concat dims swapped)."""
    if _group(group).nranks == 1:
        return x
    return _AllToAll.apply(x, _group(group), split_dim, concat_dim)


def ppermute(x, perm, group):
    """Differentiable `p2p_ppermute`; its backward moves the gradient by
    the inverse permutation."""
    return _PPermute.apply(x, [tuple(p) for p in perm], _group(group))
