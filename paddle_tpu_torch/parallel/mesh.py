"""The rank mesh (counterpart of `paddle_tpu/parallel/mesh.py`).

The JAX package lays a `jax.sharding.Mesh` over devices and lets GSPMD
place data on it. Here the mesh is an array of ranks (processes on
`torch.distributed`) with named axes; each axis has one process group
per line of ranks along it, and this rank keeps the group of its own
line. Axis convention (outer to inner) as in the JAX package: pp, dp,
fsdp / sharding, sp / ep, tp."""
from __future__ import annotations

import numpy as np
import torch

from ..distributed import collective, env


class P(tuple):
    """PartitionSpec: one entry a tensor dim, each None (replicated), an
    axis name, or a tuple of axis names (major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


class RankMesh:
    """`devices`: the rank array (its shape the axis sizes, in `axis_names`
    order); `shape`: {axis: size}; `coords`: this rank's index on each
    axis; `group(axis)`: the group of ranks that share every other
    coordinate with this one."""

    def __init__(self, ranks, axis_names, rank=None):
        self.devices = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.rank = env.get_rank() if rank is None else int(rank)
        where = np.argwhere(self.devices == self.rank)
        self.coords = (dict(zip(self.axis_names, map(int, where[0])))
                       if len(where) else None)
        self._groups = {}

    def _lines(self, axis):
        """Every line of ranks along `axis`, in a fixed order."""
        d = self.axis_names.index(axis)
        moved = np.moveaxis(self.devices, d, -1)
        return [list(map(int, row)) for row in
                moved.reshape(-1, moved.shape[-1])]

    def make_groups(self):
        """Build one process group per line of every axis. Collective:
        every rank of the world calls it (create_mesh does)."""
        for axis in self.axis_names:
            for line in self._lines(axis):
                g = collective.new_group(line, axis_name=axis)
                if self.rank in line:
                    self._groups[axis] = g
        return self

    def group(self, axis):
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} (axes "
                             f"{self.axis_names})")
        if axis not in self._groups:
            line = next(ln for ln in self._lines(axis) if self.rank in ln)
            if len(line) > 1:
                raise RuntimeError(
                    f"mesh axis {axis!r} has no process group: build the "
                    "mesh with create_mesh after init_parallel_env")
            self._groups[axis] = collective.Group(line, axis_name=axis)
        return self._groups[axis]

    def coord(self, axis):
        return self.coords[axis] if axis in self.shape else 0

    def __repr__(self):
        return f"RankMesh({self.shape}, rank={self.rank})"


def create_mesh(axes=None, ranks=None, **axis_sizes):
    """create_mesh({'dp': 2, 'tp': 4}) or create_mesh(dp=2, tp=4), over
    `ranks` (default: every rank of the world). -1 on one axis infers
    its size; ranks left over fold into a leading 'dp' axis; sizes that
    do not fit raise ValueError. With torch.distributed initialised this
    is collective (each axis's groups are built) and sets the global
    mesh."""
    if axes is None:
        axes = dict(axis_sizes)
    ranks = np.asarray(ranks if ranks is not None
                       else np.arange(env.get_world_size()))
    n = ranks.size
    names = list(axes.keys())
    sizes = [int(v) for v in axes.values()]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total != n:
        if n % total == 0:
            if "dp" in axes:
                raise ValueError(f"mesh {axes} does not cover {n} devices")
            names.insert(0, "dp")
            sizes.insert(0, n // total)
        else:
            raise ValueError(f"mesh sizes {axes} incompatible with {n} "
                             "devices")
    mesh = RankMesh(ranks.reshape(sizes), names)
    if env.is_initialized():
        mesh.make_groups()
    env.set_global_mesh(mesh)
    return mesh


def get_mesh():
    return env.get_global_mesh()


def axis_size(mesh, name):
    return mesh.shape[name] if name in mesh.shape else 1


def fsdp_spec(shape, mesh, axis="dp", min_size=1024):
    """FSDP / ZeRO-3 parameter spec: the largest dim divisible by the
    axis size is sharded over it; small or indivisible tensors stay
    replicated (P())."""
    if axis not in mesh.shape:
        return P()
    n = mesh.shape[axis]
    size = int(np.prod(shape)) if shape else 0
    if size < min_size:
        return P()
    dims = sorted(range(len(shape)), key=lambda i: -shape[i])
    for d in dims:
        if shape[d] % n == 0:
            spec = [None] * len(shape)
            spec[d] = axis
            return P(*spec)
    return P()


# ------------------------------------------------------------ placement
def spec_axes(entry):
    """The mesh axes one PartitionSpec entry names (major first)."""
    return () if entry is None else (
        tuple(entry) if isinstance(entry, tuple) else (entry,))


def check_spec(spec, mesh, what="a parameter"):
    """ValueError when `spec` names an axis `mesh` lacks (GSPMD refuses
    such a sharding with these words)."""
    for entry in spec:
        for ax in spec_axes(entry):
            if ax not in mesh.shape:
                raise ValueError(
                    f"Resource axis: {ax} of {spec!r} ({what}) is not found "
                    f"in mesh: {tuple(mesh.axis_names)}.")


def block(mesh, axes):
    """(index, count) of this rank's block of a dim split over `axes`
    (major first)."""
    idx, n = 0, 1
    for ax in axes:
        size = mesh.shape.get(ax, 1)
        idx, n = idx * size + mesh.coord(ax), n * size
    return idx, n


def shard(a, spec, mesh):
    """This rank's block of the full tensor `a` by `spec`: a contiguous
    copy. ValueError when a split dim does not divide."""
    for dim, entry in enumerate(spec):
        idx, n = block(mesh, spec_axes(entry))
        if n > 1:
            if a.shape[dim] % n:
                raise ValueError(f"dim {dim} of a {tuple(a.shape)} leaf "
                                 f"does not divide over {entry}={n}")
            a = a.chunk(n, dim)[idx]
    return a.clone(memory_format=torch.contiguous_format)


def gather(a, spec, mesh):
    """The full tensor from every rank's block (collective over the
    axes `spec` names; the inverse of `shard`)."""
    for dim, entry in enumerate(spec):
        for ax in reversed(spec_axes(entry)):
            if mesh.shape.get(ax, 1) > 1:
                a = collective.all_gather_cat(a.contiguous(), mesh.group(ax),
                                              dim)
    return a


def split_axes(spec, mesh):
    """The axes of `mesh` of more than one rank that `spec` splits."""
    return tuple(ax for e in spec for ax in spec_axes(e)
                 if mesh.shape.get(ax, 1) > 1)


def sum_over_shards(parts, axes, mesh):
    """The global sum of per-leaf partial sums: `parts[i]` is leaf i's
    sum over the block this rank holds, `axes[i]` the axes the leaf is
    split over. A leaf replicated on an axis counts once (its block on
    coordinate 0 of that axis); the result, a 0-dim fp32 tensor, is the
    same on every rank."""
    model = sorted({ax for a in axes for ax in a},
                   key=lambda ax: mesh.axis_names.index(ax))
    total = torch.zeros((), dtype=torch.float32, device=parts[0].device)
    for part, ax in zip(parts, axes):
        if not any(m not in ax and mesh.coord(m) != 0 for m in model):
            total = total + part.float()
    for m in model:
        collective.all_reduce(total, group=mesh.group(m))
    return total


# parameters placed on a mesh: id -> (mesh, the axes their blocks split)
_PLACED = {}


def mark_placed(param, mesh, axes):
    """Record that `param` holds its block over `axes` of `mesh` (read
    by the eager clip and the norm-taking optimizer rules)."""
    import weakref
    if id(param) not in _PLACED:
        weakref.finalize(param, _PLACED.pop, id(param), None)
    _PLACED[id(param)] = (mesh, tuple(axes))


def placement(param):
    """(mesh, split axes) of a placed parameter, else None."""
    return _PLACED.get(id(param))
