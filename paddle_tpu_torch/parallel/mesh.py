"""The rank mesh (counterpart of `paddle_tpu/parallel/mesh.py`).

The JAX package lays a `jax.sharding.Mesh` over devices and lets GSPMD
place data on it. Here the mesh is an array of ranks (processes on
`torch.distributed`) with named axes; each axis has one process group
per line of ranks along it, and this rank keeps the group of its own
line. Axis convention (outer to inner) as in the JAX package: pp, dp,
fsdp / sharding, sp / ep, tp."""
from __future__ import annotations

import numpy as np

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
