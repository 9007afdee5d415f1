"""The hybrid-parallel Trainer (counterpart of
`paddle_tpu/parallel/trainer.py`): a Paddle Layer tree trained on a rank
mesh.

The JAX package compiles one pjit'd step over a global mesh and lets
GSPMD place the data. Here every rank is a process that runs the step
eagerly (`Layer._swapped_state` and torch autograd) on what it holds:

  * placement: each parameter is cut to the rank's block by its
    `dist_spec` (a spec naming an axis the mesh lacks, or a split that
    does not divide, raises ValueError) and written back into the
    Layer tree, whose layers then run Megatron's collectives
    (`parallel/tp.py`, the Layer-tree Llama);
  * dp: each rank takes its block of the batch by `batch_spec`; the
    gradients and the returned loss are the means over the batch's
    axes. The loss is the mean of the ranks' losses (Paddle's
    DataParallel), which equals the JAX step's global loss when every
    block holds as many valid labels (ROADMAP.md Queue 3);
  * ZeRO (`sharding_stage`, or what `group_sharded_parallel` marked):
    stages 1 and 2 keep each rank's slice of the optimizer slots of a
    replicated parameter (`fsdp_spec` over dp) and update its slice of
    the parameter, then all-gather it; stage 1 all-reduces the
    gradients, stage 2 reduce-scatters them. Stage 3 keeps such a
    parameter sliced at rest, all-gathers it for the step and
    reduce-scatters its gradient;
  * norms over whole tensors (the global-norm clip, Lamb's and
    LarsMomentum's trust ratios, `health_stats`) sum their squares over
    the axes that split each tensor and count a replicated one once.

The step's key is `fold_in(key(base_seed), step)` pushed as the key
context, as the JAX step's; an LRScheduler steps after each step;
the compile telemetry counts first-seen batch signatures under
"parallel.train_step" (what track_jit counts for the JAX step).
The step computes where the parameters live (the card by default); it
never moves to the CPU by itself.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _prng
from .._core.state import prng
from .._core.tensor import Tensor, unwrap
from ..distributed import collective as C
from ..distributed import env
from ..observability.compile_telemetry import REGISTRY, signature_of
from ..optimizer.optimizer import split_over
from .mesh import (P, RankMesh, block, check_spec, fsdp_spec, get_mesh,
                   mark_placed, shard, spec_axes, split_axes,
                   sum_over_shards)

__all__ = ["Trainer", "place_layer"]


def _leaf_spec(param_spec, leaf, param_shape):
    """Optimizer slot sharding mirrors its parameter when shapes match."""
    if hasattr(leaf, "shape") and tuple(leaf.shape) == tuple(param_shape):
        return param_spec
    return P()


def _split_dim(spec, axis):
    """The dim of `spec` that names `axis`."""
    return next(d for d, e in enumerate(spec) if axis in spec_axes(e))


class _Leaf:
    """One parameter's layout: `rest` (what the Trainer holds between
    steps), `compute` (what the forward uses: its dist_spec), `update`
    (what the optimizer updates and its slots mirror)."""
    __slots__ = ("rest", "compute", "update", "shape")

    def __init__(self, rest, compute, update, shape):
        self.rest, self.compute, self.update = rest, compute, update
        self.shape = shape


def _batch_specs(batch, spec):
    """A spec a leaf of `batch`: None (replicated), one P for every
    leaf, or a tree of P matching the batch."""
    if spec is None or isinstance(spec, P):
        return _map(lambda _: spec, batch)
    if isinstance(batch, dict):
        return {k: _batch_specs(batch[k], spec[k]) for k in batch}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_batch_specs(b, s) for b, s in zip(batch, spec))
    return spec


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, *rs) for t, *rs in
                          zip(tree, *rest))
    return fn(tree, *rest)


def place_layer(model, mesh, specs=None):
    """Cut every parameter of the Layer tree `model` to this rank's block
    by its spec (`specs` by name, else its `dist_spec`; none:
    replicated), in place, and make `mesh` the global mesh, where the
    layers find their axes' groups. A spec naming an axis the mesh
    lacks, or a split that does not divide, raises ValueError. Returns
    the model."""
    named = dict(model.named_parameters())
    specs = specs or {n: (p.dist_spec if p.dist_spec is not None else P())
                      for n, p in named.items()}
    for name, spec in specs.items():
        check_spec(spec, mesh, f"parameter {name}")
    env.set_global_mesh(mesh)
    with torch.no_grad():
        for name, p in named.items():
            p._replace(shard(p._value.detach(), specs[name], mesh))
            mark_placed(p, mesh, split_axes(specs[name], mesh))
    return model


class Trainer:
    def __init__(self, model, optimizer, loss_fn, mesh=None, batch_spec=None,
                 sharding_stage=0, grad_clip_norm=None, base_seed=1234,
                 donate=True, health_monitor=None):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        # observability.health.TrainingHealthMonitor (or duck type): the
        # step computes health_stats and observe() takes them in one
        # transfer a step
        self.health_monitor = health_monitor
        self.mesh = mesh or get_mesh()
        if self.mesh is not None and not isinstance(self.mesh, RankMesh):
            raise ValueError("Trainer: mesh must be a rank mesh "
                             "(parallel.create_mesh after "
                             "init_parallel_env)")
        if sharding_stage == 0:
            # group_sharded_parallel (the ZeRO facade) marks the model
            # and the optimizer
            sharding_stage = getattr(model, "_sharding_stage", 0) or \
                getattr(optimizer, "_sharding_stage", 0)
        self.sharding_stage = sharding_stage
        self.grad_clip_norm = grad_clip_norm
        self.base_seed = base_seed
        self.donate = donate
        self._step_count = 0
        self.batch_spec = batch_spec
        mesh = self.mesh

        _, buffers = model.functional_state()
        named = dict(model.named_parameters())
        self.param_specs, self._leaves = {}, {}
        for name, p in named.items():
            shape = tuple(p._value.shape)
            if p.dist_spec is not None:
                spec = p.dist_spec
            elif sharding_stage >= 3 and mesh is not None:
                spec = fsdp_spec(shape, mesh)
            else:
                spec = P()
            self.param_specs[name] = spec
            compute = p.dist_spec if p.dist_spec is not None else P()
            if sharding_stage in (1, 2) and spec == P() and mesh is not None:
                update = fsdp_spec(shape, mesh)
            else:
                update = spec
            self._leaves[name] = _Leaf(spec, compute, update, shape)

        if mesh is not None:
            place_layer(model, mesh, self.param_specs)
        # the Trainer's tensors share the Layer tree's storage: with
        # donate, each step writes into them and the model follows
        self.params = {n: p._value.detach() for n, p in named.items()}
        self.buffers = buffers
        self.opt_state, self.state_specs = {}, {}
        for n, v in self.params.items():
            lf = self._leaves[n]
            upd = self._to_update(v, lf)
            self.opt_state[n] = optimizer.init_state(upd)
            self.state_specs[n] = {
                k: _leaf_spec(lf.update, slot, upd.shape)
                for k, slot in self.opt_state[n].items()}

    # ---------------------------------------------------------- layouts
    def _extra(self, outer, inner):
        """Axes of the mesh (more than one rank) that `outer` splits and
        `inner` does not."""
        if self.mesh is None:
            return ()
        have = set(split_axes(inner, self.mesh))
        return tuple(ax for ax in split_axes(outer, self.mesh)
                     if ax not in have)

    def _to_update(self, t, lf):
        """This rank's update block of a rest-form tensor."""
        if self.mesh is None or lf.update == lf.rest:
            return t
        for ax in self._extra(lf.update, lf.rest):
            d = _split_dim(lf.update, ax)
            idx, n = block(self.mesh, (ax,))
            t = t.chunk(n, d)[idx]
        return t

    def _gather_extra(self, t, outer, inner):
        """Gather `t` (held split by `outer`) over the axes `inner` does
        not split."""
        for ax in self._extra(outer, inner):
            t = C.all_gather_cat(t.contiguous(), self.mesh.group(ax),
                                 _split_dim(outer, ax))
        return t

    # ------------------------------------------------------------ batch
    def _local_batch(self, batch, dev):
        specs = _batch_specs(batch, self.batch_spec)
        axes = set()

        def local(x, spec):
            x = unwrap(x) if isinstance(x, Tensor) else x
            x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
            x = x.to(dev)
            if spec is None or self.mesh is None:
                return x
            for dim, entry in enumerate(spec):
                ax = spec_axes(entry)
                for a in ax:
                    if a not in self.mesh.shape:
                        raise ValueError(
                            f"batch_spec axis {a!r} is not an axis of the "
                            f"mesh {self.mesh.axis_names}")
                idx, n = block(self.mesh, ax)
                if n > 1:
                    if x.shape[dim] % n:
                        raise ValueError(
                            f"batch dim {dim} ({x.shape[dim]}) does not "
                            f"divide over {entry}={n}")
                    axes.update(a for a in ax
                                if self.mesh.shape[a] > 1)
                    x = x.chunk(n, dim)[idx]
            return x
        out = _map(local, batch, specs)
        return out, tuple(sorted(axes, key=self.mesh.axis_names.index)
                          if self.mesh is not None else ())

    # ------------------------------------------------------------- step
    def _grads(self, batch, key):
        """(local loss, grads in compute form, new buffers)."""
        mesh, names = self.mesh, list(self.params)
        leaves = {}
        with torch.no_grad():
            for n in names:
                lf = self._leaves[n]
                t = self.params[n]
                if mesh is not None:
                    t = self._gather_extra(t, lf.rest, lf.compute)
                leaves[n] = t.detach().requires_grad_()
        with torch.enable_grad(), prng.key_ctx(key), \
                self.model._swapped_state(leaves, self.buffers):
            wrapped = _map(Tensor, batch)
            loss = self.loss_fn(self.model, wrapped)
            new_buffers = {n: b._value for n, b in
                           self.model.named_buffers() if b is not None}
            raw = unwrap(loss).float()
            gs = torch.autograd.grad(raw, [leaves[n] for n in names],
                                     allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(leaves[n]))
                 for n, g in zip(names, gs)}
        return raw.detach(), grads, new_buffers

    def _reduce_grads(self, grads, data_axes):
        """Mean over the batch's axes; reduce-scattered where ZeRO keeps
        the gradient sliced (stage 2's update slice, stage 3's rest
        slice), else all-reduced. Returns the grads and each one's
        spec as held."""
        mesh, stage = self.mesh, self.sharding_stage
        held = {n: (lf.rest if stage >= 3 else
                    lf.update if stage == 2 else lf.compute)
                for n, lf in self._leaves.items()}
        if mesh is None:
            return grads, held
        n_data = 1
        for ax in data_axes:
            group = mesh.group(ax)
            n_data *= group.nranks
            plain = [n for n in grads
                     if ax not in self._extra(held[n],
                                              self._leaves[n].compute)]
            C.all_reduce_coalesced([grads[n] for n in plain], group)
            for n in grads:
                if n in plain:
                    continue
                d = _split_dim(held[n], ax)
                t = grads[n].movedim(d, 0).contiguous()
                grads[n] = C.reduce_scatter(t, group=group).movedim(0, d)
        for n, g in grads.items():
            lf = self._leaves[n]
            # slices along axes the batch does not split: a local cut
            for ax in self._extra(held[n], lf.compute):
                if ax in data_axes:
                    continue
                d = _split_dim(held[n], ax)
                idx, k = block(mesh, (ax,))
                g = g.chunk(k, d)[idx]
            grads[n] = g / n_data if n_data > 1 else g
        return grads, held

    def _reduce_fn(self, specs):
        """sum_over_shards for leaves held as `specs` (a list)."""
        if self.mesh is None:
            return None
        axes = [split_axes(s, self.mesh) for s in specs]
        return lambda parts: sum_over_shards(parts, axes, self.mesh)

    def _train_step(self, batch, lr, key):
        mesh, names = self.mesh, list(self.params)
        dev = self.params[names[0]].device
        local, data_axes = self._local_batch(batch, dev)
        loss, grads, new_buffers = self._grads(local, key)
        for ax in data_axes:
            loss = C.all_reduce(loss.clone(), group=mesh.group(ax)) / \
                mesh.shape[ax]
        grads, held = self._reduce_grads(grads, data_axes)
        if self.grad_clip_norm is not None:
            from ..nn.clip import ClipGradByGlobalNorm
            clipped, _ = ClipGradByGlobalNorm.functional(
                [grads[n] for n in names], self.grad_clip_norm,
                self._reduce_fn([held[n] for n in names]))
            grads = dict(zip(names, clipped))
        with_health = self.health_monitor is not None
        blocks = []          # (grad, param, new param) update blocks
        with torch.no_grad():
            for n in names:
                lf = self._leaves[n]
                p = self._to_update(self.params[n], lf)
                g = grads[n]
                if held[n] != lf.update:
                    g = self._to_update(g, lf)
                groups = ([mesh.group(ax) for ax in
                           split_axes(lf.update, mesh)]
                          if mesh is not None else [])
                with split_over(groups):
                    upd, self.opt_state[n] = self.optimizer._apply_one(
                        p, g, self.opt_state[n], lr)
                if with_health:
                    blocks.append((g, p.clone(), upd))
                if mesh is not None:
                    upd = self._gather_extra(upd, lf.update, lf.rest)
                if self.donate:
                    self.params[n].copy_(upd)
                else:
                    self.params[n] = upd
        health = None
        if with_health:
            # the update blocks: whole-tensor sums over their split axes
            from ..observability.health import health_stats
            g, old, new = (list(t) for t in zip(*blocks))
            health = health_stats(loss, g, old, new, reduce=self._reduce_fn(
                [self._leaves[n].update for n in names]))
        self.buffers = new_buffers
        return loss, health

    def step(self, batch):
        """batch: a tree (tuple / list / dict) of numpy arrays, torch
        tensors or Tensors, the global batch (the same on every rank).
        Returns the loss, a 0-dim fp32 tensor on the step's device."""
        lr = float(self.optimizer.get_lr())
        key = _prng.fold_in(_prng.key(self.base_seed),
                            torch.tensor([self._step_count]))
        # compile telemetry: each first-seen batch signature is what the
        # JAX step would compile for (track_jit's count; nothing compiles
        # here, and the step has no analytic cost to capture)
        REGISTRY.note_call("parallel.train_step", signature_of((batch,)))
        loss, health = self._train_step(batch, lr, key)
        self._step_count += 1
        if self.health_monitor is not None and health is not None:
            self.health_monitor.observe(health, step=self._step_count)
        from ..optimizer.lr import LRScheduler
        if isinstance(self.optimizer._learning_rate, LRScheduler):
            self.optimizer._learning_rate.step()
        return loss

    def sync_model(self):
        """Write the trained parameters into the Layer tree: the blocks
        its layers compute with (a stage-3 slice is gathered first, a
        collective every rank calls)."""
        named = dict(self.model.named_parameters())
        with torch.no_grad():
            for n, v in self.params.items():
                lf = self._leaves[n]
                if self.mesh is not None:
                    v = self._gather_extra(v, lf.rest, lf.compute)
                named[n]._replace(v)
        namedb = dict(self.model.named_buffers())
        for n, v in self.buffers.items():
            if n in namedb and namedb[n] is not None:
                namedb[n]._value = v
