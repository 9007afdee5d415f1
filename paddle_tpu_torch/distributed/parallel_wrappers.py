"""DataParallel (counterpart of
`paddle_tpu/distributed/parallel_wrappers.py`; reference:
python/paddle/distributed/parallel.py).

The JAX package shards the batch over 'dp' and GSPMD inserts the
gradient all-reduce. Here each rank is a process: `DataParallel` wraps
the Layer, and the gradients are averaged over the dp group either by
the parallel `Trainer` (which takes each rank's block of the batch by
its `batch_spec`) or, in an eager loop, by `apply_collective_grads()`
after `loss.backward()`.
"""
from __future__ import annotations

from ..nn.layer.layers import Layer
from . import collective as C
from . import env


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._group = group

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def scale_loss(self, loss):
        return loss

    def _dp_group(self):
        if self._group is not None:
            return self._group
        mesh = env.get_global_mesh()
        if mesh is not None and "dp" in mesh.shape:
            return mesh.group("dp")
        return C.get_group() if mesh is None else None

    def apply_collective_grads(self):
        """Average every parameter's gradient over the dp group (one
        coalesced all-reduce), as the reference's reducer hooks do."""
        group = self._dp_group()
        if group is None or group.nranks == 1:
            return
        grads = [p._value.grad for p in self._layers.parameters()
                 if p._value.grad is not None]
        C.all_reduce_coalesced(grads, group)
        for g in grads:
            g.div_(group.nranks)

    @property
    def _layers_attr(self):
        return self._layers

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self.__dict__["_sub_layers"]["_layers"], name)
