"""group_sharded_parallel: the ZeRO stages (counterpart of
`paddle_tpu/distributed/sharding.py`; reference: python/paddle/
distributed/sharding/group_sharded.py).

It marks the model and the optimizer with the stage ("os" 1, "os_g" 2,
"p_g_os" 3), which the parallel `Trainer` honours: stages 1 and 2 slice
the optimizer slots over dp, stage 3 the parameters too."""
from __future__ import annotations


def group_sharded_parallel(model, optimizer, level="os_g", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    stage = {"os": 1, "os_g": 2, "p_g_os": 3}.get(level, 2)
    optimizer._sharding_stage = stage
    model._sharding_stage = stage
    if scaler is not None:
        return model, optimizer, scaler
    return model, optimizer


def save_group_sharded_model(model, output, optimizer=None):
    """The model's state dict to `output`.pdmodel.state (and the
    optimizer's to `output`.pdopt.state) with torch.save."""
    import torch
    from .._core.tensor import Tensor

    def plain(sd):
        return {k: (v._value.detach().cpu() if isinstance(v, Tensor) else v)
                for k, v in sd.items()}
    torch.save(plain(model.state_dict()), output + ".pdmodel.state")
    if optimizer is not None:
        torch.save(plain(optimizer.state_dict()), output + ".pdopt.state")
