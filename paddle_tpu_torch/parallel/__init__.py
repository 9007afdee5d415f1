"""paddle_tpu_torch.parallel: the parallelism core on torch.distributed
(counterpart of `paddle_tpu/parallel`).

The rank mesh and its per-axis groups (`mesh.py`), the pipeline
schedules (`pp.py`: GPipe, 1F1B, interleaved), ring and Ulysses
sequence parallelism (`ring.py`, `ulysses.py`). Tensor parallelism is
the Llama step's own (`models/llama_spmd.py`). The Paddle layer surface
(`tp.py`'s parallel layers, `moe.py`, `trainer.py`, `LayerDesc` /
`PipelineLayer`) is ROADMAP.md Queue 1 item 12b.
"""
from .mesh import P, RankMesh, axis_size, create_mesh, fsdp_spec, get_mesh  # noqa: F401
from .pp import (  # noqa: F401
    build_interleaved_schedule, group_stages, group_virtual_stages,
    pipeline_apply, pipeline_bubble_fraction, pipeline_train_1f1b,
    pipeline_train_interleaved, stack_layer_params, ungroup_virtual_stages,
)
from .ring import ring_attention, ring_attention_local, sequence_shard  # noqa: F401
from .ulysses import ulysses_attention, ulysses_attention_local  # noqa: F401
