"""paddle_tpu_torch.parallel: the parallelism core on torch.distributed
(counterpart of `paddle_tpu/parallel`).

The rank mesh, its per-axis groups and the placement of tensors by
PartitionSpec (`mesh.py`), the pipeline schedules and `PipelineLayer`
(`pp.py`: GPipe, 1F1B, interleaved), ring and Ulysses sequence
parallelism (`ring.py`, `ulysses.py`), the tensor-parallel layers
(`tp.py`), expert parallelism (`moe.py`) and the hybrid-parallel
`Trainer` of a Paddle Layer tree (`trainer.py`). The paddle-compatible
fleet API in `paddle_tpu_torch.distributed.fleet` delegates here.
"""
from .mesh import P, RankMesh, axis_size, create_mesh, fsdp_spec, get_mesh  # noqa: F401
from .pp import (  # noqa: F401
    LayerDesc, PipelineLayer, SharedLayerDesc, build_interleaved_schedule,
    group_stages, group_virtual_stages, pipeline_apply,
    pipeline_bubble_fraction, pipeline_train_1f1b,
    pipeline_train_interleaved, stack_layer_params, ungroup_virtual_stages,
)
from .ring import ring_attention, ring_attention_local, sequence_shard  # noqa: F401
from .ulysses import ulysses_attention, ulysses_attention_local  # noqa: F401
from .tp import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, annotate_module_tp, mark_sequence_parallel,
)
from .moe import MoELayer, moe_ffn_apply, top_k_gating  # noqa: F401
from .trainer import Trainer, place_layer  # noqa: F401
