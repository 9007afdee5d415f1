"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The package mirrors `paddle_tpu`'s layout (`models/llama_serving.py`
here is the counterpart of `paddle_tpu/models/llama_serving.py`, and so
on) and imports only torch, numpy and the standard library — never jax
and never `paddle_tpu`. Entry points run on the card by default
(`device="cuda"`) and raise when no CUDA device is present; pass
`device="cpu"` to run on the CPU. Kernels written for Hopper live under
`csrc/` and are built from source at first use (`kernels/_build.py`).

The port covers the serving main path (the stacked-parameter Llama run
through `models.llama_serving.unified_step`, driven by the ragged
`ServingEngine` pump), bucketed serving (`ServingEngine(...,
ragged=False)`: `prefill`, `prefill_varlen` and `decode_step`, on the
kernels of `ops.varlen_attention` and `ops.paged_attention`; on the CPU
`ServingEngine(params, config, ragged=False, device="cpu")`) and the
single-device pretrain step (`models.llama_spmd.make_train_step`, on the
flash-attention kernels of `ops.flash_attention`, or with packed
documents on the FlashMask kernels of `ops.flashmask_attention`; with
`fused_ce` and `remat="dots"`) and varlen training (the differentiable
`ops.varlen_attention.flash_attention_varlen` and `flash_attn_unpadded`)
and hybrid-parallel training on a mesh of ranks (`parallel.create_mesh`,
`distributed.launch`: tp, dp, sp ring / Ulysses, pp GPipe / 1F1B /
interleaved, on the same step).
Each kernel module counts its launches (`launches`, `launches_fwd`,
`launches_dq`, `launches_decode`, ...). `python3 chip_smoke.py` drives
every path on the card; `--phases
device,build,bucket_kernel,bucket_parity,bucket_serve` the bucketed one.
"""
from ._device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "resolve_device"]
