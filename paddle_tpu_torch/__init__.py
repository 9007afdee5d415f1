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
`ServingEngine` pump) and the single-device pretrain step
(`models.llama_spmd.make_train_step`, on the flash-attention kernels of
`ops.flash_attention`).
"""
from ._device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "resolve_device"]
