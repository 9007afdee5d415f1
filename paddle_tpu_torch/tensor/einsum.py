"""einsum (counterpart of `paddle_tpu/tensor/einsum.py`)."""
from __future__ import annotations

import torch

from .._core.tensor import apply

__all__ = ["einsum"]


def einsum(equation, *operands):
    return apply(lambda *ops: torch.einsum(equation, *ops), *operands)
