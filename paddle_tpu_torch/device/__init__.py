"""Device API (counterpart of `paddle_tpu/device/__init__.py`).

The card is the default device: `get_device()` is "gpu:0" until
`set_device("cpu")`, and creating a tensor or a parameter without a CUDA
device raises (`_core.state.torch_device`). "gpu" and "gpu:<i>" map to
CUDA devices.
"""
from __future__ import annotations

import torch

from .._core.state import get_device, set_device  # noqa: F401
from .._core.tensor import Place


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu", 0)


class CUDAPlace(Place):
    def __init__(self, idx=0):
        super().__init__("gpu", idx)


class CUDAPinnedPlace(Place):
    def __init__(self):
        super().__init__("cpu", 0)


def get_all_device_type():
    return ["cpu"] + (["gpu"] if torch.cuda.is_available() else [])


def get_all_custom_device_type():
    return []


def get_available_device():
    return [f"gpu:{i}" for i in range(torch.cuda.device_count())]


def get_available_custom_device():
    return []


def device_count():
    return torch.cuda.device_count()


def is_compiled_with_cuda():
    return True


def is_compiled_with_rocm():
    return False


def is_compiled_with_xpu():
    return False


def is_compiled_with_ipu():
    return False


def is_compiled_with_cinn():
    return False


def is_compiled_with_custom_device(device_type="gpu"):
    return False


def is_compiled_with_distribute():
    return True


def synchronize(device=None):
    """Wait for the card's queued work (nothing to wait for on the
    CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
