"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The package mirrors `paddle_tpu`'s layout (`models/llama_serving.py`
here is the counterpart of `paddle_tpu/models/llama_serving.py`, and so
on) and imports only torch, numpy and the standard library — never jax
and never `paddle_tpu`. Kernels written for Hopper live under `csrc/`
and are built from source at first use (`kernels/_build.py`).

The Paddle-shaped eager surface is the top level, as in the reference:

    import paddle_tpu_torch as paddle
    x = paddle.randn([8, 128])
    net = paddle.nn.Sequential(paddle.nn.Linear(128, 256), paddle.nn.GELU(),
                               paddle.nn.Linear(256, 10))
    loss = paddle.nn.functional.cross_entropy(net(x),
                                              paddle.randint(0, 10, [8]))
    loss.backward()
    paddle.optimizer.AdamW(1e-3, parameters=net.parameters()).step()

`Tensor` wraps one torch.Tensor and torch autograd is its tape; `nn`,
`nn.functional`, `nn.initializer`, `optimizer` (16 rules, the LR
schedulers) and `models.llama.LlamaForCausalLM` (the Layer tree, on the
flash-attention kernels) stand on it. Tensors and parameters are made on
the card (`get_device()` is "gpu:0"), and making one without a CUDA
device raises; `paddle.set_device("cpu")` runs on the CPU, as the tests
do. Random draws follow the reference's key stream (`seed`), bit-equal
for uniform draws.

The functional paths take an explicit `device` and default to "cuda":
the serving main path (the stacked-parameter Llama run through
`models.llama_serving.unified_step`, driven by the ragged
`ServingEngine` pump), bucketed serving (`ServingEngine(...,
ragged=False)`, on the kernels of `ops.varlen_attention` and
`ops.paged_attention`), the single-device pretrain step
(`models.llama_spmd.make_train_step`, on the flash-attention kernels of
`ops.flash_attention`, or with packed documents on the FlashMask kernels
of `ops.flashmask_attention`; with `fused_ce` and `remat="dots"`),
varlen training (`ops.varlen_attention.flash_attention_varlen`) and
hybrid-parallel training on a mesh of ranks (`parallel.create_mesh`,
`distributed.launch`). Each kernel module counts its launches
(`launches`, `launches_fwd`, `launches_dq`, `launches_decode`, ...).
`python3 chip_smoke.py` drives every path on the card; `--phases
device,build,layer_parity,layer_train` the Layer-tree Llama.
"""
from __future__ import annotations

import math as _math

from ._device import DEFAULT_DEVICE, resolve_device  # noqa: F401
from ._core import dtypes as _dtypes
from ._core.dtypes import (  # noqa: F401
    bool_ as bool, uint8, int8, int16, int32, int64, float16, bfloat16,
    float32, float64, complex64, complex128, float8_e4m3fn, float8_e5m2,
    set_default_dtype, get_default_dtype, finfo, iinfo,
)
from ._core.tensor import Tensor, Parameter  # noqa: F401
from ._core.state import seed, get_rng_state, set_rng_state  # noqa: F401
from ._core import state as _state

from .tensor import *  # noqa: F401,F403
from .tensor.logic import is_tensor  # noqa: F401
from .tensor.attribute import (  # noqa: F401
    rank, is_complex, is_floating_point, is_integer, shape,
)
from .autograd import no_grad, enable_grad, grad, set_grad_enabled  # noqa: F401

from . import autograd  # noqa: F401
from . import device  # noqa: F401
from . import nn  # noqa: F401
from . import optimizer  # noqa: F401
from . import regularizer  # noqa: F401
from .device import (  # noqa: F401
    set_device, get_device, is_compiled_with_cuda, is_compiled_with_xpu,
    is_compiled_with_rocm, is_compiled_with_custom_device, CPUPlace,
    CUDAPlace, CUDAPinnedPlace, synchronize,
)
from .nn.layer.layers import ParamAttr  # noqa: F401
from .tensor import linalg  # noqa: F401

# random-key context for code that threads its own keys
random_key_context = _state.prng.key_ctx

__version__ = "0.1.0"

inf = float("inf")
nan = float("nan")
pi = _math.pi
e = _math.e
newaxis = None


dtype = _dtypes.convert_dtype            # paddle.dtype: a dtype by name

def is_grad_enabled():
    import torch
    return torch.is_grad_enabled()


def in_dynamic_mode():
    return True


def cast(x, dtype):
    return x.astype(dtype)
