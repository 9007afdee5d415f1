"""Parameter initializers (counterpart of `paddle_tpu/nn/initializer`).

Each draw takes the next key of the ported stream and computes the
reference's `jax.random` sampler on it, on the device the parameter is
made on (`_core.state.torch_device`): after the same `seed`, a uniform
draw is bit-equal to the reference's and a normal one is sqrt(2) *
erfinv of that uniform, within a few 1e-7 of it. `Orthogonal` is held by
its property (Q's columns orthonormal), not by its values: QR's signs
differ between libraries. Draws run in chunks (`_prng.CHUNK`), so a
128256 x 4096 leaf never holds a full-size int64 temporary.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ... import _prng
from ..._core import dtypes as _dt
from ..._core.state import prng, torch_device

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Dirac", "Orthogonal", "Bilinear", "calculate_gain",
    "set_global_initializer",
]

_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param if param is not None
                                            else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    return gains[nonlinearity]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels are stored (spatial..., in, out), as in the reference
    receptive = int(np.prod(shape[:-2]))
    return shape[-2] * receptive, shape[-1] * receptive


class Initializer:
    def __call__(self, param, block=None):
        param._replace(self._generate(tuple(param.shape), param.dtype))
        return param

    def _generate(self, shape, dtype):
        raise NotImplementedError


def _uniform(shape, dtype, lo, hi):
    u = _prng.uniform_real(prng.next_key(), shape, torch.float32, lo, hi,
                           device=torch_device())
    return u.to(_dt.convert_dtype(dtype))


def _normal(shape, dtype, mean, std):
    z = _prng.normal_real(prng.next_key(), shape, torch.float32,
                          device=torch_device())
    return _affine(z, mean, std).to(_dt.convert_dtype(dtype))


def _affine(z, mean, std):
    """mean + std * z as the reference computes it in float32: the
    Python scalars rounded to float32, then one fused multiply-add
    (`_prng._affine`)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=z.device)
    return _prng._affine(z, f32(std), f32(mean))


class Constant(Initializer):
    def __init__(self, value=0.0):
        self._value = value

    def _generate(self, shape, dtype):
        return torch.full(shape, self._value, dtype=_dt.convert_dtype(dtype),
                          device=torch_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self._mean, self._std = mean, std

    def _generate(self, shape, dtype):
        return _normal(shape, dtype, self._mean, self._std)


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self._mean, self._std, self._a, self._b = mean, std, a, b

    def _generate(self, shape, dtype):
        z = _prng.truncated_normal(prng.next_key(), self._a, self._b, shape,
                                   torch.float32, device=torch_device())
        return _affine(z, self._mean, self._std).to(_dt.convert_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self._low, self._high = low, high

    def _generate(self, shape, dtype):
        return _uniform(shape, dtype, self._low, self._high)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self._fan_in, self._fan_out, self._gain = fan_in, fan_out, gain

    def _generate(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self._gain * math.sqrt(2.0 / (fi + fo))
        z = _prng.normal_real(prng.next_key(), shape, torch.float32,
                              device=torch_device()) * std
        return z.to(_dt.convert_dtype(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self._fan_in, self._fan_out, self._gain = fan_in, fan_out, gain

    def _generate(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self._gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, dtype, -limit, limit)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self._fan_in = fan_in
        self._slope = negative_slope
        self._nonlinearity = nonlinearity

    def _generate(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        std = calculate_gain(self._nonlinearity, self._slope) / math.sqrt(fi)
        z = _prng.normal_real(prng.next_key(), shape, torch.float32,
                              device=torch_device()) * std
        return z.to(_dt.convert_dtype(dtype))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        self._fan_in = fan_in
        self._slope = negative_slope
        self._nonlinearity = nonlinearity

    def _generate(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        limit = calculate_gain(self._nonlinearity, self._slope) * \
            math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, -limit, limit)


class Assign(Initializer):
    def __init__(self, value, name=None):
        v = value._value.detach().cpu() if hasattr(value, "_value") else \
            value
        self._np = np.asarray(v)

    def _generate(self, shape, dtype):
        return torch.as_tensor(self._np.reshape(shape)).to(
            _dt.convert_dtype(dtype)).to(torch_device())


class Dirac(Initializer):
    def __init__(self, groups=1, name=None):
        self._groups = groups

    def _generate(self, shape, dtype):
        # kernel layout (spatial..., in, out)
        a = np.zeros(shape, dtype=np.float32)
        out_ch, in_ch = shape[-1], shape[-2]
        centers = tuple(s // 2 for s in shape[:-2])
        per = out_ch // self._groups
        for g in range(self._groups):
            for i in range(min(per, in_ch)):
                a[centers + (i, g * per + i)] = 1.0
        return torch.from_numpy(a).to(_dt.convert_dtype(dtype)).to(
            torch_device())


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self._gain = gain

    def _generate(self, shape, dtype):
        rows = shape[-1]
        cols = int(np.prod(shape)) // rows
        flat = _prng.normal_real(prng.next_key(),
                                 (max(rows, cols), min(rows, cols)),
                                 torch.float32, device=torch_device())
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self._gain * q[:rows, :cols].T.reshape(shape)).to(
            _dt.convert_dtype(dtype))


constant = Constant
normal = Normal
uniform = Uniform


class Bilinear(Initializer):
    """Bilinear-interpolation kernel for transposed-conv upsampling,
    kernel layout (spatial..., in, out)."""

    def _generate(self, shape, dtype):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer requires a 4-D weight")
        kh, kw, c_in, c_out = shape
        if kh != kw:
            raise ValueError("Bilinear initializer requires square kernels")
        f = int(np.ceil(kw / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        og = np.ogrid[:kh, :kw]
        filt = ((1 - abs(og[0] / f - c)) *
                (1 - abs(og[1] / f - c))).astype(np.float32)
        w = np.zeros(shape, np.float32)
        for i in range(min(c_in, c_out)):
            w[:, :, i, i] = filt
        if c_in != c_out:
            for o in range(c_out):
                w[:, :, o % c_in, o] = filt
        return torch.from_numpy(w).to(_dt.convert_dtype(dtype)).to(
            torch_device())
