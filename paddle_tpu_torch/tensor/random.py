"""Random ops (counterpart of `paddle_tpu/tensor/random.py`).

Every draw takes a key from the ported stream (`_core.state.prng`) and
computes `jax.random`'s sampler on it (`_prng`), on the device the tensor
is made on: after the same `seed`, `rand`, `randint`, `randperm` and
`uniform` give the reference's values bit for bit, `randn` and `normal`
within a few 1e-7."""
from __future__ import annotations

import numpy as np
import torch

from .. import _prng
from .._core import dtypes as _dt
from .._core.state import prng, torch_device
from .._core.tensor import Tensor, apply, unwrap

__all__ = [
    "rand", "randn", "randint", "randint_like", "randperm", "uniform",
    "normal", "standard_normal", "poisson", "bernoulli", "multinomial",
    "uniform_", "normal_", "exponential_", "binomial", "standard_gamma",
    "log_normal", "seed", "get_rng_state", "set_rng_state",
]


def _shape_list(shape):
    if isinstance(shape, Tensor):
        return tuple(int(v) for v in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(unwrap(s)) for s in shape)


def seed(s):
    from .._core import state
    state.seed(int(s))
    return state.prng


def get_rng_state():
    from .._core import state
    return state.get_rng_state()


def set_rng_state(st):
    from .._core import state
    state.set_rng_state(st)


def _d(dtype):
    return _dt.convert_dtype(dtype) if dtype else _dt.get_default_dtype()


def rand(shape, dtype=None, name=None):
    return Tensor(_prng.uniform_real(prng.next_key(), _shape_list(shape),
                                     _d(dtype), device=torch_device()))


def randn(shape, dtype=None, name=None):
    return Tensor(_prng.normal_real(prng.next_key(), _shape_list(shape),
                                    _d(dtype), device=torch_device()))


standard_normal = randn


def _randint(shape, low, high, d, device):
    v = _prng.randint(prng.next_key(), shape, low, high)
    return torch.from_numpy(v).to(d).to(device)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    d = _dt.convert_dtype(dtype) if dtype else _dt.int64
    return Tensor(_randint(_shape_list(shape), low, high, d, torch_device()))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    d = _dt.convert_dtype(dtype) if dtype else x.dtype
    return Tensor(_randint(tuple(x.shape), low, high, d, x._value.device))


def randperm(n, dtype="int64", name=None):
    return Tensor(_prng.permutation(prng.next_key(), int(n)).to(
        _dt.convert_dtype(dtype)).to(torch_device()))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    key = _prng.key(int(seed)) if seed else prng.next_key()
    return Tensor(_prng.uniform_real(key, _shape_list(shape), _d(dtype),
                                     float(unwrap(min)), float(unwrap(max)),
                                     device=torch_device()))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    key = _prng.key(int(seed)) if seed else prng.next_key()
    x._replace(_prng.uniform_real(key, tuple(x.shape), x.dtype,
                                  float(unwrap(min)), float(unwrap(max)),
                                  device=x._value.device))
    return x


def normal(mean=0.0, std=1.0, shape=None, name=None):
    d = _dt.get_default_dtype()
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = unwrap(mean), unwrap(std)
        dev = (m if isinstance(m, torch.Tensor) else s).device
        sh = torch.broadcast_shapes(tuple(np.shape(m) if not isinstance(
            m, torch.Tensor) else m.shape), tuple(np.shape(s) if not
            isinstance(s, torch.Tensor) else s.shape))
        z = _prng.normal_real(prng.next_key(), sh, d, device=dev)
        return Tensor(m + s * z)
    z = _prng.normal_real(prng.next_key(), _shape_list(shape), d,
                          device=torch_device())
    return Tensor(float(mean) + float(std) * z)


def normal_(x, mean=0.0, std=1.0, name=None):
    z = _prng.normal_real(prng.next_key(), tuple(x.shape), torch.float32,
                          device=x._value.device)
    x._replace((float(mean) + float(std) * z).to(x.dtype))
    return x


def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    z = _prng.normal_real(prng.next_key(), _shape_list(shape),
                          _dt.get_default_dtype(), device=torch_device())
    return Tensor(torch.exp(float(mean) + float(std) * z))


def bernoulli(x, name=None):
    key = prng.next_key()
    return apply(lambda p: (_prng.uniform_real(
        key, tuple(p.shape), p.dtype, device=p.device) < p).to(p.dtype), x)


def exponential_(x, lam=1.0, name=None):
    u = _prng.uniform_real(prng.next_key(), tuple(x.shape), torch.float32,
                           1e-7, 1.0, device=x._value.device)
    x._replace((-torch.log(u) / float(lam)).to(x.dtype))
    return x


def multinomial(x, num_samples=1, replacement=False, name=None):
    """The reference's draws: with replacement `jax.random.categorical`
    (Gumbel noise in the logits' dtype, one row of noise per sample),
    without it the top num_samples of the logits plus float64 Gumbel
    noise."""
    key = prng.next_key()

    def gumbel(shape, dtype, device):
        u = _prng.uniform_real(key, shape, dtype, torch.finfo(dtype).tiny,
                               1.0, device=device)
        return -torch.log(-torch.log(u))

    def fn(p):
        logits = torch.log(torch.clamp_min(p, 1e-30))
        if replacement:
            g = gumbel((num_samples,) + tuple(p.shape), logits.dtype,
                       p.device)
            return torch.argmax(logits + g, -1).movedim(0, -1)
        g = gumbel(tuple(p.shape), torch.float64, p.device)
        return torch.topk(logits + g, num_samples, -1).indices
    return apply(fn, x)


def _generator(device):
    """A torch Generator seeded from the next key of the stream, for the
    samplers whose jax.random algorithms are rejection loops (poisson,
    binomial, gamma): the same seed gives the same draws, from torch's
    sampler rather than bit-equal to JAX's."""
    seed = int(_prng.bits(prng.next_key(), (1,))[0])
    return torch.Generator(device=device).manual_seed(seed)


def poisson(x, name=None):
    gen = _generator(x._value.device)
    return apply(lambda lam: torch.poisson(lam, generator=gen), x)


def binomial(count, prob, name=None):
    gen = _generator(unwrap(prob).device)
    return apply(lambda n, p: torch.binomial(
        n.float(), p.float(), generator=gen).to(torch.int64), count, prob)


def standard_gamma(x, name=None):
    gen = _generator(x._value.device)
    return apply(lambda a: torch._standard_gamma(a, generator=gen), x)
