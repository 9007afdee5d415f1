"""Threefry-2x32 draws that reproduce the JAX package's device sampler
bit for bit.

The serving step draws a sampled row's token as
`jax.random.categorical(fold_in(key, tok_pos + 1), logits)` over raw
uint32 (2,) keys that the host builds from the request's seed
(`paddle_tpu/models/llama_serving.py`, `_filter_draw` and `Request`).
This module computes the same function with torch integer ops, on
whatever device the operands live on, so a seeded request is
token-identical across the two packages:

  * `threefry2x32` — the Threefry-2x32 block cipher, 20 rounds, as JAX
    lowers it. uint32 arithmetic is emulated in int64 with a 32-bit mask
    (torch has no general uint32 arithmetic);
  * `fold_in(key, data)` — `threefry2x32(key, (0, data))`;
  * `random_bits(key, n)` — JAX's partitionable layout
    (`jax_threefry_partitionable=True`): element i hashes the counter
    pair (hi, lo) = (0, i) and the two output words are XORed;
  * `uniform` — the 23 high bits as mantissa of a float in [1, 2),
    minus 1, mapped to [tiny, 1);
  * `gumbel` — -log(-log(u));
  * `categorical` — argmax(gumbel + logits).

Bits and uniforms match JAX exactly. The Gumbel noise goes through
`log`, whose last bit may differ between libraries; a draw flips only if
two candidates' noisy scores tie to that bit.

The Paddle-shaped surface (`tensor/random.py`, `nn/initializer`) draws
through the second half of this module, which follows `jax.random` on
one (1, 2) key:

  * `key(seed)` — `jax.random.key(seed)`: the words (seed >> 32, seed);
  * `split(key, n)` — the partitionable split, key i = fold_in(key, i);
  * `bits(key, shape, width)` — `random_bits` of 8, 16, 32 or 64 bits
    over the flat index as a 64-bit counter (hi, lo), computed in
    chunks of `CHUNK` elements so that a 525M-element leaf never holds
    more than one chunk of int64 temporaries;
  * `uniform_real`, `normal_real`, `truncated_normal`, `randint`,
    `permutation`, `bernoulli` — the samplers of `jax.random` on those
    bits. Uniform draws, integers and permutations are bit-equal to
    JAX's; a normal draw is sqrt(2) * erfinv(u) of the bit-equal
    uniform through XLA's own float32 erfinv polynomial, whose log1p may
    differ from XLA's in the last bit (about 1 draw in 100 differs, by
    at most a few 1e-7).
"""
from __future__ import annotations

import torch

__all__ = ["threefry2x32", "fold_in", "random_bits", "uniform", "gumbel",
           "categorical", "key", "split", "bits", "uniform_real",
           "normal_real", "truncated_normal", "bernoulli", "randint",
           "permutation"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 over int64 tensors holding uint32 values; k1/k2
    broadcast against x1/x2. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def fold_in(key, data):
    """key: (N, 2) int64 uint32 words; data: (N,) integers (taken mod
    2**32, as JAX casts them to uint32). Returns the (N, 2) folded
    keys."""
    d = data.to(torch.int64) & _M32
    y1, y2 = threefry2x32(key[:, 0], key[:, 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key, n):
    """(N, n) uint32 words (in int64) for N keys, JAX's partitionable
    layout: counter i = (0, i), output word = y1 ^ y2."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)[None, :]
    y1, y2 = threefry2x32(key[:, :1], key[:, 1:], torch.zeros_like(lo), lo)
    return y1 ^ y2


def uniform(key, n):
    """(N, n) float32 in [tiny, 1), bit-equal to
    `jax.random.uniform(k, (n,), minval=tiny, maxval=1.)` per key."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # JAX maps to [minval, maxval) as f * (maxval - minval) + minval;
    # 1 - tiny rounds to 1.0 in float32, so that is f + tiny
    return torch.clamp_min(f + _TINY, _TINY)


def gumbel(key, n):
    return -torch.log(-torch.log(uniform(key, n)))


def categorical(key, logits):
    """One draw per row: key (N, 2), logits (N, V) float32 -> (N,)
    int64 indices."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)


# ------------------------------------------------- jax.random on one key
CHUNK = 1 << 22
_UINT_MASK = {8: 0xFF, 16: 0xFFFF}


def key(seed):
    """`jax.random.key(seed)` as a (1, 2) int64 tensor on the CPU."""
    seed = int(seed)
    return torch.tensor([[(seed >> 32) & _M32, seed & _M32]],
                        dtype=torch.int64)


def split(k, n=2):
    """(n, 2) keys: key i hashes the counter (0, i), as JAX's
    partitionable split does."""
    k = k.reshape(1, 2)
    return fold_in(k.expand(n, 2), torch.arange(n, dtype=torch.int64))


def _chunk_words(k, start, n, device):
    """The two Threefry output words for flat counters [start, start+n)
    under one key."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    k = k.to(device)
    return threefry2x32(k[0, 0], k[0, 1], idx >> 32, idx & _M32)


def _words_to_bits(y1, y2, width):
    if width == 64:
        return (y1 << 32) | y2          # wraps to int64, as a bit pattern
    w = y1 ^ y2
    return w if width == 32 else w & _UINT_MASK[width]


def bits(k, shape, width=32, device="cpu"):
    """`jax.random.bits(key, shape, uint{width})` as int64 values (the
    64-bit width as a two's-complement bit pattern)."""
    n = 1
    for s in shape:
        n *= int(s)
    out = torch.empty(n, dtype=torch.int64, device=device)
    for s in range(0, n, CHUNK):
        m = min(CHUNK, n - s)
        out[s:s + m] = _words_to_bits(*_chunk_words(k, s, m, device), width)
    return out.reshape(tuple(shape))


# mantissa bits kept, the exponent of 1.0, and the int view of each float
_FLOAT_BITS = {torch.float64: (64, 52, 0x3FF0000000000000, torch.int64),
               torch.float32: (32, 23, 0x3F800000, torch.int32),
               torch.float16: (16, 10, 0x3C00, torch.int16),
               torch.bfloat16: (8, 7, 0x3F80, torch.int16)}


def _unit_floats(y1, y2, dtype):
    """JAX's uniform floats in [0, 1) of `dtype` from Threefry words."""
    rng_bits, nmant, one, ity = _FLOAT_BITS[dtype]
    if rng_bits == 64:
        mant = ((y1 << 20) | (y2 >> 12)) & ((1 << 52) - 1)
    else:
        mant = _words_to_bits(y1, y2, rng_bits) >> (rng_bits - nmant)
    return (mant | one).to(ity).view(dtype) - 1.0


def _fill(k, shape, dtype, device, fn):
    """out = fn(unit floats) chunk by chunk over the flat index."""
    n = 1
    for s in shape:
        n *= int(s)
    out = torch.empty(n, dtype=dtype, device=device)
    for s in range(0, n, CHUNK):
        m = min(CHUNK, n - s)
        out[s:s + m] = fn(_unit_floats(*_chunk_words(k, s, m, device),
                                       dtype))
    return out.reshape(tuple(shape))


def _scalar(v, dtype, device):
    return torch.as_tensor(v, dtype=dtype, device=device)


def _affine(f, span, lo):
    """f * span + lo as XLA's CPU backend computes it: a fused
    multiply-add for float32 (the product of two 24-bit mantissas is
    exact in float64, so the float64 sum rounds once), float16 through
    float32, bfloat16 rounded after each op, float64 plain."""
    if f.dtype == torch.float32:
        return (f.double() * span.double() + lo.double()).float()
    if f.dtype == torch.float16:
        return (f.float() * span.float() + lo.float()).half()
    return f * span + lo


def uniform_real(k, shape, dtype=torch.float32, minval=0.0, maxval=1.0,
                 device="cpu"):
    """`jax.random.uniform(key, shape, dtype, minval, maxval)`."""
    lo = _scalar(minval, dtype, device)
    hi = _scalar(maxval, dtype, device)
    span = hi - lo
    return _fill(k, shape, dtype, device,
                 lambda f: torch.maximum(lo, _affine(f, span, lo)))


# XLA's float32 erf_inv (Giles' approximation): the polynomial in w - 2.5
# for w = -log1p(-x * x) < 5, else in sqrt(w) - 3
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GT = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x):
    """erfinv as XLA computes it for float32 (each Horner step a fused
    multiply-add); torch's own for other dtypes."""
    if x.dtype != torch.float32:
        return torch.erfinv(x)
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    lt_c = torch.tensor(_ERFINV_LT, dtype=torch.float32, device=x.device)
    gt_c = torch.tensor(_ERFINV_GT, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lt_c[0], gt_c[0])
    for i in range(1, len(_ERFINV_LT)):
        c = torch.where(lt, lt_c[i], gt_c[i])
        p = (c.double() + p.double() * w).float()
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max,
                       p * x)


def normal_real(k, shape, dtype=torch.float32, device="cpu"):
    """`jax.random.normal(key, shape, dtype)`: sqrt(2) * erfinv(u), u
    uniform on [nextafter(-1, 0), 1)."""
    lo = torch.nextafter(_scalar(-1.0, dtype, "cpu"),
                         _scalar(0.0, dtype, "cpu")).to(device)
    hi = _scalar(1.0, dtype, device)
    span = hi - lo
    sqrt2 = _scalar(2.0 ** 0.5, dtype, device)
    return _fill(k, shape, dtype, device,
                 lambda f: sqrt2 * _erfinv(torch.maximum(
                     lo, _affine(f, span, lo))))


def truncated_normal(k, lower, upper, shape, dtype=torch.float32,
                     device="cpu"):
    """`jax.random.truncated_normal(key, lower, upper, shape, dtype)`."""
    sqrt2 = _scalar(2.0 ** 0.5, dtype, device)
    lo_t = _scalar(lower, dtype, device)
    hi_t = _scalar(upper, dtype, device)
    a = torch.erf(lo_t / sqrt2)
    b = torch.erf(hi_t / sqrt2)
    span = b - a
    inf = _scalar(float("inf"), dtype, device)
    lo_c = torch.nextafter(lo_t, inf)
    hi_c = torch.nextafter(hi_t, -inf)
    return _fill(k, shape, dtype, device, lambda f: torch.clamp(
        sqrt2 * _erfinv(torch.maximum(a, _affine(f, span, a))), lo_c,
        hi_c))


def bernoulli(k, p, shape, device="cpu"):
    """`jax.random.bernoulli(key, p, shape)` for a Python float p, which
    JAX draws against a float64 uniform."""
    return uniform_real(k, shape, torch.float64, device=device) < p


def randint(k, shape, low, high, nbits=64):
    """`jax.random.randint(key, shape, low, high)` with an int{nbits}
    dtype, as an int64 numpy array (the unsigned remainders are taken on
    the host in numpy's uint64)."""
    import numpy as np
    k1, k2 = split(k)
    u = np.uint64
    hb = bits(k1[None], shape, nbits).numpy().view(np.uint64)
    lb = bits(k2[None], shape, nbits).numpy().view(np.uint64)
    if nbits == 32:
        hb, lb = hb & u(_M32), lb & u(_M32)
    low, high = int(low), int(high)
    span = u(1) if high <= low else u((high - low) % (1 << nbits))
    mult = u((1 << (nbits // 2)) % int(span))
    mult = u((int(mult) * int(mult)) % int(span))
    with np.errstate(over="ignore"):
        off = (hb % span) * mult + (lb % span)
        if nbits == 32:
            off = off & u(_M32)
    off = off % span
    return (np.asarray(off, dtype=np.uint64).astype(np.int64) + low)


def permutation(k, n):
    """`jax.random.permutation(key, n)`: rounds of stable sorts on fresh
    32-bit keys."""
    import math
    x = torch.arange(n, dtype=torch.int64)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_M32)))
    for _ in range(rounds):
        ks = split(k)
        k, sub = ks[0:1], ks[1:2]
        order = torch.sort(bits(sub, (n,), 32), stable=True).indices
        x = x[order]
    return x
