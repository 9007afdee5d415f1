"""KV-page handoff payloads for disaggregated prefill/decode serving
(counterpart of `paddle_tpu/serving/handoff.py`).

A prefill engine finishes a request's prompt (and seeds its first
token), then exports the request's KV pages as a `KVHandoff`: host
tensors plus metadata, encoded on the tier's copy thread
(`HostTier.export_pages`). A decode engine takes it back in through a
request flagged with ``_kv_import = payload``: the engine scatters the
pages through the preemption swap-in path (`_scatter_host_kv`) and
generation continues token-identically (the device sampler's key is a
function of (seed, position) alone).

Page encoding follows the exporting tier's setting: ``quantized=True``
payloads carry int8 pages + per-token fp32 scales; ``quantized=False``
carries the pool's dtype verbatim. The importer dequantizes (or
quantizes) on the host to match its own pool.

Payloads are CPU tensors in the port and numpy arrays in the JAX
package; `handoff_from_jax` and `handoff_to_jax` carry one across
without changing a byte. The engine also imports a JAX payload as it
stands: it reads either kind.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["KVHandoff", "handoff_from_jax", "handoff_to_jax"]


class KVHandoff:
    """One request's exported KV state, mid-generation.

    k/v: (L, KVH, pages, page_size, D); ks/vs: matching (..., 1) fp32
    per-token scales or None. `length` is the cache length the pages are
    valid to (len(prompt) + len(output) - 1: everything decided except
    the pending `next_token`, which rides as metadata)."""

    __slots__ = ("rid", "trace_id", "prompt", "output", "next_token",
                 "length", "pages", "k", "v", "ks", "vs", "quantized",
                 "logprobs", "cached_tokens", "timeline")

    def __init__(self, rid, prompt, output, next_token, length, pages,
                 k, v, ks=None, vs=None, quantized=False, trace_id=None,
                 logprobs=None, cached_tokens=0, timeline=None):
        self.rid = rid
        self.trace_id = trace_id
        self.prompt = list(prompt)
        self.output = list(output)
        self.next_token = int(next_token)
        self.length = int(length)
        self.pages = int(pages)
        self.k = k
        self.v = v
        self.ks = ks
        self.vs = vs
        self.quantized = bool(quantized)
        self.logprobs = None if logprobs is None else list(logprobs)
        self.cached_tokens = int(cached_tokens)
        self.timeline = timeline

    @property
    def nbytes(self):
        """Wire size of the KV payload (metadata excluded)."""
        return sum(int(a.nbytes) for a in (self.k, self.v, self.ks, self.vs)
                   if a is not None)

    def __repr__(self):
        return (f"KVHandoff(rid={self.rid!r}, length={self.length}, "
                f"pages={self.pages}, quantized={self.quantized}, "
                f"nbytes={self.nbytes})")


def _fields(h):
    return {name: getattr(h, name) for name in KVHandoff.__slots__}


def _tensor(a):
    """A numpy payload array as a CPU tensor over the same bytes (a
    bfloat16 array, which numpy knows only through an extension dtype,
    by its 16-bit pattern)."""
    if a is None:
        return None
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()     # torch tensors are writable; the bytes are the same
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _array(t):
    """A CPU tensor payload as a numpy array of the same bytes; bf16 as
    the bfloat16 dtype of `ml_dtypes`, the JAX package's."""
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.contiguous().view(torch.int16).numpy().view(
            ml_dtypes.bfloat16)
    return t.numpy()


def handoff_from_jax(h):
    """The port's KVHandoff from one the JAX package made (numpy
    payloads): the same fields, the payloads as CPU tensors over the
    same bytes."""
    f = _fields(h)
    for name in ("k", "v", "ks", "vs"):
        f[name] = _tensor(f[name])
    return KVHandoff(**f)


def handoff_to_jax(h, cls):
    """The JAX package's KVHandoff (`cls`, which the port cannot import)
    from one of the port's: the same fields, the payloads as numpy
    arrays of the same bytes."""
    f = _fields(h)
    for name in ("k", "v", "ks", "vs"):
        f[name] = _array(f[name])
    return cls(**f)
