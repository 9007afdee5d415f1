"""Interpreter state: grad mode, the device tensors are made on, the PRNG
key stream and the AMP fields (counterpart of `paddle_tpu/_core/state.py`).

The grad mode is torch's own (`torch.is_grad_enabled`); there is no
second flag. The PRNG keeps the reference's explicit key stream: `seed`
sets a base key, every eager draw takes `fold_in(key(seed), counter)`
with the counter advanced first, and `key_ctx` pushes a key whose
fold-ins a block of code draws from instead. Keys are (1, 2) int64
tensors on the CPU (`_prng.key`); the draws they drive are bit-equal to
`jax.random`'s.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .. import _prng


class _ThreadState(threading.local):
    def __init__(self):
        self.amp_dtype = None      # active autocast dtype or None
        self.amp_level = "O0"
        self.amp_custom_white = set()
        self.amp_custom_black = set()


_state = _ThreadState()


def grad_enabled() -> bool:
    return torch.is_grad_enabled()


def no_grad_ctx():
    return torch.no_grad()


def enable_grad_ctx():
    return torch.enable_grad()


def set_grad_enabled(mode: bool):
    torch.set_grad_enabled(bool(mode))


def amp_state():
    return _state


# ---------------------------------------------------------------------------
# The device: "gpu:0" unless the caller asked for the CPU. Nothing falls
# back to the CPU by itself.
# ---------------------------------------------------------------------------
_device = None       # None: the card; else "cpu" or "gpu:<i>"


def set_device(device):
    """"cpu", "gpu" or "gpu:<i>" (also "cuda[:i]"). Returns the device
    string get_device reports."""
    global _device
    d = str(device).lower()
    if d.startswith("cuda"):
        d = "gpu" + d[4:]
    if d == "gpu":
        d = "gpu:0"
    if d != "cpu" and not (d.startswith("gpu:") and d[4:].isdigit()):
        raise ValueError(f"set_device: unknown device {device!r}; use "
                         "'cpu' or 'gpu[:i]'")
    _device = d
    return get_device()


def get_device():
    return _device or "gpu:0"


def torch_device() -> torch.device:
    """The torch device new tensors and parameters go to. Raises
    RuntimeError without a CUDA device unless `set_device("cpu")` was
    called."""
    d = get_device()
    if d == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch: no CUDA device is available; call "
            'paddle.set_device("cpu") to run on the CPU')
    return torch.device("cuda", int(d[4:]))


# ---------------------------------------------------------------------------
# PRNG: a stateful global key stream for eager mode, plus a key-context
# stack for code that threads its own keys.
# ---------------------------------------------------------------------------
class _PRNGState:
    def __init__(self, seed: int = 0):
        self._np_lock = threading.Lock()
        self.seed(seed)
        self._ctx_stack = []  # list of [key, counter]

    def seed(self, s: int):
        self._seed = int(s)
        self._key = _prng.key(self._seed)
        self._eager_counter = 0

    def next_key(self):
        """A fresh (1, 2) key: inside a key context the pushed key folded
        with that context's counter, else the base key folded with the
        advanced eager counter."""
        if self._ctx_stack:
            entry = self._ctx_stack[-1]
            k = _prng.fold_in(entry[0], torch.tensor([entry[1]]))
            entry[1] += 1
            return k
        self._eager_counter += 1
        return _prng.fold_in(self._key, torch.tensor([self._eager_counter]))

    def next_np_seed(self) -> int:
        """A 32-bit seed for a host-side numpy Generator, deterministic
        under seed()."""
        with self._np_lock:
            self._eager_counter += 1
            return (self._seed * 1000003 + self._eager_counter) & 0xFFFFFFFF

    @contextlib.contextmanager
    def key_ctx(self, key):
        self._ctx_stack.append([key.reshape(1, 2), 0])
        try:
            yield
        finally:
            self._ctx_stack.pop()


prng = _PRNGState(0)


def seed(s: int):
    prng.seed(s)
    return prng


def get_rng_state():
    return {"seed": prng._seed, "counter": prng._eager_counter}


def set_rng_state(st):
    prng.seed(st["seed"])
    prng._eager_counter = st["counter"]
