"""Length-framed socket framing for the fleet plane's bulk channel
(counterpart of `paddle_tpu/serving/wire.py`; its frames are the
reference's, byte for byte, so either package reads the other's).

The fleet control plane (`serving/fleet.py`) rides
`distributed/rpc.py` — small pickled frames between named workers. KV
page payloads do not: a handoff is tens of megabytes, and pickling it
would buffer a second copy, tie the bulk path to the pickle trust
boundary, and hide the wire size from accounting. This module is the
bulk wire format instead:

  * **JSON control frames** — `send_json`/`recv_json`: a 4-byte `<I`
    length prefix + UTF-8 JSON.
  * **Raw byte frames** — `send_bytes`/`recv_bytes`: an 8-byte `<Q`
    length prefix + the payload, sent in 1 MiB memoryview slices so a
    large page set never materializes a second contiguous copy on the
    send side.
  * **Arrays** — `send_array`/`recv_array`: a JSON header
    `{dtype, shape}` (or `{none: true}`) followed by the raw bytes of a
    C-contiguous array. The header's dtype is numpy's `dtype.str`, as
    the reference writes it. The port sends and receives CPU tensors.
  * **KV handoffs** — `send_handoff`/`recv_handoff`: the `KVHandoff`'s
    scalar/list metadata as one JSON frame, then its k/v/ks/vs arrays.

bfloat16: the reference writes an ml_dtypes bfloat16 array's
`dtype.str`, which is `<V2` (a 2-byte void), and its own receiver gives
back an untyped `|V2` array. The port writes a bf16 tensor the same way
(a `<V2` header, the raw bytes) and reads any 2-byte void body as
`torch.bfloat16`: no other 2-byte void reaches the wire in either
package.

Errors surface as `WireError` (a `ConnectionError` subclass). Oversize
frames are refused on both ends — a corrupt length prefix fails in one
clear exception instead of a multi-gigabyte allocation.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch

from .handoff import KVHandoff

__all__ = ["WireError", "WireAccount", "send_json", "recv_json",
           "send_bytes", "recv_bytes", "send_array", "recv_array",
           "send_handoff", "recv_handoff", "MAX_JSON_FRAME",
           "MAX_BULK_FRAME"]

_JLEN = struct.Struct("<I")
_BLEN = struct.Struct("<Q")
_CHUNK = 1 << 20

# control frames are metadata — anything bigger is a protocol bug
MAX_JSON_FRAME = 64 << 20
# bulk frames carry KV pages; cap matches the rpc layer's _MAX_FRAME
MAX_BULK_FRAME = 1 << 30

# numpy's dtype.str of ml_dtypes' bfloat16, as the reference writes it
_BF16_STR = "<V2"


class WireError(ConnectionError):
    """Framing violation on the fleet bulk channel (oversize frame,
    truncated stream, malformed header)."""


class WireAccount:
    """Per-channel byte/frame accounting at the framing layer.

    Every send/recv below takes an optional `acct`; each framed unit
    (length prefix + payload) books its actual wire bytes, so the
    `pt_wire_{tx,rx}_bytes` / `pt_wire_frames` series measure the
    socket, not the payload a caller thinks it sent. Local integer
    tallies (`tx_bytes`/`rx_bytes`/`frames`) always accumulate, and any
    bound counters (duck-typed `.inc(n)`) tick alongside. An account is
    fed from one framing call at a time; share only the bound counters
    (which lock internally), not the account object, across threads.
    """

    __slots__ = ("tx_bytes", "rx_bytes", "frames", "_tx", "_rx", "_fr")

    def __init__(self, tx=None, rx=None, frames=None):
        self.tx_bytes = 0
        self.rx_bytes = 0
        self.frames = 0
        self._tx = tx
        self._rx = rx
        self._fr = frames

    def sent(self, n):
        self.tx_bytes += n
        self.frames += 1
        if self._tx is not None:
            self._tx.inc(n)
        if self._fr is not None:
            self._fr.inc()

    def received(self, n):
        self.rx_bytes += n
        self.frames += 1
        if self._rx is not None:
            self._rx.inc(n)
        if self._fr is not None:
            self._fr.inc()


def _recv_exact(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise WireError("fleet wire: peer closed mid-frame")
        got += r
    return buf


def send_json(sock, obj, acct=None):
    """One JSON control frame. Returns the framed wire bytes."""
    payload = json.dumps(obj).encode()
    if len(payload) > MAX_JSON_FRAME:
        raise WireError(
            f"fleet wire: json frame {len(payload)}B exceeds "
            f"{MAX_JSON_FRAME}B cap")
    sock.sendall(_JLEN.pack(len(payload)) + payload)
    n = _JLEN.size + len(payload)
    if acct is not None:
        acct.sent(n)
    return n


def recv_json(sock, acct=None):
    (n,) = _JLEN.unpack(_recv_exact(sock, _JLEN.size))
    if n > MAX_JSON_FRAME:
        raise WireError(
            f"fleet wire: json frame {n}B exceeds {MAX_JSON_FRAME}B cap")
    try:
        obj = json.loads(_recv_exact(sock, n).decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise WireError(f"fleet wire: malformed json frame: {e}") from e
    if acct is not None:
        acct.received(_JLEN.size + n)
    return obj


def send_bytes(sock, data, acct=None):
    """One bulk frame: 8-byte length + payload, chunked so the kernel
    paces a large page set without a second contiguous copy. Returns
    the framed wire bytes."""
    # a flat byte view: an N-D memoryview's len() counts its first
    # dimension, not bytes
    view = memoryview(data).cast("B")
    if len(view) > MAX_BULK_FRAME:
        raise WireError(
            f"fleet wire: bulk frame {len(view)}B exceeds "
            f"{MAX_BULK_FRAME}B cap")
    sock.sendall(_BLEN.pack(len(view)))
    for off in range(0, len(view), _CHUNK):
        sock.sendall(view[off:off + _CHUNK])
    n = _BLEN.size + len(view)
    if acct is not None:
        acct.sent(n)
    return n


def recv_bytes(sock, acct=None):
    (n,) = _BLEN.unpack(_recv_exact(sock, _BLEN.size))
    if n > MAX_BULK_FRAME:
        raise WireError(
            f"fleet wire: bulk frame {n}B exceeds {MAX_BULK_FRAME}B cap")
    raw = _recv_exact(sock, n)
    if acct is not None:
        acct.received(_BLEN.size + n)
    return raw


def _host_array(t):
    """(numpy dtype.str, C-contiguous numpy view of the bytes) of a CPU
    tensor; bf16 as the reference writes it."""
    if t.device.type != "cpu":
        raise ValueError(
            f"fleet wire: ships host tensors, got one on {t.device}")
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return _BF16_STR, t.view(torch.int16).numpy()
    a = t.numpy()
    return a.dtype.str, a


def send_array(sock, arr, acct=None):
    """One optional CPU tensor: JSON header {dtype, shape} + raw bytes
    (C-order). `None` ships as {"none": true} with no body."""
    if arr is None:
        send_json(sock, {"none": True}, acct=acct)
        return 0
    dtype, a = _host_array(arr)
    send_json(sock, {"dtype": dtype, "shape": list(a.shape)}, acct=acct)
    send_bytes(sock, a.data, acct=acct)
    return int(a.nbytes)


def recv_array(sock, acct=None):
    """One optional array as a CPU tensor (None for a `none` header).
    A 2-byte void body is bfloat16."""
    head = recv_json(sock, acct=acct)
    if head.get("none"):
        return None
    try:
        dtype = np.dtype(head["dtype"])
        shape = tuple(int(d) for d in head["shape"])
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"fleet wire: bad array header {head!r}") from e
    bf16 = dtype.kind == "V" and dtype.itemsize == 2
    if dtype.kind == "V" and not bf16:
        raise WireError(f"fleet wire: untyped array header {head!r}")
    raw = recv_bytes(sock, acct=acct)
    want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if len(raw) != want:
        raise WireError(
            f"fleet wire: array body {len(raw)}B != header {want}B")
    # the received buffer is this tensor's own, writable memory
    if bf16:
        return torch.from_numpy(np.frombuffer(raw, np.int16).reshape(
            shape)).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, dtype=dtype).reshape(shape))


def send_handoff(sock, h, acct=None):
    """Ship one KVHandoff: metadata JSON frame, then k/v/ks/vs.
    Returns the payload bytes framed (the pt_handoff_bytes_total
    measurement for a socket-backed handoff)."""
    send_json(sock, {
        "rid": str(h.rid), "trace_id": h.trace_id,
        "prompt": [int(t) for t in h.prompt],
        "output": [int(t) for t in h.output],
        "next_token": int(h.next_token), "length": int(h.length),
        "pages": int(h.pages), "quantized": bool(h.quantized),
        "logprobs": h.logprobs, "cached_tokens": int(h.cached_tokens),
        "timeline": h.timeline,
    }, acct=acct)
    n = 0
    for a in (h.k, h.v, h.ks, h.vs):
        n += send_array(sock, a, acct=acct)
    return n


def recv_handoff(sock, acct=None):
    meta = recv_json(sock, acct=acct)
    k = recv_array(sock, acct=acct)
    v = recv_array(sock, acct=acct)
    ks = recv_array(sock, acct=acct)
    vs = recv_array(sock, acct=acct)
    try:
        return KVHandoff(
            meta["rid"], meta["prompt"], meta["output"],
            meta["next_token"], meta["length"], meta["pages"], k, v,
            ks=ks, vs=vs, quantized=meta["quantized"],
            trace_id=meta.get("trace_id"),
            logprobs=meta.get("logprobs"),
            cached_tokens=meta.get("cached_tokens", 0),
            timeline=meta.get("timeline"))
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"fleet wire: bad handoff metadata: {e}") from e
