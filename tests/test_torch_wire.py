"""The port's bulk wire (`paddle_tpu_torch.serving.wire`) and control
plane (`paddle_tpu_torch.distributed.rpc`) held to the JAX package's on
the CPU, across the packages:

  * the frames are byte-identical: on a socketpair, the port's
    `send_json`, `send_bytes` (chunked past 1 MiB), `send_array` (fp32,
    int8, bf16, None) and `send_handoff` (int8 with scales, verbatim
    fp32 and bf16) write the reference's bytes for the same payload;
  * each side reads the other's frames bit for bit; bf16 goes port to
    port and reference to port (the reference's own receiver gives an
    untyped `|V2` array: ROADMAP.md Queue 3);
  * bf16 on the reference's side: its `send_array` writes the `<V2`
    header and then raises (numpy cannot export an ml_dtypes bfloat16
    array as a buffer: ROADMAP.md Queue 3), so its bf16 frames here are
    what its framing functions write for that header and those bytes;
  * oversize frames are refused at both ends before any byte is sent or
    any body allocated;
  * `_ring_point` is the reference's on 256 keys;
  * a port `_TCPStore` master serves a JAX client and the reverse, and a
    JAX `RpcAgent` and a port `RpcAgent` in one world of two call
    builtins on each other, sync and async, a remote exception raising
    at the caller;
  * `PT_RPC_TIMEOUT_S` resolves as in the reference.

Every socket binds port 0 on 127.0.0.1."""
import operator
import socket
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import rpc as JRPC
from paddle_tpu.serving import fleet as JFL
from paddle_tpu.serving import wire as JW
from paddle_tpu.serving.handoff import KVHandoff as JKVHandoff
from paddle_tpu_torch.distributed import rpc as PRPC
from paddle_tpu_torch.serving import fleet as PFL
from paddle_tpu_torch.serving import wire as PW
from paddle_tpu_torch.serving.handoff import KVHandoff, handoff_from_jax

WAIT_S = 30
RNG = np.random.default_rng(0)
# numpy payloads of the reference; the port's are CPU tensors over the
# same bytes
ARRAYS = {
    "fp32": RNG.standard_normal((3, 5, 7)).astype(np.float32),
    "int8": RNG.integers(-127, 128, (2, 2, 3, 8, 8)).astype(np.int8),
    "bf16": RNG.standard_normal((4, 9)).astype(ml_dtypes.bfloat16),
    "none": None,
}


def _tensor(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    """The raw bytes of a tensor or an array (bf16 by its bit pattern)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _handoffs():
    """{name: (reference KVHandoff, port KVHandoff)} of the same payload."""
    k = RNG.integers(-127, 127, (2, 2, 3, 8, 8)).astype(np.int8)
    ks = RNG.random((2, 2, 3, 8, 1), dtype=np.float32)
    meta = dict(trace_id="t-1", cached_tokens=8, logprobs=[-0.5, -1.25],
                timeline={"marks": [["submit", 0.0]]})
    out = {"int8": JKVHandoff("rid-1", [1, 2, 3], [4, 5], 6, 5, 3, k,
                              np.array(k[::-1]), ks=ks, vs=np.array(ks),
                              quantized=True, **meta)}
    for name, dt in (("fp32", np.float32), ("bf16", ml_dtypes.bfloat16)):
        v = RNG.standard_normal((2, 2, 1, 8, 8)).astype(dt)
        out[name] = JKVHandoff("rid-2", [9] * 8, [3], 2, 8, 1, v,
                               np.array(v[:, ::-1]), quantized=False)
    return {n: (h, handoff_from_jax(h)) for n, h in out.items()}


HANDOFFS = _handoffs()


def _ref_array_frames(sock, arr, acct=None):
    """The reference's `send_array` for a bf16 array as its framing
    functions write it (its own call raises after the header)."""
    if arr is None or arr.dtype != ml_dtypes.bfloat16:
        return _REF_SEND_ARRAY(sock, arr, acct=acct)
    JW.send_json(sock, {"dtype": arr.dtype.str, "shape": list(arr.shape)},
                 acct=acct)
    JW.send_bytes(sock, arr.view(np.uint16).data, acct=acct)
    return int(arr.nbytes)


_REF_SEND_ARRAY = JW.send_array


@pytest.fixture
def ref_bf16(monkeypatch):
    monkeypatch.setattr(JW, "send_array", _ref_array_frames)


def test_the_reference_cannot_send_bf16():
    """The reference-side quirk the bf16 cases work around: the header
    goes out, then numpy refuses the buffer."""
    a = ARRAYS["bf16"]
    assert a.dtype.str == "<V2"
    with pytest.raises(ValueError, match="buffer"):
        _stream(lambda s: _REF_SEND_ARRAY(s, a))


def _stream(send):
    """The bytes `send(sock)` writes to a socketpair, read on the other
    end until the writer closes."""
    a, b = socket.socketpair()
    got = bytearray()

    def read():
        while chunk := b.recv(1 << 16):
            got.extend(chunk)

    t = threading.Thread(target=read)
    t.start()
    with a:
        send(a)
    t.join(WAIT_S)
    b.close()
    return bytes(got)


def _across(send, recv):
    """recv(sock) of what send(sock) wrote, over a socketpair."""
    a, b = socket.socketpair()
    a.settimeout(WAIT_S)
    b.settimeout(WAIT_S)
    out = []
    t = threading.Thread(target=lambda: out.append(recv(b)))
    t.start()
    with a:
        send(a)
    t.join(WAIT_S)
    b.close()
    return out[0]


# ---------------------------------------------------------------------------
# byte identity


FRAMES = {
    "json": (lambda W, s: W.send_json(s, {"op": "x", "n": 7, "l": [1, 2],
                                         "none": None, "f": 0.1}),) * 2,
    "bytes_chunked": (lambda W, s: W.send_bytes(
        s, bytes(range(256)) * (3 * 4096 + 17)),) * 2,
    **{f"array_{n}": (lambda W, s, a=a: W.send_array(s, a),
                      lambda W, s, a=a: W.send_array(s, _tensor(a)))
       for n, a in ARRAYS.items()},
    **{f"handoff_{n}": (lambda W, s, h=hs[0]: W.send_handoff(s, h),
                        lambda W, s, h=hs[1]: W.send_handoff(s, h))
       for n, hs in HANDOFFS.items()},
}


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_frames_are_byte_identical(frame, ref_bf16):
    ref_send, port_send = FRAMES[frame]
    ref = _stream(lambda s: ref_send(JW, s))
    got = _stream(lambda s: port_send(PW, s))
    assert got == ref and len(ref) > 4


# ---------------------------------------------------------------------------
# both directions decode


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_arrays_cross_both_ways(name, ref_bf16):
    a = ARRAYS[name]
    # reference -> port: a CPU tensor of the same bytes (bf16 typed)
    got = _across(lambda s: JW.send_array(s, a), PW.recv_array)
    # port -> port
    back = _across(lambda s: PW.send_array(s, _tensor(a)), PW.recv_array)
    if a is None:
        assert got is None and back is None
        return
    want = _tensor(a)
    for t in (got, back):
        assert isinstance(t, torch.Tensor) and t.dtype == want.dtype
        assert t.shape == want.shape and _bits(t) == _bits(a)
    if name == "bf16":
        # the reference's receiver gives the bytes back untyped
        ref = _across(lambda s: PW.send_array(s, want), JW.recv_array)
        assert ref.dtype == np.dtype("V2") and ref.tobytes() == a.tobytes()
        return
    # port -> reference
    ref = _across(lambda s: PW.send_array(s, want), JW.recv_array)
    assert ref.dtype == a.dtype and ref.tobytes() == a.tobytes()


@pytest.mark.parametrize("name", sorted(HANDOFFS))
def test_handoffs_cross_both_ways(name, ref_bf16):
    jh, ph = HANDOFFS[name]
    got = _across(lambda s: JW.send_handoff(s, jh), PW.recv_handoff)
    assert isinstance(got, KVHandoff)
    back = _across(lambda s: PW.send_handoff(s, ph), JW.recv_handoff)
    assert isinstance(back, JKVHandoff)
    fields = ("rid", "trace_id", "prompt", "output", "next_token", "length",
              "pages", "quantized", "logprobs", "cached_tokens", "timeline")
    for h in (got, back):
        assert [getattr(h, f) for f in fields] == \
            [getattr(jh, f) for f in fields]
        assert h.nbytes == jh.nbytes
        for part in ("k", "v", "ks", "vs"):
            a, b = getattr(h, part), getattr(jh, part)
            assert (a is None) == (b is None)
            if a is not None:
                assert _bits(a) == _bits(b)
    for part in ("k", "v"):
        assert getattr(got, part).dtype == getattr(ph, part).dtype


# ---------------------------------------------------------------------------
# oversize frames


def _nothing_sent(sock):
    sock.setblocking(False)
    with pytest.raises(BlockingIOError):
        sock.recv(1)


@pytest.mark.parametrize("W", [JW, PW], ids=["reference", "port"])
def test_oversize_frames_refused_at_both_ends(W, monkeypatch):
    a, b = socket.socketpair()
    with a, b:
        b.settimeout(WAIT_S)
        with pytest.raises(W.WireError):
            W.send_json(a, {"x": "y" * (W.MAX_JSON_FRAME + 8)})
        monkeypatch.setattr(W, "MAX_BULK_FRAME", 1 << 10)
        with pytest.raises(W.WireError):
            W.send_bytes(a, bytes(2 << 10))
        big = np.zeros(1 << 10, np.int16)
        with pytest.raises(W.WireError):
            W.send_array(a, big if W is JW else torch.from_numpy(big))
        # the sender refused before its first byte (the array's header
        # frame went out: the refusal is the body's)
        head = W.recv_json(b)
        assert head == {"dtype": "<i2", "shape": [1 << 10]}
        _nothing_sent(b)
        # a corrupt length prefix fails at the header, before the body
        # is allocated
        a.sendall(b"\xff\xff\xff\xff")
        b.settimeout(WAIT_S)
        with pytest.raises(W.WireError):
            W.recv_json(b)
        a.sendall((1 << 40).to_bytes(8, "little"))
        with pytest.raises(W.WireError):
            W.recv_bytes(b)


def test_ring_points_are_the_reference():
    keys = [f"fr{i}|{j}" for i in range(4) for j in range(64)]
    pts = [PFL._ring_point(k) for k in keys]
    assert pts == [JFL._ring_point(k) for k in keys]
    assert len(set(pts)) == 256
    assert all(-(1 << 63) <= p < (1 << 63) for p in pts)


# ---------------------------------------------------------------------------
# the store and rpc across the packages


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("master", [PRPC, JRPC], ids=["port", "reference"])
def test_store_serves_the_other_package(master):
    client_mod = JRPC if master is PRPC else PRPC
    port = _free_port()
    srv = master._TCPStore("127.0.0.1", port, True, timeout=WAIT_S)
    try:
        cl = client_mod._TCPStore("127.0.0.1", port, False, timeout=WAIT_S)
        cl.set("k", {"v": [1, 2]})
        assert cl.get("k") == {"v": [1, 2]}
        assert srv.get("k") == {"v": [1, 2]}
        assert cl.add("n", 3) == 3 and srv.add("n", 4) == 7
        assert cl.get("n") == 7
        with pytest.raises(TimeoutError):
            cl.get("never", timeout=0.5)
    finally:
        srv.stop()


def test_agents_of_both_packages_call_each_other():
    port = _free_port()
    store = PRPC._TCPStore("127.0.0.1", port, True, timeout=WAIT_S)
    agents, errors = {}, []

    def up(name, mod, rank):
        try:
            st = store if rank == 0 else mod._TCPStore(
                "127.0.0.1", port, False, timeout=WAIT_S)
            agents[name] = mod.RpcAgent(name, rank, 2, st)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=up, args=a) for a in
               (("port", PRPC, 0), ("jax", JRPC, 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    try:
        assert not errors, errors
        for caller, callee in (("port", "jax"), ("jax", "port")):
            ag = agents[caller]
            # sync: one call waited on at once
            assert ag.invoke(callee, operator.add, (2, 3), {},
                             WAIT_S).wait(WAIT_S) == 5
            # async: several in flight, waited on after
            futs = [ag.invoke(callee, operator.mul, (i, 7), {}, WAIT_S)
                    for i in range(4)]
            assert [f.wait(WAIT_S) for f in futs] == [0, 7, 14, 21]
            with pytest.raises(ZeroDivisionError):
                ag.invoke(callee, operator.truediv, (1, 0), {},
                          WAIT_S).wait(WAIT_S)
        assert [i.name for i in agents["port"].all_worker_infos()] == \
            ["port", "jax"]
    finally:
        for ag in agents.values():
            ag.stop()
        store.stop()


@pytest.mark.parametrize("value, explicit, want", [
    (None, PRPC._DEFAULT_RPC_TIMEOUT, -1), ("2.5", PRPC._DEFAULT_RPC_TIMEOUT,
                                            2.5),
    (" ", PRPC._DEFAULT_RPC_TIMEOUT, -1), ("2.5", 7, 7), ("bad", -1, None)])
def test_rpc_timeout_resolves_as_the_reference(monkeypatch, value, explicit,
                                               want):
    if value is None:
        monkeypatch.delenv("PT_RPC_TIMEOUT_S", raising=False)
    else:
        monkeypatch.setenv("PT_RPC_TIMEOUT_S", value)
    for mod in (JRPC, PRPC):
        if want is None:
            with pytest.raises(ValueError, match="PT_RPC_TIMEOUT_S"):
                mod._resolve_default_timeout(explicit)
        else:
            assert mod._resolve_default_timeout(explicit) == want
