"""Paged attention for single-token decode and for verify chunks, and
int8 KV-cache quantization (counterpart of
`paddle_tpu/ops/paged_attention.py`).

KV lives in a page pool (KVH, num_pages, page_size, D); each sequence
owns a row of `page_table` and a length. In decode, one query token per
sequence attends, GQA, over its first `lengths[b]` cached columns; in a
verify chunk (speculative decoding, chunked prefill), G query tokens per
sequence attend, token g over its first `base_lengths[b] + g + 1`.

  * `quantize_kv` / `dequantize_kv`: one fp32 scale per stored (head,
    token) vector, absmax/127 floored at 1e-8, values rounded half to
    even and clipped to +-127;
  * `paged_attention_reference`: the JAX package's reference (gather
    the pages dense, masked softmax). A length-0 row has every score
    masked and gets the mean of the gathered V;
  * `paged_decode_reference`: the plain version of the TPU kernels
    `_decode_kernel` / `_quant_kernel`, with the kernel's semantics: a
    length-0 row gets zeros (the kernel skips every page and divides by
    l_safe = 1). Engines discard such rows (free slots), so no token
    depends on the difference;
  * the Hopper kernel of `csrc/paged_attention.cu` (`pa_decode`), for
    CUDA tensors, reached through `paged_attention`;
  * `paged_verify_reference`: the JAX package's verify reference, and
    the plain version of the TPU kernels `_verify_kernel` /
    `_verify_quant_kernel` as well (every row sees at least column 0,
    so there is no all-masked row where the two could differ);
  * the Hopper kernel `pa_verify` of the same source, for CUDA tensors,
    reached through `paged_verify_attention`.

Both wrappers dispatch on q's device: the plain version for a CPU
tensor, the kernel for a CUDA tensor, an error for anything else; there
is no fallback. `launches_decode` / `launches_verify` count launches
over fp32/bf16 pools, `launches_decode_int8` / `launches_verify_int8`
over int8 pools (only kernel launches).
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["quantize_kv", "dequantize_kv", "paged_attention_reference",
           "paged_decode_reference", "paged_attention",
           "paged_verify_reference", "paged_verify_attention",
           "launches_decode", "launches_decode_int8", "launches_verify",
           "launches_verify_int8"]

NEG_INF = -1e30

#: kernel launches since import (reset by callers that count a run)
launches_decode = 0
launches_decode_int8 = 0
launches_verify = 0
launches_verify_int8 = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use


def quantize_kv(x, dim=-1):
    """x: (..., D) -> (int8 values, fp32 scale with D kept as 1)."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=dim, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale):
    return q.to(torch.float32) * scale


def _gather_pages(k_pages, v_pages, page_table, k_scale, v_scale):
    """(B, KVH, pages_per_seq * page, D) contiguous views of each
    sequence's pages, dequantized to fp32 when the pages are int8."""
    b = page_table.shape[0]
    kvh, _, _, d = k_pages.shape
    pt = page_table.long()
    k = k_pages[:, pt].transpose(0, 1).reshape(b, kvh, -1, d)
    v = v_pages[:, pt].transpose(0, 1).reshape(b, kvh, -1, d)
    if k_scale is not None:
        ks = k_scale[:, pt].transpose(0, 1).reshape(b, kvh, -1, 1)
        vs = v_scale[:, pt].transpose(0, 1).reshape(b, kvh, -1, 1)
        k = dequantize_kv(k, ks)
        v = dequantize_kv(v, vs)
    return k, v


def _scores(q, k_pages, v_pages, page_table, lengths, sm_scale, k_scale,
            v_scale):
    b, qh, d = q.shape
    kvh = k_pages.shape[0]
    scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    k, v = _gather_pages(k_pages, v_pages, page_table, k_scale, v_scale)
    qg = q.reshape(b, kvh, qh // kvh, d).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) * scale
    cols = torch.arange(s.shape[-1], device=q.device)
    mask = cols[None, None, None] < lengths.long()[:, None, None, None]
    return torch.where(mask, s, NEG_INF), mask, v.float()


def paged_attention_reference(q, k_pages, v_pages, page_table, lengths,
                              sm_scale=None, k_scale=None, v_scale=None):
    """The JAX package's reference. q: (B, QH, D); pages: (KVH, P, page,
    D); page_table: (B, pages_per_seq); lengths: (B,). int8 pages come
    with k_scale/v_scale (KVH, P, page, 1) fp32. Returns (B, QH, D) in
    q's dtype."""
    s, _, v = _scores(q, k_pages, v_pages, page_table, lengths, sm_scale,
                      k_scale, v_scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v)
    return o.reshape(q.shape).to(q.dtype)


def paged_decode_reference(q, k_pages, v_pages, page_table, lengths,
                           sm_scale=None, k_scale=None, v_scale=None):
    """Plain version of the decode kernels, same arguments as
    `paged_attention_reference`: softmax over the columns < lengths[b]
    in fp32, and zeros for a length-0 row. Returns (B, QH, D) in q's
    dtype."""
    s, mask, v = _scores(q, k_pages, v_pages, page_table, lengths, sm_scale,
                         k_scale, v_scale)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v) / l
    return o.reshape(q.shape).to(q.dtype)


def paged_verify_reference(q, k_pages, v_pages, page_table, base_lengths,
                           sm_scale=None, k_scale=None, v_scale=None):
    """The JAX package's verify reference, and the plain version of the
    verify kernels. q: (B, QH, G, D); pages and page_table as in
    `paged_attention_reference`; base_lengths: (B,) the cache length
    BEFORE the chunk: token g sits at position base + g and sees the
    columns < base + g + 1 (its own included). Returns (B, QH, G, D) in
    q's dtype."""
    b, qh, g, d = q.shape
    kvh = k_pages.shape[0]
    scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    k, v = _gather_pages(k_pages, v_pages, page_table, k_scale, v_scale)
    qg = q.reshape(b, kvh, qh // kvh, g, d).float()
    s = torch.einsum("bhxgd,bhkd->bhxgk", qg, k.float()) * scale
    cols = torch.arange(s.shape[-1], device=q.device)
    limit = (base_lengths.long()[:, None] +
             torch.arange(g, device=q.device)[None, :] + 1)    # (B, G)
    s = torch.where(cols < limit[:, None, None, :, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhxgk,bhkd->bhxgd", p, v.float())
    return o.reshape(q.shape).to(q.dtype)


# ---------------------------------------------------------------- kernel
def _check(cond, msg):
    if not cond:
        raise ValueError(f"paged_attention: {msg}")


_LIB = []


def _lib():
    """The kernel library, built at first use, with its C signatures."""
    if not _LIB:
        from ..kernels import _build
        lib = _build.load("paged_attention")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pa_smem_bytes.argtypes = [ci, ci]
        lib.pa_smem_bytes.restype = ctypes.c_size_t
        lib.pa_verify_smem_bytes.argtypes = [ci, ci, ci]
        lib.pa_verify_smem_bytes.restype = ctypes.c_size_t
        lib.pa_error_string.argtypes = [ci]
        lib.pa_error_string.restype = ctypes.c_char_p
        # pointers and the stream as c_void_p: a bare Python int would
        # be passed as a 32-bit int and cut
        lib.pa_decode.argtypes = [vp] * 8 + [ci] * 6 + [ctypes.c_float,
                                                        ci, ci, ci, vp]
        lib.pa_decode.restype = ci
        lib.pa_verify.argtypes = [vp] * 8 + [ci] * 7 + [ctypes.c_float,
                                                        ci, ci, ci, vp]
        lib.pa_verify.restype = ci
        _LIB.append(lib)
    return _LIB[0]


def _check_operands(q, k_pages, v_pages, page_table, lengths, k_scale,
                    v_scale, q_layout):
    """What both kernels take: q float32/bfloat16 with the dimensions
    named in `q_layout` ((B, QH, D) or (B, QH, G, D)); pages (KVH, P,
    page, D) of q's dtype or int8 with fp32 scales; int32 page_table
    (B, pages_per_seq) and lengths (B,); contiguous operands on q's
    device; D a multiple of 16 up to 256. Returns whether the pages are
    int8."""
    _check(q.dim() == len(q_layout),
           f"q must be ({', '.join(q_layout)}), got {tuple(q.shape)}")
    b, qh, d = q.shape[0], q.shape[1], q.shape[-1]
    _check(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
           f"k_pages {tuple(k_pages.shape)} and v_pages "
           f"{tuple(v_pages.shape)} must be equal (KVH, P, page, D)")
    kvh, num_pages, page_size, d_k = k_pages.shape
    _check(d_k == d, f"head_dim of q ({d}) and pages ({d_k}) differ")
    _check(16 <= d <= 256 and d % 16 == 0,
           f"head_dim {d} not a multiple of 16 in 16..256")
    _check(kvh >= 1 and qh % kvh == 0,
           f"q heads ({qh}) not a multiple of KV heads ({kvh})")
    _check(kvh <= 65535, f"{kvh} KV heads, more than 65535")
    _check(q.dtype in (torch.float32, torch.bfloat16),
           f"q dtype {q.dtype} not float32/bfloat16")
    quant = k_pages.dtype == torch.int8
    _check(k_pages.dtype == v_pages.dtype and
           (quant or k_pages.dtype == q.dtype),
           f"pages dtype {k_pages.dtype}/{v_pages.dtype} must equal q's "
           f"({q.dtype}) or be int8")
    _check(quant == (k_scale is not None),
           "int8 pages need k_scale/v_scale, other pages take none")
    if quant:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(s.dtype == torch.float32 and
                   tuple(s.shape) == (kvh, num_pages, page_size, 1),
                   f"{name} must be float32 {(kvh, num_pages, page_size, 1)}")
    _check(page_table.dim() == 2 and page_table.shape[0] == b,
           f"page_table must be ({b}, pages_per_seq)")
    _check(tuple(lengths.shape) == (b,), f"lengths must be ({b},)")
    for name, a in (("page_table", page_table), ("lengths", lengths)):
        _check(a.dtype == torch.int32, f"{name} must be int32, got {a.dtype}")
    operands = [q, k_pages, v_pages, page_table, lengths]
    if quant:
        operands += [k_scale, v_scale]
    for a in operands:
        _check(a.device == q.device, f"operand on {a.device}, q on {q.device}")
        _check(a.is_contiguous(), "every operand must be contiguous")
    for name, a in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check(a.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    return quant


def _run(lib, fn, q, k_pages, v_pages, page_table, lengths, out, k_scale,
         v_scale, shape_args, scale):
    """Launch `fn` of the library on q's current stream; raise on a
    refused launch."""
    quant = k_scale is not None
    kvh, num_pages, page_size, _ = k_pages.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scale.data_ptr() if quant else None,
                v_scale.data_ptr() if quant else None,
                page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                *shape_args, num_pages, page_size, scale,
                page_table.shape[1], _DTYPE_CODE[q.dtype],
                _DTYPE_CODE[k_pages.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            "paged_attention: kernel launch failed: "
            f"{lib.pa_error_string(rc).decode()} (cuda error {rc})")


def _launch(q, k_pages, v_pages, page_table, lengths, scale, k_scale,
            v_scale):
    global launches_decode, launches_decode_int8
    quant = _check_operands(q, k_pages, v_pages, page_table, lengths,
                            k_scale, v_scale, ("B", "QH", "D"))
    b, qh, d = q.shape
    kvh = k_pages.shape[0]
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _lib()
    smem = lib.pa_smem_bytes(qh // kvh, d)
    _check(smem <= _MAX_SMEM,
           f"GQA group {qh // kvh} x head_dim {d} needs {smem} bytes of "
           f"shared memory, more than a block has ({_MAX_SMEM})")
    _run(lib, lib.pa_decode, q, k_pages, v_pages, page_table, lengths, out,
         k_scale, v_scale, (b, qh, kvh, d), scale)
    if quant:
        launches_decode_int8 += 1
    else:
        launches_decode += 1
    return out


def _launch_verify(q, k_pages, v_pages, page_table, base_lengths, scale,
                   k_scale, v_scale):
    global launches_verify, launches_verify_int8
    quant = _check_operands(q, k_pages, v_pages, page_table, base_lengths,
                            k_scale, v_scale, ("B", "QH", "G", "D"))
    b, qh, g, d = q.shape
    kvh = k_pages.shape[0]
    _check(g >= 1, "a verify chunk needs G >= 1 tokens")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _lib()
    smem = lib.pa_verify_smem_bytes(qh // kvh, g, d)
    _check(smem <= _MAX_SMEM,
           f"head_dim {d} needs {smem} bytes of shared memory, more than "
           f"a block has ({_MAX_SMEM})")
    _run(lib, lib.pa_verify, q, k_pages, v_pages, page_table, base_lengths,
         out, k_scale, v_scale, (b, qh, kvh, g, d), scale)
    if quant:
        launches_verify_int8 += 1
    else:
        launches_verify += 1
    return out


def _dispatch(name, q, k_scale, v_scale):
    """Where a call goes: "cpu" or "cuda"; raises for any other device
    or for scales that do not come together."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"{name}: no implementation for device {q.device}; "
            "use a CUDA or a CPU tensor")
    return q.device.type


def paged_attention(q, k_pages, v_pages, page_table, lengths, sm_scale=None,
                    k_scale=None, v_scale=None):
    """Single-token decode attention over a paged KV cache.

    q: (B, QH, D); k_pages/v_pages: (KVH, num_pages, page_size, D);
    page_table: (B, pages_per_seq); lengths: (B,), the columns each row
    sees. int8 pages: pass k_scale/v_scale (KVH, num_pages, page_size,
    1) fp32; they are dequantized inside the kernel, so int8 is what
    crosses device memory. Returns (B, QH, D) in q's dtype; a length-0
    row gets zeros.

    A CPU q runs the plain version. A CUDA q launches the Hopper kernel,
    which takes float32 or bfloat16 q with pages of the same dtype or
    int8, int32 page_table and lengths, contiguous operands and a
    head_dim that is a multiple of 16 up to 256, and raises on anything
    else."""
    where = _dispatch("paged_attention", q, k_scale, v_scale)
    scale = float(sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)
    if where == "cpu":
        return paged_decode_reference(q, k_pages, v_pages, page_table,
                                      lengths, scale, k_scale, v_scale)
    return _launch(q, k_pages, v_pages, page_table, lengths, scale, k_scale,
                   v_scale)


def paged_verify_attention(q, k_pages, v_pages, page_table, base_lengths,
                           sm_scale=None, k_scale=None, v_scale=None):
    """Verify-chunk attention over a paged KV cache.

    q: (B, QH, G, D); pages and page_table as in `paged_attention`;
    base_lengths: (B,) >= 0, the cache length BEFORE the chunk: token g
    of the chunk sits at position base + g and attends the columns
    < base + g + 1, its own included (the chunk's K/V must already be
    in the pages). int8 pages take k_scale/v_scale as in
    `paged_attention`. Returns (B, QH, G, D) in q's dtype.

    A CPU q runs the plain version. A CUDA q launches the Hopper kernel,
    which reads each slot's pages once for all the group x G rows of a
    KV head and takes what `paged_attention`'s kernel takes."""
    where = _dispatch("paged_verify_attention", q, k_scale, v_scale)
    scale = float(sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)
    if where == "cpu":
        return paged_verify_reference(q, k_pages, v_pages, page_table,
                                      base_lengths, scale, k_scale, v_scale)
    return _launch_verify(q, k_pages, v_pages, page_table, base_lengths,
                          scale, k_scale, v_scale)
