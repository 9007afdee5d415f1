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
tensor, a kernel for a CUDA tensor, an error for anything else; there
is no fallback. On the card `route` decides the kernel before launch,
as the ragged kernel's does: bf16 q over bf16 or int8 pages with
head_dim % 8 == 0, head_dim <= 128 and a GQA group up to 64 runs the
tensor-core kernel (`paged_tc_kernel`), everything else (fp32 q,
head_dim 256) the CUDA-core one. The tensor-core kernel splits each
sequence's columns over blocks by a rule on shapes alone
(`split_rule`; `paged_split_plan` is its plain twin) and merges the
splits' softmax states in a second kernel (`pa_merge`);
`paged_split_merge_reference` is the plain version of that arithmetic.
`launches_decode` / `launches_verify` count attention launches over
fp32/bf16 pools, `launches_decode_int8` / `launches_verify_int8` over
int8 pools, `launches_merge` the merge launches (only kernel launches).
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels.ragged_paged_attention import (CUDA_CORES, TENSOR_CORES,
                                              TILE, route)

__all__ = ["quantize_kv", "dequantize_kv", "paged_attention_reference",
           "paged_decode_reference", "paged_attention",
           "paged_verify_reference", "paged_verify_attention", "route",
           "split_rule", "paged_split_plan", "paged_split_merge_reference",
           "launches_decode", "launches_decode_int8", "launches_verify",
           "launches_verify_int8", "launches_merge"]

NEG_INF = -1e30
#: columns of one split where the rule splits (a multiple of TILE): 384
#: beat 128, 256, 512-1024 and no split at chip_smoke.py's 8B decode and
#: verify batches on an H100 (PERF.md, PR 13)
SPLIT_COLS = 384
#: most bytes of fp32 partials (O, m, l) a split launch writes for the
#: merge, whatever the cache's length: their round trip costs at most
#: about 10 us at an H100's 3.35 TB/s
MAX_SPLIT_WORKSPACE = 16 << 20

#: kernel launches since import (reset by callers that count a run)
launches_decode = 0
launches_decode_int8 = 0
launches_verify = 0
launches_verify_int8 = 0
launches_merge = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use


def quantize_kv(x, dim=-1):
    """x: (..., D) -> (int8 values, fp32 scale with D kept as 1)."""
    xf = x.to(torch.float32)
    # a true division on every device: a CUDA tensor divided by a Python
    # (or CPU 0-d) scalar is multiplied by the scalar's reciprocal, which
    # rounds another last bit than the reference's absmax / 127
    # for about 4% of values; a 0-d divisor on x's own device is not
    d127 = torch.full((), 127.0, dtype=torch.float32, device=xf.device)
    scale = torch.amax(torch.abs(xf), dim=dim, keepdim=True) / d127
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


# ------------------------------------------------- the split of the columns
def row_tiles(group, n_tok):
    """Row tiles of a (sequence, KV head) on the tensor-core route: a tile
    holds up to TILE // group tokens x the group's query heads."""
    return -(-n_tok // (TILE // group))


def split_rule(batch, kvh, group, n_tok, cap, head_dim, n_sm,
               split_cols=None):
    """(S, n_splits) of a tensor-core launch, from shapes alone. No split
    (one S of ceil(cap / 64) k tiles) when batch x kvh x row tiles blocks
    fill twice the card's `n_sm` SMs, when the cache fits in one split,
    or when two splits' partials (batch x kvh x group x n_tok rows of
    head_dim + 2 floats each) would pass MAX_SPLIT_WORKSPACE; else splits
    of `split_cols` columns (SPLIT_COLS by default, a multiple of 64),
    widened by 64s where ceil(cap / S) of them would pass it. cap is
    pages_per_seq x page_size. Timed on an H100 by
    `tools/paged_split_sweep.py` (PERF.md, PR 13): at 8 slots of KVH 8
    the split halves the kernel's time for decode and G <= 16 chunks,
    and G = 64 chunks, which the budget keeps whole, run 2-17% faster
    so; at 33 and 40 decode slots, past the no-split threshold, a split
    would be 13-16% faster over int8 pages and within 2% over bf16."""
    split_cols = split_cols or SPLIT_COLS
    blocks = batch * kvh * row_tiles(group, n_tok)
    most = MAX_SPLIT_WORKSPACE // (batch * kvh * group * n_tok *
                                   (head_dim + 2) * 4)
    if blocks >= 2 * n_sm or cap <= split_cols or most < 2:
        return -(-cap // TILE) * TILE, 1
    split_cols = max(split_cols, -(-cap // (TILE * most)) * TILE)
    return split_cols, -(-cap // split_cols)


def paged_split_plan(lims, group, n_tok, kvh, split_cols, n_sm, cap,
                     head_dim):
    """The tensor-core kernel's work, in plain Python: the twin of the
    blocks of `paged_tc_kernel`. lims[b] is the limit of sequence b's
    first token (its length in decode, base + 1 in verify); token g sees
    the columns < min(lims[b] + g, cap). Returns a dict: `split_cols`,
    `max_splits` and `row_tiles` of the grid (`split_rule`), `blocks` in
    the grid, `tiles[b][rt] = (lim, [(kt0, kt1), ...])` (the row tile's
    largest limit and the k tiles of each split that computes; none for
    lim 0), and per KV head the `k_tiles` and `splits` computed."""
    lims = [int(x) for x in lims]
    s, ns = split_rule(len(lims), kvh, group, n_tok, cap, head_dim, n_sm,
                       split_cols)
    per_tile, rt = TILE // group, row_tiles(group, n_tok)
    skt = s // TILE
    tiles, k_tiles, splits = [], 0, 0
    for first in lims:
        row = []
        for g0 in range(0, n_tok, per_tile):
            lim = max(0, min(first + min(g0 + per_tile, n_tok) - 1, cap))
            kt_end = -(-lim // TILE)
            parts = [(kt0, min(kt0 + skt, kt_end))
                     for kt0 in range(0, kt_end, skt)]
            row.append((lim, parts))
            k_tiles += kt_end
            splits += len(parts)
        tiles.append(row)
    return {"split_cols": s, "max_splits": ns, "row_tiles": rt,
            "blocks": len(lims) * kvh * rt * ns, "tiles": tiles,
            "k_tiles": k_tiles, "splits": splits}


def paged_split_merge_reference(q, k_pages, v_pages, page_table,
                                base_lengths, split_cols, sm_scale=None,
                                k_scale=None, v_scale=None):
    """The split kernel's arithmetic in plain PyTorch: for each split of
    `split_cols` columns a partial softmax state (O, m, l) over the
    columns it holds, then the merge O = sum_s e^(m_s - M) O_s /
    sum_s e^(m_s - M) l_s. q: (B, QH, G, D); base_lengths: (B,), token g
    sees the columns < base + g + 1 (a decode row is G = 1 at length - 1;
    a length-0 row, base -1, gets exactly 0). Pages as in
    `paged_verify_reference`. Returns (B, QH, G, D) in q's dtype."""
    b, qh, g, d = q.shape
    kvh = k_pages.shape[0]
    scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    k, v = _gather_pages(k_pages, v_pages, page_table, k_scale, v_scale)
    cols = k.shape[2]
    ns = -(-cols // split_cols)
    pad = ns * split_cols - cols
    k = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    v = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    qg = q.reshape(b, kvh, qh // kvh, g, d).float()
    s = torch.einsum("bhxgd,bhkd->bhxgk", qg, k) * scale
    limit = (base_lengths.long()[:, None] +
             torch.arange(g, device=q.device)[None, :] + 1)    # (B, G)
    keep = (torch.arange(ns * split_cols, device=q.device)
            < limit[:, None, None, :, None])
    shape = s.shape[:-1] + (ns, split_cols)
    s, keep = s.reshape(shape), keep.expand(s.shape).reshape(shape)
    m = torch.where(keep, s, -torch.inf).amax(-1)            # (..., ns)
    m_safe = torch.where(torch.isinf(m), 0.0, m)
    p = torch.where(keep, torch.exp(s - m_safe[..., None]), 0.0)
    l = p.sum(-1)
    o = torch.einsum("bhxgnk,bhnkd->bhxgnd", p,
                     v.reshape(b, kvh, ns, split_cols, d))
    mx = m.amax(-1, keepdim=True)
    w = torch.where(torch.isinf(m), 0.0,
                    torch.exp(m - torch.where(torch.isinf(mx), 0.0, mx)))
    num = (w[..., None] * o).sum(-2)
    den = (w * l).sum(-1, keepdim=True)
    out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return out.reshape(q.shape).to(q.dtype)


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
        lib.pa_tc_smem_bytes.argtypes = [ci, ci, ci]
        lib.pa_tc_smem_bytes.restype = ctypes.c_size_t
        lib.pa_tc_launch.argtypes = [vp] * 11 + [ci] * 11 + [
            ctypes.c_float, ci, vp]
        lib.pa_tc_launch.restype = ci
        lib.pa_merge.argtypes = [vp] * 4 + [ci] * 10 + [vp]
        lib.pa_merge.restype = ci
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


def _raise_rc(lib, rc):
    if rc != 0:
        raise RuntimeError(
            "paged_attention: kernel launch failed: "
            f"{lib.pa_error_string(rc).decode()} (cuda error {rc})")


def _run(lib, fn, q, k_pages, v_pages, page_table, lengths, out, k_scale,
         v_scale, shape_args, scale):
    """Launch the CUDA-core kernel `fn` of the library on q's current
    stream; raise on a refused launch."""
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
    _raise_rc(lib, rc)


_SM_COUNT = {}


def _sm_count(device):
    """The card's SM count, read once a device."""
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _SM_COUNT:
        props = torch.cuda.get_device_properties(i)
        _SM_COUNT[i] = props.multi_processor_count
    return _SM_COUNT[i]


def _launch_tc(lib, q, k_pages, v_pages, page_table, lengths, out, k_scale,
               v_scale, scale, n_tok, base_off, count_tiles):
    """The tensor-core kernel on q / out, (B, QH, D) for decode (n_tok
    1, base_off -1: `lengths` are lengths) or (B, QH, G, D) for verify
    (base_off 0: base lengths), bf16; then the merge where `split_rule`
    splits. Returns None, or with `count_tiles` the k tiles and working
    blocks the kernel counted (one device sync), the split and the
    workspace's bytes."""
    global launches_merge
    b, qh, d = q.shape[0], q.shape[1], q.shape[-1]
    kvh, num_pages, page_size, _ = k_pages.shape
    pps = page_table.shape[1]
    smem = lib.pa_tc_smem_bytes(d, _DTYPE_CODE[k_pages.dtype], pps)
    _check(smem <= _MAX_SMEM,
           f"pages_per_seq {pps} needs {smem} bytes of shared memory, more "
           f"than a block has ({_MAX_SMEM})")
    if q.data_ptr() % 16:
        q = q.clone()    # the kernel reads q's rows 16-byte aligned
    dev = q.device
    split_cols, n_splits = split_rule(b, kvh, qh // kvh, n_tok,
                                      pps * page_size, d, _sm_count(dev))
    ws_o = ws_ml = None
    ws_bytes = 0
    if n_splits > 1:
        # one buffer: O (rows x D fp32), then (m, l) per row
        rows = b * qh * n_tok * n_splits
        ws = torch.empty(rows * (d + 2), dtype=torch.float32, device=dev)
        ws_bytes = ws.numel() * 4
        ws_o = ws.data_ptr()
        ws_ml = ws_o + rows * d * 4
    count = (torch.zeros(2, dtype=torch.int32, device=dev)
             if count_tiles else None)
    quant = k_scale is not None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pa_tc_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), ws_o, ws_ml,
            count.data_ptr() if count_tiles else None, b, qh, kvh, n_tok,
            d, num_pages, page_size, pps, base_off, split_cols, n_splits,
            scale, _DTYPE_CODE[k_pages.dtype], stream)
        _raise_rc(lib, rc)
        if n_splits > 1:
            rc = lib.pa_merge(lengths.data_ptr(), ws_o, ws_ml,
                              out.data_ptr(), b, qh, kvh, n_tok, d,
                              page_size, pps, base_off, split_cols,
                              n_splits, stream)
            _raise_rc(lib, rc)
            launches_merge += 1
    if not count_tiles:
        return None
    k_tiles, blocks = count.tolist()
    return {"k_tiles": k_tiles, "splits": blocks, "split_cols": split_cols,
            "max_splits": n_splits, "workspace_bytes": ws_bytes}


def _launch(q, k_pages, v_pages, page_table, lengths, scale, k_scale,
            v_scale, count_tiles=False):
    """The decode kernel of `route` on CUDA operands. Returns out, or
    with `count_tiles` (out, the tensor-core kernel's counts or None on
    the CUDA-core route)."""
    global launches_decode, launches_decode_int8
    quant = _check_operands(q, k_pages, v_pages, page_table, lengths,
                            k_scale, v_scale, ("B", "QH", "D"))
    b, qh, d = q.shape
    kvh = k_pages.shape[0]
    out = torch.empty_like(q)
    counts = None
    if b == 0:
        return (out, counts) if count_tiles else out
    lib = _lib()
    if route(q.dtype, k_pages.dtype, d, qh // kvh) == TENSOR_CORES:
        counts = _launch_tc(lib, q, k_pages, v_pages, page_table, lengths,
                            out, k_scale, v_scale, scale, 1, -1, count_tiles)
    else:
        smem = lib.pa_smem_bytes(qh // kvh, d)
        _check(smem <= _MAX_SMEM,
               f"GQA group {qh // kvh} x head_dim {d} needs {smem} bytes "
               f"of shared memory, more than a block has ({_MAX_SMEM})")
        _run(lib, lib.pa_decode, q, k_pages, v_pages, page_table, lengths,
             out, k_scale, v_scale, (b, qh, kvh, d), scale)
    if quant:
        launches_decode_int8 += 1
    else:
        launches_decode += 1
    return (out, counts) if count_tiles else out


def _launch_verify(q, k_pages, v_pages, page_table, base_lengths, scale,
                   k_scale, v_scale, count_tiles=False):
    """The verify kernel of `route` on CUDA operands; returns as
    `_launch` does."""
    global launches_verify, launches_verify_int8
    quant = _check_operands(q, k_pages, v_pages, page_table, base_lengths,
                            k_scale, v_scale, ("B", "QH", "G", "D"))
    b, qh, g, d = q.shape
    kvh = k_pages.shape[0]
    _check(g >= 1, "a verify chunk needs G >= 1 tokens")
    out = torch.empty_like(q)
    counts = None
    if b == 0:
        return (out, counts) if count_tiles else out
    lib = _lib()
    if route(q.dtype, k_pages.dtype, d, qh // kvh) == TENSOR_CORES:
        counts = _launch_tc(lib, q, k_pages, v_pages, page_table,
                            base_lengths, out, k_scale, v_scale, scale, g, 0,
                            count_tiles)
    else:
        smem = lib.pa_verify_smem_bytes(qh // kvh, g, d)
        _check(smem <= _MAX_SMEM,
               f"head_dim {d} needs {smem} bytes of shared memory, more "
               f"than a block has ({_MAX_SMEM})")
        _run(lib, lib.pa_verify, q, k_pages, v_pages, page_table,
             base_lengths, out, k_scale, v_scale, (b, qh, kvh, g, d), scale)
    if quant:
        launches_verify_int8 += 1
    else:
        launches_verify += 1
    return (out, counts) if count_tiles else out


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

    A CPU q runs the plain version. A CUDA q launches the Hopper kernel
    `route` names, which takes float32 or bfloat16 q with pages of the
    same dtype or int8, int32 page_table and lengths, contiguous operands
    and a head_dim that is a multiple of 16 up to 256, and raises on
    anything else."""
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

    A CPU q runs the plain version. A CUDA q launches the Hopper kernel
    `route` names, which reads each slot's pages once for all the rows
    of a KV head's row tile and takes what `paged_attention`'s kernel
    takes."""
    where = _dispatch("paged_verify_attention", q, k_scale, v_scale)
    scale = float(sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)
    if where == "cpu":
        return paged_verify_reference(q, k_pages, v_pages, page_table,
                                      base_lengths, scale, k_scale, v_scale)
    return _launch_verify(q, k_pages, v_pages, page_table, base_lengths,
                          scale, k_scale, v_scale)
