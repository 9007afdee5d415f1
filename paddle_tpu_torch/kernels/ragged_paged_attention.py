"""Ragged paged attention: one call for an arbitrary prefill/decode mix
(counterpart of `paddle_tpu/kernels/ragged_paged_attention.py`).

The serving step feeds a flat token buffer: row i is one token of slot
`tok_slot[i]` at cache position `tok_pos[i]`, and attends over that
slot's paged KV through `page_table`, causally limited to columns
`< tok_pos[i] + 1` (its own K/V was scattered into the pages first).
Inactive slack rows carry `tok_pos = -1` and get zeros.

Two implementations of one function:

  * `ragged_paged_attention_reference` — plain PyTorch, the online
    softmax scanned page ordinal by page ordinal, as the JAX reference
    does. The CPU tests use it, and `chip_smoke.py` holds the kernel
    against it on the card;
  * the Hopper kernels in `csrc/ragged_paged_attention.cu`, reached
    through `ragged_paged_attention` for CUDA tensors.

`ragged_paged_attention` dispatches on q's device: the plain version
for a CPU tensor, a kernel for a CUDA tensor, an error for anything
else. On the card `route` decides the kernel before launch: bf16 q over
bf16 or int8 pages with head_dim % 8 == 0, head_dim <= 128 and a GQA
group up to 64 runs the tensor-core kernel, which reads a work plan of
the buffer (`ragged_plan`, one small kernel; `ragged_tile_plan` is its
plain twin); everything else (fp32 q, head_dim 256) the CUDA-core one.
There is no fallback: a kernel that does not build or does not launch
raises. `launches` counts attention launches and `plan_launches` plan
launches (only those).

The JAX package asserts its kernel and reference bit-identical, which
holds only inside XLA; here the two agree to the tolerances the tests
and `chip_smoke.py` state (sums are taken in another order).
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["ragged_paged_attention", "ragged_paged_attention_reference",
           "ragged_plan", "ragged_tile_plan", "route", "step_plan",
           "launches", "plan_launches"]

NEG_INF = -1e30
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"
TILE = 64  # rows of the M tile and columns of a k tile

#: attention kernel launches since import (reset by callers that count a
#: run), and launches of the plan kernel
launches = 0
plan_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use


def ragged_paged_attention_reference(q, k_pages, v_pages, page_table,
                                     tok_slot, tok_pos, sm_scale=None,
                                     k_scale=None, v_scale=None):
    """q: (T, QH, D); pages: (KVH, P, page, D); page_table:
    (S, pages_per_seq); tok_slot/tok_pos: (T,) integers (pos -1 =
    inactive row -> zeros). int8 pages come with k_scale/v_scale
    (KVH, P, page, 1) fp32. Returns (T, QH, D) in q's dtype; all
    arithmetic in fp32."""
    t, qh, d = q.shape
    kvh, _, page_size, _ = k_pages.shape
    group = qh // kvh
    scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    n_pages = page_table.shape[1]
    quant = k_scale is not None

    pages = page_table.long()[tok_slot.long()]            # (T, n_pages)
    limit = tok_pos.long() + 1                            # (T,)
    qg = q.reshape(t, kvh, group, d).to(torch.float32)
    acc = torch.zeros((t, kvh, group, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((t, kvh, group, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    cols = torch.arange(page_size, device=q.device)
    # pages wholly past every row's limit leave the state untouched:
    # the loop stops at the last page a row reaches
    live = min(n_pages, -(-int(limit.max()) // page_size)) if t else 0
    for pi in range(live):
        pg = pages[:, pi]
        k = k_pages[:, pg].to(torch.float32)              # (KVH, T, page, D)
        v = v_pages[:, pg].to(torch.float32)
        if quant:
            k = k * k_scale[:, pg]
            v = v * v_scale[:, pg]
        k = k.transpose(0, 1)                             # (T, KVH, page, D)
        v = v.transpose(0, 1)
        s = torch.einsum("thgd,thjd->thgj", qg, k) * scale
        visible = (pi * page_size + cols)[None, :] < limit[:, None]
        s = torch.where(visible[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_new = alpha * l + p.sum(-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum("thgj,thjd->thgd", p, v)
        # a page wholly past the row's limit leaves the state untouched
        take = (pi * page_size < limit)[:, None, None, None]
        acc = torch.where(take, acc_new, acc)
        m = torch.where(take, m_new, m)
        l = torch.where(take, l_new, l)
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).reshape(t, qh, d).to(q.dtype)


def route(q_dtype, kv_dtype, head_dim, group):
    """Which kernel a CUDA call takes: TENSOR_CORES for bf16 q over bf16
    or int8 pages, head_dim a multiple of 8 up to 128 and a GQA group up
    to 64 (its tokens x heads fill one 64-row tile); CUDA_CORES for
    everything else (fp32 q, head_dim 256)."""
    if (q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8)
            and head_dim % 8 == 0 and head_dim <= 128
            and 1 <= group <= TILE):
        return TENSOR_CORES
    return CUDA_CORES


def ragged_tile_plan(tok_slot, tok_pos, group, cap=None):
    """The tensor-core kernel's tiles of a flat buffer, in plain Python:
    the twin of `ragged_plan_kernel`, for CPU tensors. A run is a maximal
    stretch of adjacent active rows (tok_pos >= 0) of one slot; a tile is
    up to 64 // group rows of one run, counted from the run's first row.
    Returns an (n_tiles, 4) int64 tensor of (row0, n_rows, kt_end, lim) in
    row order: lim is the largest min(tok_pos + 1, cap) of the tile's
    rows, kt_end = ceil(lim / 64) the k tiles the kernel computes for the
    tile, once per KV head."""
    slot, pos = tok_slot.tolist(), tok_pos.tolist()
    per_tile = TILE // group
    big = float("inf") if cap is None else cap
    tiles, i = [], 0
    while i < len(pos):
        if pos[i] < 0:
            i += 1
            continue
        end = i
        while end < len(pos) and pos[end] >= 0 and slot[end] == slot[i]:
            end += 1
        for row0 in range(i, end, per_tile):
            rows = range(row0, min(row0 + per_tile, end))
            lim = int(max(min(pos[r] + 1, big) for r in rows))
            tiles.append((row0, len(rows), -(-lim // TILE), lim))
        i = end
    return torch.tensor(tiles, dtype=torch.int64).reshape(-1, 4)


def plan_size(t):
    """int32 entries of a plan of t rows: (n_tiles, n_inactive), t tiles
    of (row0, n_rows, kt_end, lim), t inactive rows."""
    return 2 + 5 * t


def _check(cond, msg):
    if not cond:
        raise ValueError(f"ragged_paged_attention: {msg}")


_LIB = []


def _lib():
    """The kernel library, built at first use, with its C signatures."""
    if not _LIB:
        from . import _build
        lib = _build.load("ragged_paged_attention")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rpa_smem_bytes.argtypes = [ci, ci]
        lib.rpa_smem_bytes.restype = ctypes.c_size_t
        lib.rpa_tc_smem_bytes.argtypes = [ci, ci, ci]
        lib.rpa_tc_smem_bytes.restype = ctypes.c_size_t
        lib.rpa_error_string.argtypes = [ci]
        lib.rpa_error_string.restype = ctypes.c_char_p
        # pointers and the stream as c_void_p: a bare Python int would
        # be passed as a 32-bit int and cut
        lib.rpa_launch.argtypes = [vp] * 9 + [ci] * 7 + [ctypes.c_float,
                                                         ci, ci, vp]
        lib.rpa_launch.restype = ci
        lib.rpa_plan.argtypes = [vp, vp, ci, ci, ci, vp, vp]
        lib.rpa_plan.restype = ci
        lib.rpa_tc_launch.argtypes = [vp] * 11 + [ci] * 7 + [
            ctypes.c_float, ci, vp]
        lib.rpa_tc_launch.restype = ci
        _LIB.append(lib)
    return _LIB[0]


def _raise_rc(lib, rc, what):
    if rc != 0:
        raise RuntimeError(
            f"ragged_paged_attention: {what} launch failed: "
            f"{lib.rpa_error_string(rc).decode()} (cuda error {rc})")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ragged_plan(tok_slot, tok_pos, group, cap):
    """The tensor-core kernel's work plan of a flat buffer on the card:
    one launch of `ragged_plan_kernel` (a block of prefix scans over the
    rows; no host sync). `ragged_tile_plan` is its plain twin; `cap` is
    pages_per_seq x page_size. Every layer of a step shares tok_slot and
    tok_pos, so `unified_step` builds it once (`step_plan`). Returns an
    int32 tensor of `plan_size(T)` entries."""
    global plan_launches
    t = tok_slot.shape[0]
    for name, a in (("tok_slot", tok_slot), ("tok_pos", tok_pos)):
        _check(a.device.type == "cuda",
               f"{name} must be a CUDA tensor")
        _check(a.dtype == torch.int32 and tuple(a.shape) == (t,) and
               a.is_contiguous(),
               f"{name} must be contiguous int32 ({t},)")
    _check(tok_pos.device == tok_slot.device, "tok_slot and tok_pos on "
           "different devices")
    _check(1 <= group <= TILE and cap >= 1,
           f"group {group} outside 1..{TILE} or cap {cap} < 1")
    if t == 0:
        return torch.zeros(plan_size(0), dtype=torch.int32,
                           device=tok_slot.device)
    # the kernel writes the header and every entry the header counts
    plan = torch.empty(plan_size(t), dtype=torch.int32,
                       device=tok_slot.device)
    lib = _lib()
    with torch.cuda.device(tok_slot.device):
        rc = lib.rpa_plan(tok_slot.data_ptr(), tok_pos.data_ptr(), t, group,
                          cap, plan.data_ptr(), _stream(tok_slot.device))
    _raise_rc(lib, rc, "plan kernel")
    plan_launches += 1
    return plan


def step_plan(q, k_pages, page_table, tok_slot, tok_pos):
    """The plan for calls with these operands where they take the
    tensor-core route on the card, else None (a CPU tensor, or the
    CUDA-core route, which needs none)."""
    kvh, _, page_size, d = k_pages.shape
    if (q.device.type != "cuda" or q.shape[1] % kvh != 0 or
            route(q.dtype, k_pages.dtype, d, q.shape[1] // kvh)
            != TENSOR_CORES):
        return None
    return ragged_plan(tok_slot, tok_pos, q.shape[1] // kvh,
                       page_table.shape[1] * page_size)


def _launch(q, k_pages, v_pages, page_table, tok_slot, tok_pos, scale,
            k_scale, v_scale, plan=None, count_tiles=False):
    """The kernel of `route` on CUDA operands. Returns out, or with
    `count_tiles` (out, the k tiles the tensor-core kernel computed over
    all KV heads, or None on the CUDA-core route)."""
    global launches
    t, qh, d = q.shape
    _check(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
           f"k_pages {tuple(k_pages.shape)} and v_pages "
           f"{tuple(v_pages.shape)} must be equal (KVH, P, page, D)")
    kvh, num_pages, page_size, d_k = k_pages.shape
    _check(d_k == d, f"head_dim of q ({d}) and pages ({d_k}) differ")
    _check(16 <= d <= 256, f"head_dim {d} outside 16..256")
    _check(1 <= page_size <= 64, f"page_size {page_size} outside 1..64")
    _check(kvh >= 1 and qh % kvh == 0,
           f"q heads ({qh}) not a multiple of KV heads ({kvh})")
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
    _check(page_table.dim() == 2, "page_table must be (S, pages_per_seq)")
    for name, a in (("page_table", page_table), ("tok_slot", tok_slot),
                    ("tok_pos", tok_pos)):
        _check(a.dtype == torch.int32, f"{name} must be int32, got {a.dtype}")
    _check(tuple(tok_slot.shape) == (t,) and tuple(tok_pos.shape) == (t,),
           f"tok_slot/tok_pos must be ({t},)")
    operands = [q, k_pages, v_pages, page_table, tok_slot, tok_pos]
    if quant:
        operands += [k_scale, v_scale]
    for a in operands:
        _check(a.device == q.device, f"operand on {a.device}, q on {q.device}")
        _check(a.is_contiguous(), "every operand must be contiguous")

    out = torch.empty_like(q)
    tiles = None
    if t == 0:
        return (out, tiles) if count_tiles else out
    lib = _lib()
    group = qh // kvh
    pps = page_table.shape[1]
    tc = route(q.dtype, k_pages.dtype, d, group) == TENSOR_CORES
    smem = (lib.rpa_tc_smem_bytes(d, _DTYPE_CODE[k_pages.dtype], pps) if tc
            else lib.rpa_smem_bytes(group, d))
    _check(smem <= _MAX_SMEM,
           f"GQA group {group} x head_dim {d} (pages_per_seq "
           f"{pps}) needs {smem} bytes of shared memory, more than a "
           f"block has ({_MAX_SMEM})")
    if tc:
        align = 8 if quant else 16
        for name, a, al in (("q", q, 16), ("k_pages", k_pages, align),
                            ("v_pages", v_pages, align)):
            _check(a.data_ptr() % al == 0,
                   f"{name} must start {al}-byte aligned")
        if plan is None:
            plan = ragged_plan(tok_slot, tok_pos, group, pps * page_size)
        _check(plan.dtype == torch.int32 and plan.device == q.device and
               tuple(plan.shape) == (plan_size(t),),
               f"plan must be ragged_plan's for these {t} rows")
        count = (torch.zeros(1, dtype=torch.int32, device=q.device)
                 if count_tiles else None)
    with torch.cuda.device(q.device):
        stream = _stream(q.device)
        ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scale.data_ptr() if quant else None,
                v_scale.data_ptr() if quant else None,
                page_table.data_ptr(), tok_slot.data_ptr(),
                tok_pos.data_ptr())
        if tc:
            rc = lib.rpa_tc_launch(
                *ptrs, plan.data_ptr(), out.data_ptr(),
                count.data_ptr() if count_tiles else None, t, qh, kvh, d,
                num_pages, page_size, pps, scale,
                _DTYPE_CODE[k_pages.dtype], stream)
        else:
            rc = lib.rpa_launch(
                *ptrs, out.data_ptr(), t, qh, kvh, d, num_pages, page_size,
                pps, scale, _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype],
                stream)
    _raise_rc(lib, rc, "kernel")
    launches += 1
    if count_tiles and tc:
        tiles = int(count.item())
    return (out, tiles) if count_tiles else out


def ragged_paged_attention(q, k_pages, v_pages, page_table, tok_slot,
                           tok_pos, sm_scale=None, k_scale=None,
                           v_scale=None, plan=None):
    """Ragged mixed prefill/decode attention over a paged KV cache.

    q: (T, QH, D); k_pages/v_pages: (KVH, num_pages, page_size, D);
    page_table: (S, pages_per_seq); tok_slot/tok_pos: (T,) (pos -1 =
    inactive row -> zeros). int8 pages: pass k_scale/v_scale
    (KVH, num_pages, page_size, 1) fp32. Returns (T, QH, D) in q's
    dtype.

    A CPU q runs the plain version. A CUDA q launches the kernel `route`
    names, which takes float32 or bfloat16 q with pages of the same dtype
    or int8, int32 index tensors, contiguous operands, head_dim 16..256
    and page_size up to 64, and raises on anything else. `plan`, the
    tensor-core route's `ragged_plan` for these tok_slot / tok_pos (a
    step builds it once for its layers), is built here when not given;
    the other routes ignore it."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    scale = float(sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, page_table, tok_slot, tok_pos, scale,
            k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"ragged_paged_attention: no implementation for device "
            f"{q.device}; use a CUDA or a CPU tensor")
    return _launch(q, k_pages, v_pages, page_table, tok_slot, tok_pos, scale,
                   k_scale, v_scale, plan)
