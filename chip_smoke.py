#!/usr/bin/env python3
"""Chip smoke test for paddle_tpu_torch: drive the port's serving and
training main paths on one CUDA card and hold every kernel on them
against its plain PyTorch version.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line (any failure raises and exits
non-zero):

  1. device  — the card's name and power limit (nvidia-smi), refusing
               to run without CUDA;
  2. build   — nvcc builds every kernel source of csrc/, one nvcc per
               source, all started together; each source's line lists
               every kernel with its registers and spill bytes (ptxas;
               a tensor-core instantiation with dropout is labelled
               `dropout`), and `tc_spill_bytes` sums the spills of the
               tensor-core kernels (`*_tc_kernel`); one without dropout
               that spills fails the phase;
  3. kernel  — the ragged paged-attention kernel against its plain
               version on one mixed wave at Llama-3-8B attention widths
               (QH=32, KVH=8, D=128, page 16): a 256-token prefill chunk
               at positions 512-767, 7 decode rows at lengths 100-2000,
               inactive rows up to T=384; fp32, bf16 and int8 pools
               (int8 with bf16 q and with fp32 q). Times are medians
               over CUDA events; `bound_ms` is the larger of the bytes
               the wave must move (unique KV of the touched slots, q of
               the active rows, the whole output) over the card's memory
               rate and the flops over its peak; `library_ms` is
               F.scaled_dot_product_attention over the wave's real
               extents (one call for the prefill slot, one batched call
               for the decode rows), KV gathered dense beforehand (a
               yardstick only);
  4. parity  — a depth-2 Llama-3-8B-width model (fp32, TF32 off) served
               by a card engine and a CPU engine from the same weights:
               4 greedy requests must give identical tokens;
  5. serve   — Llama-3-8B at full width (32 layers, bf16 random weights
               from a seed) serving 8 requests through run_pipelined(),
               with a bf16 pool and with an int8 pool;
  6. train_kernel — the three flash-attention kernels (forward, dQ,
               dK/dV) against their plain versions at the attention
               shapes of Llama-3-8B training (B=2, H=32 after the GQA
               repeat, S=2048, D=128, causal), bf16 and fp32. `bound_ms`
               counts the causal half of the S x S pairs and each operand
               byte once; `library_ms` is F.scaled_dot_product_attention
               (is_causal) for the forward and its backward (forward +
               backward, minus forward) for dQ and dK/dV together, a
               yardstick only. Each row gives its `design`,
               `library_factor` (kernel over library time, same run) and
               `bound_share` (bound over kernel time), and the dK/dV row
               `pair_library_factor` (dQ + dK/dV over the SDPA
               backward); a bf16 forward whose factor exceeds 6, or a
               bf16 dQ or dK/dV whose factor exceeds 4, fails the phase
               (the CUDA-core designs ran at 28x, 8.4x and 9.6x);
  7. train_parity — Llama-3-8B widths at depth 1 with the vocabulary cut
               to 4096, fp32, TF32 off, remat on, batch 1 x 512: two
               steps of make_train_step on the card and on the CPU from
               the same weights, holding the losses, the step-1
               gradients and the parameters after the steps;
  8. train   — Llama-3-8B widths at depth 4 (the one cut: 8B parameters
               with fp32 AdamW state do not fit one 80 GB card), bf16
               params, fp32 AdamW state, remat on, batch 2 x 2048, 6 steps
               on one fixed batch: median step time, tokens/s, the
               model-flops share of 989 TFLOP/s, peak memory, and losses
               that are finite and fall;
  9. mask_kernel — the three FlashMask kernels (forward, dQ, dK/dV)
               against their plain versions, bf16 and fp32: (a) at the
               packed-document shape of Llama-3-8B training (B=1, H=32,
               S=8192, D=128, eight documents of 192-3000 tokens, the
               (1, 1, S, 1) mask from doc_end_indices), with times;
               `bound_ms` counts the kept pairs exactly from the mask and
               each operand byte once; `library_ms` is
               F.scaled_dot_product_attention (is_causal) once per
               document, summed (forward; forward + backward minus forward
               for dQ and dK/dV), a yardstick only; `causal_only_ms` is
               the same kernel with no mask, and each kernel must take
               less than half of it (the block skip); each kernel counts
               the (q tile, k tile) pairs it computed, which must equal
               the skip rule's (`_tile_counts`), and its rows carry
               `design`, `library_factor` and `bound_share` as
               train_kernel's (the dK/dV row `pair_library_factor`), with
               the same limits on the bf16 factors (the bf16 dQ and
               dK/dV run the tensor-core loops of attn_bwd_sm90.cuh);
               (b) correctness over every mask flavor at B=2, H=4,
               S=1000, D=64 and 128, each kernel's tiles against
               `tile_plan`'s;
 10. packed_parity — train_parity with packed documents: batch 2 x 512,
               row 0 four documents, row 1 one, card against CPU;
 11. train_packed — the train phase's model on one 1 x 8192 row of the
               eight documents: median step, tokens/s, the model-flops
               share (attention charged at the full 12 L H S, and as
               kept), peak memory, falling losses;
 12. bucket_kernel — the bucketed serving kernels against their plain
               versions: (a) va_fwd at the serve phase's prefill wave
               (its 8 prompts packed into an 8192 bucket; H=32, KVH=8,
               D=128, causal, same offsets), bf16 and fp32, with times
               and the tiles it computed per head, which must equal the
               skip rule's count; `bound_ms` counts the kept pairs and
               the real rows; `library_ms` is
               F.scaled_dot_product_attention (is_causal) once per
               prompt, summed; (b) va_fwd correctness on ragged token
               axes of 700-1000 (causal and not, unequal q/k offsets,
               rows that see nothing), GQA groups 1 and 4, D=64 and 128;
               the va_fwd rows carry `design`, `library_factor` and
               `bound_share` as train_kernel's (bf16 runs the tensor-core
               loop with the varlen policy, and fails over 6x SDPA);
               (c) pa_decode at 8B widths on 8 slots of 100-2000 cached
               tokens and a free slot (exactly zero), fp32, bf16 and
               int8 pools (int8 with bf16 and with fp32 q), with times;
               `library_ms` is F.scaled_dot_product_attention over the
               live slots' KV gathered dense;
 13. bucket_parity — parity with the bucketed engine (`ragged=False`,
               max_seqs 3, run_pipelined): three requests admit in one
               prefill_varlen wave and the fourth alone through prefill;
               fp32 and int8 pools; tokens as in parity, and the exact
               launches of va_fwd, fa_fwd and pa_decode (none ragged;
               the CPU engine launches nothing);
 14. bucket_serve — the serve phase's model and 8 requests on the
               bucketed engine through run_pipelined(), bf16 and int8
               pools, with the same measurements, pad_tokens, and the
               launches of every kernel (the 8B parameters are built
               once for serve, bucket_serve and spec_serve);
 15. spec_kernel — pa_verify against its plain version: (a) at 8B
               widths on bucket_kernel's 8 live slots (cache lengths
               100-2000 before a G = 4 chunk), fp32, bf16 and int8 pools
               (int8 with bf16 and with fp32 q), with times; `bound_ms`
               by bytes (each slot's K/V up to base + G read once per KV
               head, q and the output once); `library_ms` is
               F.scaled_dot_product_attention over the slots' KV
               gathered dense, each row masked to base + g + 1; (b) G = 1
               against pa_decode at base + 1, both on the card; (c)
               correctness at (QH, KVH, G) = (4, 2, 3), (4, 2, 5), (6, 2,
               3), (32, 8, 16), (32, 8, 64), D 64 and 128, page 8 and 16;
 16. spec_parity — parity (depth 2, fp32, TF32 off, 4 greedy requests of
               32 tokens on ngram-repetitive prompts: a 3-token motif
               repeated) with spec_decode=4 on the
               bucketed engine, the bucketed engine with chunked prefill
               and the ragged engine, fp32 and int8 pools: tokens as in
               parity, something drafted, and the exact launches
               (pa_verify per layer and step and no decode kernel on the
               bucketed engines, no prefill kernel with chunked prefill,
               the ragged kernel per layer and step and no pa_verify on
               the ragged engine; the CPU engine launches nothing);
 17. spec_serve — the serve phase's model and 8 requests of the same
               lengths made ngram-repetitive (`echo_prompts`: a repeated
               motif, the model's own continuation of it, and the motif's
               tail again) through run(): bucketed spec_decode=4 with
               bf16 and int8 pools, bucketed spec_decode=16 with chunked
               prefill, and ragged spec_decode=4; output tok/s, the
               median verify step
               (one `_spec_step` that fed no prompt chunk, host clock),
               prefill tok/s, device steps, drafted and accepted tokens,
               the launches of every kernel, beside bucket_serve's plain
               decode numbers.

 18. varlen_kernel — the varlen dQ and dK/dV kernels against their plain
               versions: (a) at the packed row of train_packed (eight
               documents of 192-3000 tokens in 8192; QH=32 over KVH=8,
               D=128, causal, same offsets), bf16 and fp32, with times
               and the tiles each computed per head, which must equal the
               skip rule's count; `bound_ms` counts the kept pairs
               exactly (6 flops per pair and head dim for dQ, 8 for
               dK/dV) against each operand byte once; `library_ms` is
               F.scaled_dot_product_attention (is_causal) per document,
               forward + backward minus forward, summed; the ported
               FlashMask dQ and dK/dV on the same row (the same mask from
               doc_end_indices) are timed beside them as a yardstick;
               the forward va_fwd on the same row, against its plain
               version, with its tiles held to the skip rule, timed
               against F.scaled_dot_product_attention's forward per
               document and the ported FlashMask forward (`fm_fwd`) on
               the same row, with `design`, `library_factor` and
               `bound_share` (a bf16 factor over 6 fails); the dQ and
               dK/dV rows carry `design`, `library_factor` and
               `bound_share` too (bf16 runs the tensor-core loops of
               attn_bwd_sm90.cuh with the varlen policy, and a factor
               over 4 fails), and `kernel_only_ms`, the device time of
               the kernel alone from torch.profiler (the wrapper's time
               also holds va_positions, the tile ranges and, for bf16
               with D not a multiple of 8, the pad); the dK/dV row gives
               the pair's factor over the SDPA backward
               (`pair_library_factor`) and over the FlashMask pair
               (`pair_flashmask_factor`); (b)
               correctness on ragged token axes of 700-1000: unequal q/k
               offsets (no diagonal skip), causal and not, trailing pads
               on both sides, a query segment that sees nothing (dQ = 0)
               and a key segment nobody sees (dK = dV = 0), GQA groups 1
               and 4, D=64 and 128, bf16 and fp32; (c) flash_attn_unpadded
               on (a)'s row with autograd, bf16, against the plain
               versions on the card: exactly one va_fwd, one va_bwd_dq
               and one va_bwd_dkv (the launches the kernels line reports
               for the two);
 19. fused_parity — packed_parity's setup with a vocabulary of 12,000
               (two 8192-column chunks, the second short): two steps card
               against CPU with fused_ce=True, and again with
               remat="dots"; the card's fused losses against its losses
               through the full logits;
 20. train_fused — train_packed's model and row with fused_ce=True and
               remat="dots": the same measurements, and the first loss
               against the full-logits loss of the same seed weights and
               batch (train_packed's first loss), within a bf16
               tolerance.

After the phases, one line gives each phase's wall seconds
(`phase_seconds`; the serve phases' shared 8B parameters are built
outside them). The line before the last lists every kernel with its
launches on the main path, its error against the plain version and its
times; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

PHASES = ("device", "build", "kernel", "parity", "serve", "train_kernel",
          "train_parity", "train", "mask_kernel", "packed_parity",
          "train_packed", "bucket_kernel", "bucket_parity", "bucket_serve",
          "spec_kernel", "spec_parity", "spec_serve", "varlen_kernel",
          "fused_parity", "train_fused")
SOURCES = ("ragged_paged_attention", "flash_attention", "flashmask_attention",
           "varlen_attention", "paged_attention")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 CUDA cores; bf16 dense
TPU_KERNEL = "paddle_tpu/kernels/ragged_paged_attention.py:185"
FLASH_TPU_KERNELS = {"flash_fwd": "paddle_tpu/ops/flash_attention.py:107",
                     "flash_bwd_dq": "paddle_tpu/ops/flash_attention.py:220",
                     "flash_bwd_dkv": "paddle_tpu/ops/flash_attention.py:277"}
FLASHMASK_TPU_KERNELS = {
    "flashmask_fwd": "paddle_tpu/ops/flashmask_attention.py:248",
    "flashmask_bwd_dq": "paddle_tpu/ops/flashmask_attention.py:305",
    "flashmask_bwd_dkv": "paddle_tpu/ops/flashmask_attention.py:353"}
# the bucketed serving kernels: name -> (source, TPU kernel, the
# bucket_kernel row that times it, the bucket_serve run that counts it)
BUCKET_KERNELS = {
    "varlen_fwd": ("varlen_attention",
                   "paddle_tpu/ops/varlen_attention.py:92",
                   ("varlen_fwd", "bfloat16"), "bf16"),
    "paged_decode": ("paged_attention",
                     "paddle_tpu/ops/paged_attention.py:109",
                     ("paged_decode", "bfloat16"), "bf16"),
    "paged_decode_int8": ("paged_attention",
                          "paddle_tpu/ops/paged_attention.py:159",
                          ("paged_decode_int8", "int8"), "int8")}
# the paged verify kernel: name -> (spec_kernel row, spec_serve run)
SPEC_KERNELS = {
    "paged_verify": ("paddle_tpu/ops/paged_attention.py:284", "bfloat16",
                     "bucketed_g4_bf16"),
    "paged_verify_int8": ("paddle_tpu/ops/paged_attention.py:339", "int8",
                          "bucketed_g4_int8")}
VARLEN_BWD_TPU_KERNELS = {
    "varlen_bwd_dq": "paddle_tpu/ops/varlen_attention.py:213",
    "varlen_bwd_dkv": "paddle_tpu/ops/varlen_attention.py:259"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise AssertionError(msg)


def cuda_ms(fn, reps, warmup=2):
    """Median milliseconds of fn() over `reps` runs, each bracketed by
    CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------- phases
def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch_device": name,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi, name


def _ptxas_kernels(report):
    """Each kernel of an nvcc -Xptxas -v report: its name, shortened from
    the mangled one to the kernel, element type, head dim, mask policy
    and `dropout` for a backward loop instantiated with it
    (`dkv_tc_kernel<128, FmPolicy, dropout>`), its registers and spill
    bytes (stores + loads)."""
    import re
    out, name, spill = [], None, 0
    for ln in report.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            kern = re.search(r"\d+([A-Za-z_]+_kernel)", name)
            elem = re.search(r"_kernelI(13__nv_bfloat16|f)", name)
            args = [elem and ("bf16" if elem.group(1) != "f" else "f32"),
                    *re.findall(r"Li(\d+)E", name),
                    *re.findall(r"\d+([A-Za-z]+Policy)", name),
                    "Lb1E" in name and "dropout"]
            label = kern.group(1) if kern else name
            if any(args):
                label += "<" + ", ".join(a for a in args if a) + ">"
            out.append({"kernel": label, "registers": int(m.group(1)),
                        "spill_bytes": spill})
            name = None
    return out


def phase_build(card):
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:   # one nvcc per source
        secs = dict(zip(SOURCES, ex.map(_build.build, SOURCES)))
    wall = time.perf_counter() - t0
    for name in SOURCES:
        kernels = _ptxas_kernels(_build.ptxas_report(name))
        emit({"phase": "build", "card": card, "seconds": secs[name],
              "wall_seconds_all_sources": wall,
              "source": str(_build.lib_path(name).name), "ptxas": kernels,
              "tc_spill_bytes": sum(k["spill_bytes"] for k in kernels
                                    if "_tc_kernel" in k["kernel"])})
        spills = [k["kernel"] for k in kernels if k["spill_bytes"]
                  and "_tc_kernel" in k["kernel"]
                  and "dropout" not in k["kernel"]]
        if spills:
            fail(f"{name}: tensor-core kernels without dropout spill: "
                 f"{spills}")


# kernel-phase variants: name -> (pool dtype, q dtype)
VARIANTS = {"float32": ("float32", "float32"),
            "bfloat16": ("bfloat16", "bfloat16"),
            "int8": ("int8", "bfloat16"),
            "int8_fp32q": ("int8", "float32")}
# Kernel vs plain, compared in fp32 over the active rows. fp32 output:
# sums in another order within a page. bf16 output: both sides round
# the same fp32 value to bf16, and a rounding that lands on the other
# side costs one ulp, at most 2^-7 = 7.8e-3 of the value (rtol 8e-3);
# atol 2e-3 covers values near zero. int8 pages dequantize by the same
# fp32 products on both sides, so fp32 q holds them to the fp32 limits.
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-3, 8e-3)}


def _mixed_wave(variant, seed=0, device="cuda"):
    """The full-width mixed wave: (q, k, v, ks, vs, ptab, slot, pos,
    info) on `device`."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.paged_attention import quantize_kv
    QH, KVH, D, PAGE, T = 32, 8, 128, 16, 384
    max_len = 2048
    pps = max_len // PAGE
    lens = [768] + [100, 400, 700, 1000, 1300, 1700, 2000]
    S = len(lens)
    P = S * pps + 1
    rng = np.random.default_rng(seed)
    ptab = rng.permutation(P - 1)[:S * pps].reshape(S, pps).astype(np.int32)
    slot = np.zeros(T, np.int32)
    pos = np.full(T, -1, np.int32)
    slot[:256] = 0
    pos[:256] = np.arange(512, 768)
    slot[256:263] = np.arange(1, 8)
    pos[256:263] = np.array(lens[1:]) - 1
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    pools, qname = VARIANTS[variant]
    qdt = getattr(torch, qname)
    q = torch.randn((T, QH, D), generator=g, device=dev).to(qdt)
    k = torch.randn((KVH, P, PAGE, D), generator=g, device=dev)
    v = torch.randn((KVH, P, PAGE, D), generator=g, device=dev)
    ks = vs = None
    if pools == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    else:
        k, v = k.to(qdt), v.to(qdt)
    to = {"device": dev}
    info = {"lens": lens, "T": T, "QH": QH, "KVH": KVH, "D": D,
            "PAGE": PAGE, "active": int((pos >= 0).sum())}
    return (q, k.contiguous(), v.contiguous(), ks, vs,
            torch.tensor(ptab, **to), torch.tensor(slot, **to),
            torch.tensor(pos, **to), info)


def _bound(variant, info, pos):
    """Least time for the wave: the bytes it must move over the memory
    rate, or its flops over the peak for q's type. The bytes are the
    unique KV of the touched slots, q of the active rows (an inactive
    row's q is never read: its answer is zeros) and the whole output."""
    import numpy as np
    pools, qname = VARIANTS[variant]
    kv_elem = {"float32": 4, "bfloat16": 2, "int8": 1}[pools]
    q_elem = 4 if qname == "float32" else 2
    toks = sum(info["lens"])
    per_tok = info["KVH"] * info["D"] * kv_elem * 2
    if pools == "int8":
        per_tok += info["KVH"] * 4 * 2                 # fp32 scales
    nbytes = toks * per_tok + ((info["active"] + info["T"]) * info["QH"]
                               * info["D"] * q_elem)
    cols = (np.asarray(pos) + 1).clip(min=0).sum()
    flops = 4 * info["QH"] * info["D"] * int(cols)    # QK^T and PV
    peak = PEAK_FLOPS[qname]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def _dense_kv(pool, scale, ptab, slots, ncols, grp, dtype):
    """(len(slots), QH, ncols, D): the first `ncols` KV columns of each
    slot in `slots`, gathered dense, dequantized and GQA-expanded."""
    kvh, _, page, d = pool.shape
    idx = ptab[slots, :-(-ncols // page)].long()           # (n, pages)
    x = pool[:, idx].reshape(kvh, len(slots), -1, d)
    if scale is not None:
        x = x.float() * scale[:, idx].reshape(kvh, len(slots), -1, 1)
    x = x[:, :, :ncols].to(dtype).permute(1, 0, 2, 3)
    return x.repeat_interleave(grp, dim=1).contiguous()


def _library_call(q, k, v, ks, vs, ptab, slot, pos, info):
    """A closure timing F.scaled_dot_product_attention over the wave's
    real extents: one call per slot with several rows (the prefill
    chunk: its rows over its own columns, causal), one batched call for
    the single-row slots (the decode rows: KV cut to the longest of
    them, each row masked to its length). The dense KV is gathered
    beforehand and not timed."""
    import torch
    import torch.nn.functional as F
    grp = info["QH"] // info["KVH"]
    slot_c, pos_c = slot.cpu(), pos.cpu()
    rows_of = {}
    for i in range(info["T"]):
        if int(pos_c[i]) >= 0:
            rows_of.setdefault(int(slot_c[i]), []).append(i)
    groups = [[s] for s, r in rows_of.items() if len(r) > 1]
    single = [s for s, r in rows_of.items() if len(r) == 1]
    if single:
        groups.append(single)
    calls = []
    for slots in groups:
        if len(slots) == 1:
            rows = torch.tensor(rows_of[slots[0]], device=q.device)
            qd = q[rows].permute(1, 0, 2)[None]            # (1, QH, n, D)
            qpos = pos[rows][None]                          # (1, n)
        else:
            rows = torch.tensor([rows_of[s][0] for s in slots],
                                device=q.device)
            qd = q[rows][:, :, None]                        # (n, QH, 1, D)
            qpos = pos[rows][:, None]                       # (n, 1)
        ncols = int(qpos.max()) + 1
        st = torch.tensor(slots, device=q.device)
        kd = _dense_kv(k, ks, ptab, st, ncols, grp, q.dtype)
        vd = _dense_kv(v, vs, ptab, st, ncols, grp, q.dtype)
        cols = torch.arange(ncols, device=q.device)
        mask = (cols[None, None, :] <= qpos[:, :, None].long())[:, None]
        calls.append((qd.contiguous(), kd, vd, mask))

    def call():
        return [F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
                for qd, kd, vd, mask in calls]
    return call


def phase_kernel(card):
    import torch
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    from paddle_tpu_torch.models.llama import LlamaConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name in VARIANTS:
        q, k, v, ks, vs, ptab, slot, pos, info = _mixed_wave(name)
        kw = {"k_scale": ks, "v_scale": vs}
        ker = rpa.ragged_paged_attention(q, k, v, ptab, slot, pos, **kw)
        torch.cuda.synchronize()
        ref = rpa.ragged_paged_attention_reference(q, k, v, ptab, slot, pos,
                                                   **kw)
        active = pos >= 0
        err = (ker.float() - ref.float()).abs()
        max_err = float(err[active].max())
        atol, rtol = TOL[VARIANTS[name][1]]
        ok = torch.allclose(ker.float()[active], ref.float()[active],
                            atol=atol, rtol=rtol)
        zeros = bool((ker[~active] == 0).all())
        if not ok:
            fail(f"kernel vs plain ({name}): max |err| {max_err}")
        if not zeros:
            fail(f"kernel ({name}): inactive rows are not exactly zero")
        ms = cuda_ms(lambda: rpa.ragged_paged_attention(
            q, k, v, ptab, slot, pos, **kw), reps=20)
        plain_ms = cuda_ms(lambda: rpa.ragged_paged_attention_reference(
            q, k, v, ptab, slot, pos, **kw), reps=5, warmup=1)
        lib = _library_call(q, k, v, ks, vs, ptab, slot, pos, info)
        library_ms = cuda_ms(lib, reps=10)
        bound_ms, bound_by, nbytes, flops = _bound(name, info, pos.cpu())
        row = {"phase": "kernel", "card": card, "variant": name,
               "pools": VARIANTS[name][0],
               "q_dtype": str(q.dtype).replace("torch.", ""),
               "T": info["T"], "active_rows": info["active"],
               "atol": atol, "rtol": rtol, "max_abs_err": max_err,
               "inactive_rows_zero": zeros, "kernel_ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_bytes": nbytes, "bound_flops": flops,
               "tf32": False,
               # one launch per layer; the serve phase checks the count
               "launches_per_engine_step":
                   LlamaConfig.llama3_8b().num_hidden_layers}
        emit(row)
        out[name] = row
        del q, k, v, ks, vs, ker, ref, lib
        torch.cuda.empty_cache()
    return out


def _top2_margin(params, cfg, toks, page_size):
    """CPU engine's top-2 logit margin for the token after `toks`."""
    import torch
    from paddle_tpu_torch.models.llama_serving import unified_step
    n = len(toks)
    pages = -(-n // page_size)
    hd = cfg.hidden_size // cfg.num_attention_heads
    shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, pages + 1,
             page_size, hd)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    ptab = torch.arange(pages, dtype=torch.int32)[None]
    logits = unified_step(
        params, kp, vp, ptab, torch.tensor(toks, dtype=torch.int32),
        torch.zeros(n, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32), cfg, page_size,
        need_rows=torch.tensor([n - 1], dtype=torch.int32))
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def phase_parity(card):
    import numpy as np
    import torch
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.models.llama_spmd import init_params
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=2)
    cpu_params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gpu_params = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in cpu_params.items()}
    rng = np.random.default_rng(1)
    lens = [17, 90, 180, 300]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    results, info = {}, {}
    for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
        eng = ServingEngine(params, cfg, max_seqs=4, max_seq_len=512,
                            page_size=16, ragged_tokens=64, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new_tokens=16))
        rpa.launches = 0
        t0 = time.perf_counter()
        done = eng.run()
        if dev == "cuda":
            torch.cuda.synchronize()
        info[dev] = {"seconds": time.perf_counter() - t0,
                     "device_steps": eng.device_steps,
                     "launches": rpa.launches}
        if len(done) != 4 or not eng.pool.conserved(drained=True):
            fail(f"parity ({dev}): {len(done)} of 4 finished or pool leaked")
        results[dev] = {r.rid: list(r.output) for r in done}
    want = cfg.num_hidden_layers * info["cuda"]["device_steps"]
    if info["cuda"]["launches"] != want:
        fail(f"parity: {info['cuda']['launches']} kernel launches, "
             f"want layers x device steps = {want}")
    if info["cpu"]["launches"] != 0:
        fail("parity: the CPU engine launched the CUDA kernel")
    compared = {}
    for rid, p in enumerate(prompts):
        a, b = results["cuda"][rid], results["cpu"][rid]
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            compared[rid] = {"identical": len(a), "stopped_at": None}
            continue
        margin = _top2_margin(cpu_params, cfg, p + b[:j], 16)
        if margin >= 1e-3:
            fail(f"parity: request {rid} diverges at token {j} with CPU "
                 f"top-2 margin {margin}")
        compared[rid] = {"identical": j, "stopped_at": j,
                         "cpu_top2_margin": margin}
    emit({"phase": "parity", "card": card, "config": "llama3_8b widths, "
          "2 layers, fp32, TF32 off", "prompt_lens": lens,
          "new_tokens": 16, "requests": compared,
          "launches": info["cuda"]["launches"],
          "device_steps": info["cuda"]["device_steps"],
          "cuda_seconds": info["cuda"]["seconds"],
          "cpu_seconds": info["cpu"]["seconds"]})
    del gpu_params
    torch.cuda.empty_cache()


SERVE_CONFIG = "llama3_8b, 32 layers, bf16 random weights (seed 0)"


def serve_params():
    """The serve phase's model: Llama-3-8B at full width, bf16 random
    weights from seed 0, on the card. Returns (config, params)."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.models.llama_spmd import init_params
    cfg = LlamaConfig.llama3_8b()
    return cfg, init_params(cfg, seed=0, dtype=torch.bfloat16,
                            device="cuda")


def _serve_rng():
    """The serve phases' numpy generator: 8 prompt lengths in 64-1500
    come first, then the prompts' tokens. Returns (rng, lengths)."""
    import numpy as np
    rng = np.random.default_rng(2)
    return rng, rng.integers(64, 1501, 8).tolist()


def _motif_prompts(rng, vocab, lens):
    """ngram-repetitive prompts, as bench_models.py's spec workload makes
    them: a 3-token motif repeated to each length."""
    out = []
    for n in lens:
        motif = rng.integers(1, vocab, 3).tolist()
        out.append((motif * (n // 3 + 1))[:n])
    return out


def echo_prompts(cfg, params):
    """The spec phases' ngram-repetitive traffic on the serve phase's
    model: 8 prompts of the serve phase's lengths, each a repeated 3-token
    motif (the base), then S, the model's own 16-token greedy
    continuation of the base, then the base's last 8 tokens again. The
    prompt's end then repeats text that S followed earlier, the pattern
    prompt lookup drafts from (a request quoting or editing its context).
    A random-weight model does not continue a repeated motif, so motif
    prompts alone give no drafts; S is computed by the plain bucketed
    engine on the card."""
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    rng, lens = _serve_rng()
    bases = _motif_prompts(rng, cfg.vocab_size, [n - 24 for n in lens])
    eng = ServingEngine(params, cfg, max_seqs=8, max_seq_len=2048,
                        page_size=16, ragged=False, device="cuda")
    for i, b in enumerate(bases):
        eng.submit(Request(i, b, max_new_tokens=16))
    cont = {r.rid: list(r.output) for r in eng.run()}
    return [b + cont[i] + b[-8:] for i, b in enumerate(bases)]


def serve_engine(cfg, params, cache_dtype, new_tokens=64, ragged=True,
                 prompts=None, **engine_kw):
    """The serve phase's engine with its 8 requests submitted: prompts
    of 64-1500 tokens (numpy seed 2), or `prompts`, requests 0 and 1
    sampled (temperature 0.8, top_k 50, seed = rid), the rest greedy;
    ragged, or bucketed with `ragged=False`; `engine_kw` overrides the
    engine's other arguments. Returns (engine, requests)."""
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    if prompts is None:
        rng, lens = _serve_rng()
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    kw = dict(max_seqs=8, max_seq_len=2048, page_size=16, ragged_tokens=256,
              ragged=ragged, cache_dtype=cache_dtype, device="cuda")
    kw.update(engine_kw)
    eng = ServingEngine(params, cfg, **kw)
    reqs = [Request(i, p, max_new_tokens=new_tokens,
                    **({"temperature": 0.8, "top_k": 50, "seed": i}
                       if i < 2 else {}))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return eng, reqs


def phase_serve(card, cfg, params, init_s):
    import torch
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    runs = {}
    for cache in (None, "int8"):
        eng, reqs = serve_engine(cfg, params, cache)
        lens = [len(r.prompt) for r in reqs]
        marks = []
        finish = eng.step_finish

        def timed_finish(ticket, inflight=None, _finish=finish):
            n = _finish(ticket, inflight=inflight)
            marks.append((time.perf_counter(),
                          len(ticket.flat) == len(ticket.slots)))
            return n
        eng.step_finish = timed_finish
        torch.cuda.synchronize()
        rpa.launches = 0
        t0 = time.perf_counter()
        done = eng.run_pipelined()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rpa.launches
        name = "bf16" if cache is None else "int8"
        if len(done) != 8:
            fail(f"serve ({name}): {len(done)} of 8 requests finished")
        for r in done:
            if len(r.output) != 64:
                fail(f"serve ({name}): request {r.rid} has "
                     f"{len(r.output)} tokens, want 64")
            if not all(0 <= t < cfg.vocab_size for t in r.output):
                fail(f"serve ({name}): request {r.rid} left the vocabulary")
        if launches != cfg.num_hidden_layers * eng.device_steps:
            fail(f"serve ({name}): {launches} kernel launches, want "
                 f"{cfg.num_hidden_layers} x {eng.device_steps}")
        if not eng.pool.conserved(drained=True):
            fail(f"serve ({name}): page pool not conserved")
        last_prefill = max((t for t, dec in marks if not dec), default=t0)
        gaps = [b[0] - a[0] for a, b in zip(marks, marks[1:])
                if a[1] and b[1]]
        row = {"phase": "serve", "card": card, "pool": name,
               "config": SERVE_CONFIG,
               "prompt_lens": lens, "new_tokens": 64, "sampled": [0, 1],
               "wall_s": wall, "device_steps": eng.device_steps,
               "prefill_tokens": eng.prefill_tokens,
               "prefill_tok_s": eng.prefill_tokens / (last_prefill - t0),
               "decode_step_ms_median": (statistics.median(gaps) * 1e3
                                         if gaps else None),
               "output_tok_s": 8 * 64 / wall, "launches": launches,
               "launches_per_step": launches / eng.device_steps,
               "params_init_s": init_s}
        emit(row)
        runs[name] = row
        del eng
        torch.cuda.empty_cache()
    return runs


# ------------------------------------------------------------- training
TRAIN_ATTN = {"B": 2, "H": 32, "S": 2048, "D": 128}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# Kernel vs plain, by dtype, as TOL above. fp32: the CUDA-core kernels and
# the plain versions compute in fp32 from the same operands and sum in
# another order. bf16: the flash kernels multiply on the tensor cores, S
# and dP from the bf16 operands exactly, and P (forward, dV) and dS (dQ,
# dK) split into two bf16 terms, 16 bits of each (one term, the TPU
# kernel's cast of P to V's dtype, moved forward rows that see few keys
# by up to two ulps); so they differ from the fp32 plain versions by sums
# in another order and 2^-17 of P and dS before the outputs round to bf16:
# one ulp apart at most; so do the FlashMask and varlen kernels. lse is
# fp32 on both sides.
LSE_TOL = (1e-5, 1e-5)
# The design of each kernel row (`design`), and the most a bf16 kernel on
# the tensor cores may take over its library call (`library_factor`): the
# CUDA-core designs ran the forward at 28x and the flash backward at 8.4x
# (dQ) and 9.6x (dK/dV) the SDPA backward; the tensor-core ones must show
# they ran.
FWD_DESIGN = {"bfloat16": "tensor cores: mma.sync m16n8k16, cp.async K/V "
                          "ring of 2, P as bf16 hi + lo",
              "float32": "cuda-core fp32"}
BWD_DESIGN = ("tensor cores: mma.sync m16n8k16, cp.async ring of 2 (K/V for "
              "dQ; Q, dO, lse, delta for dK/dV), P and dS as bf16 hi + lo")
TC_BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv", "flashmask_bwd_dq",
                  "flashmask_bwd_dkv", "varlen_bwd_dq", "varlen_bwd_dkv")
MAX_FWD_LIBRARY_FACTOR = 6.0
MAX_BWD_LIBRARY_FACTOR = 4.0


def _design_row(row, kname, dname):
    """Add `design`, `library_factor` and `bound_share` to a kernel row;
    fail a bf16 tensor-core kernel slower than its limit
    (MAX_FWD_LIBRARY_FACTOR, MAX_BWD_LIBRARY_FACTOR) x its library
    call."""
    bf16 = dname == "bfloat16"
    limit = None
    row["design"] = FWD_DESIGN["float32"]
    if bf16 and kname.endswith("_fwd"):
        row["design"], limit = FWD_DESIGN[dname], MAX_FWD_LIBRARY_FACTOR
    elif bf16 and kname in TC_BWD_KERNELS:
        row["design"], limit = BWD_DESIGN, MAX_BWD_LIBRARY_FACTOR
    row["library_factor"] = row["kernel_ms"] / row["library_ms"]
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    if limit is not None and row["library_factor"] > limit:
        fail(f"{kname} (bf16): {row['kernel_ms']} ms, "
             f"{row['library_factor']:.2f}x its library call: the "
             "tensor-core kernel did not run at its speed")
    return row


def _train_counts():
    """Launches of the six training kernels, by kernel name."""
    import paddle_tpu_torch.ops.flash_attention as fa
    import paddle_tpu_torch.ops.flashmask_attention as fm
    return {"flash_fwd": fa.launches_fwd, "flash_bwd_dq": fa.launches_dq,
            "flash_bwd_dkv": fa.launches_dkv,
            "flashmask_fwd": fm.launches_fwd,
            "flashmask_bwd_dq": fm.launches_dq,
            "flashmask_bwd_dkv": fm.launches_dkv}


def _reset_train_counts():
    import paddle_tpu_torch.ops.flash_attention as fa
    import paddle_tpu_torch.ops.flashmask_attention as fm
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    fm.launches_fwd = fm.launches_dq = fm.launches_dkv = 0


def _want_counts(family, layers, steps):
    """The launches of `steps` remat steps of `layers` layers on one
    family of kernels ("flash" or "flashmask"), none on the other: the
    forward twice per layer and step (forward and recompute), dQ and
    dK/dV once."""
    want = {k: 0 for k in _train_counts()}
    want.update({f"{family}_fwd": 2 * layers * steps,
                 f"{family}_bwd_dq": layers * steps,
                 f"{family}_bwd_dkv": layers * steps})
    return want


def _attn_bound(kernel, dtype, b, h, s, d, pairs, extra_bytes=0):
    """Least time for one attention call: flops over the `pairs` (summed
    over batch and heads) it computes (4, 6, 8 flops per pair and head
    dim: QK^T and PV; S, dP and dQ; S, dP, dV and dK) over the peak for
    the dtype, or each operand byte once (plus `extra_bytes`, a mask)
    over the memory rate. `kernel` ends in fwd, dq or dkv."""
    kind = kernel.rsplit("_", 1)[1]
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * d * pairs
    big = b * h * s * d * (4 if dtype == "float32" else 2)
    vec = b * h * s * 4                                   # lse, delta
    nbytes = extra_bytes + {"fwd": 4 * big + vec,  # q k v in, o, lse out
                            "dq": 5 * big + 2 * vec,  # q k v dO lse delta, dQ
                            "dkv": 6 * big + 2 * vec}[kind]  # ..., dK dV
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_train_kernel(card):
    import math
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch.ops.flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, h, s, d = (TRAIN_ATTN[x] for x in "BHSD")
    scale = 1.0 / math.sqrt(d)
    out = {}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        q, k, v, do = (torch.randn((b, h, s, d), generator=g,
                                   device="cuda").to(dt) for _ in range(4))
        o, lse = fa._launch_fwd(q, k, v, True, scale)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, True, scale)
        delta = (do.float() * o_ref.float()).sum(-1)
        args = (q, k, v, do, lse_ref, delta, True, scale)
        dq = fa._launch_dq(*args)
        dk, dv = fa._launch_dkv(*args)
        torch.cuda.synchronize()
        dq_ref = fa.flash_bwd_dq_reference(*args)
        dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*args)
        atol, rtol = TOL[dname]
        errs = _check_kernels(
            "train_kernel", dname,
            {"flash_fwd": [o], "flash_bwd_dq": [dq],
             "flash_bwd_dkv": [dk, dv]},
            {"flash_fwd": [o_ref], "flash_bwd_dq": [dq_ref],
             "flash_bwd_dkv": [dk_ref, dv_ref]}, lse, lse_ref)
        lse_err = errs["lse"]
        del o, lse, dq, dk, dv, dq_ref, dk_ref, dv_ref
        kernel_ms = {
            "flash_fwd": cuda_ms(lambda: fa._launch_fwd(q, k, v, True, scale),
                                 reps=10),
            "flash_bwd_dq": cuda_ms(lambda: fa._launch_dq(*args), reps=10),
            "flash_bwd_dkv": cuda_ms(lambda: fa._launch_dkv(*args), reps=10)}
        plain_ms = {
            "flash_fwd": cuda_ms(lambda: fa.flash_fwd_reference(
                q, k, v, True, scale), reps=3, warmup=1),
            "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq_reference(*args),
                                    reps=3, warmup=1),
            "flash_bwd_dkv": cuda_ms(
                lambda: fa.flash_bwd_dkv_reference(*args), reps=3, warmup=1)}
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps=10)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

        def fwd_bwd():
            F.scaled_dot_product_attention(qg, kg, vg,
                                           is_causal=True).backward(do)
        lib_bwd = cuda_ms(fwd_bwd, reps=10) - lib_fwd
        library_ms = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
                      "flash_bwd_dkv": lib_bwd}
        for kname in FLASH_KERNELS:
            bound_ms, bound_by, nbytes, flops = _attn_bound(
                kname, dname, b, h, s, d, b * h * s * (s + 1) // 2)
            row = {"phase": "train_kernel", "card": card, "kernel": kname,
                   "dtype": dname, "shape_bhsd": [b, h, s, d],
                   "causal": True, "atol": atol, "rtol": rtol,
                   "max_abs_err": errs[kname], "kernel_ms": kernel_ms[kname],
                   "plain_ms": plain_ms[kname],
                   "library_ms": library_ms[kname],
                   "library_call": ("sdpa forward" if kname == "flash_fwd"
                                    else "sdpa backward (dQ, dK, dV)"),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_bytes": nbytes, "bound_flops": flops,
                   "tflops": flops / kernel_ms[kname] / 1e9, "tf32": False}
            if kname == "flash_fwd":
                row["lse_max_abs_err"] = lse_err
            if kname == "flash_bwd_dkv":   # the pair against one SDPA bwd
                row["pair_library_factor"] = (
                    kernel_ms["flash_bwd_dq"] + kernel_ms["flash_bwd_dkv"]) \
                    / lib_bwd
            emit(_design_row(row, kname, dname))
            out[(kname, dname)] = row
        del q, k, v, do, qg, kg, vg, args, o_ref, lse_ref, delta
        torch.cuda.empty_cache()
    return out


def _tree_to(tree, dev):
    return {k: (_tree_to(v, dev) if isinstance(v, dict)
                else v.to(dev, copy=True)) for k, v in tree.items()}


def _train_batch(vocab, b, s, seed):
    """(input_ids, labels): random tokens from a numpy seed, labels the
    next token; the last position and the first 16 labels of row 0 are
    ignored (-1)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1))
    labels = toks[:, 1:].copy()
    labels[:, -1] = -1
    labels[0, :16] = -1
    return toks[:, :-1], labels


# card vs CPU, fp32, TF32 off, at 8B widths: the losses to 1e-5
# relative plus 1e-5 (the one fixed batch is memorised within a step,
# and near a loss of 0 the per-token NLLs are differences of fp32
# logits some tens in size, whose ulps are a few 1e-6); each gradient
# elementwise to 1e-3 relative plus 1e-4 of its leaf's largest
# magnitude (matmuls over K = 4096 and 14336 sum in another order on
# each side); parameters to 2.5 lr per step (AdamW's first steps move
# an element by about lr whatever its gradient's size, so a near-zero
# gradient whose sign differs moves it by up to 2 lr) and to 1e-5 in
# relative norm
PARITY_GRAD_RTOL, PARITY_GRAD_SCALE = 1e-3, 1e-4


def _step_parity(name, cfg, batch_np, steps, lr, family, remat=True,
                 fused_ce=False):
    """`steps` steps of make_train_step (with `remat` and `fused_ce`)
    from the same fp32 weights on the card and on the CPU, held to the
    limits above; the kernels of `family` must launch on the card (none
    of the other family) and nothing on the CPU. Returns the phase's
    measurements."""
    import torch
    from paddle_tpu_torch.models import llama_spmd as T
    cpu_params = T.init_params(cfg, seed=0, dtype=torch.float32,
                               device="cpu")
    res = {}
    for dev in ("cuda", "cpu"):
        params = _tree_to(cpu_params, dev)
        opt = T.init_opt_state(params)
        batch = tuple(torch.from_numpy(a).to(dev) for a in batch_np)
        _, grads = T.loss_and_grads(params, batch, cfg, remat=remat,
                                    fused_ce=fused_ce)
        grads = [g.cpu() for g in T._leaves(grads)]
        step = T.make_train_step(cfg, remat=remat, fused_ce=fused_ce, lr=lr,
                                 device=dev)
        _reset_train_counts()
        t0 = time.perf_counter()
        losses = [float(step(params, opt, i, batch)[2]) for i in range(steps)]
        res[dev] = {"losses": losses, "grads": grads,
                    "params": [p.cpu() for p in T._leaves(params)],
                    "launches": _train_counts(),
                    "seconds": time.perf_counter() - t0}
        del params, opt, batch
    del cpu_params
    torch.cuda.empty_cache()
    want = _want_counts(family, cfg.num_hidden_layers, steps)
    if res["cuda"]["launches"] != want:
        fail(f"{name}: launches {res['cuda']['launches']}, want {want}")
    if any(res["cpu"]["launches"].values()):
        fail(f"{name}: the CPU step launched a CUDA kernel")
    gpu, cpu = res["cuda"], res["cpu"]
    loss_err = [abs(a - c) for a, c in zip(gpu["losses"], cpu["losses"])]
    if any(e > 1e-5 * abs(c) + 1e-5
           for e, c in zip(loss_err, cpu["losses"])):
        fail(f"{name}: losses {gpu['losses']} vs {cpu['losses']}")
    grad_worst = 0.0        # largest |err| / (allowed |err|)
    for a, c in zip(gpu["grads"], cpu["grads"]):
        allowed = (PARITY_GRAD_RTOL * c.abs()
                   + PARITY_GRAD_SCALE * float(c.abs().max()) + 1e-30)
        grad_worst = max(grad_worst, float(((a - c).abs() / allowed).max()))
    if grad_worst > 1.0:
        fail(f"{name}: step-1 gradients off, worst {grad_worst} of the "
             "tolerance")
    p_err = max(float((a - c).abs().max())
                for a, c in zip(gpu["params"], cpu["params"]))
    p_rel = max(float((a - c).norm() / c.norm())
                for a, c in zip(gpu["params"], cpu["params"]))
    if p_err > 2.5 * lr * steps or p_rel > 1e-5:
        fail(f"{name}: parameters off by {p_err} (relative norm {p_rel})")
    return {"steps": steps, "losses_cuda": gpu["losses"],
            "losses_cpu": cpu["losses"], "loss_abs_err": loss_err,
            "grad_worst_share_of_tol": grad_worst,
            "param_max_abs_err": p_err, "param_max_rel_norm_err": p_rel,
            "launches": gpu["launches"], "cuda_seconds": gpu["seconds"],
            "cpu_seconds": cpu["seconds"]}


def _parity_config():
    """Llama-3-8B widths at depth 1 with the vocabulary cut to 4096, so
    that the CPU side takes seconds; TF32 off."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=1,
                               vocab_size=4096)


def phase_train_parity(card):
    cfg = _parity_config()
    batch = _train_batch(cfg.vocab_size, 1, 512, seed=3)
    emit({"phase": "train_parity", "card": card,
          "config": "llama3_8b widths, 1 layer, vocab 4096, fp32, TF32 off, "
                    "remat, batch 1 x 512",
          **_step_parity("train_parity", cfg, batch, 2, 3e-4, "flash")})


# the packed rows: documents per row, each row summing to its length
PACKED_PARITY_ROWS = ([200, 150, 100, 62], [512])
PACKED_DOCS = (3000, 1500, 1200, 900, 700, 400, 300, 192)


def _packed_batch(vocab, rows, seed):
    """(input_ids, labels, doc_ids) of packed rows (`rows`: the document
    lengths of each row): random tokens from a numpy seed, labels the
    next token, -1 at each document's last token."""
    import numpy as np
    rng = np.random.default_rng(seed)
    s = sum(rows[0])
    toks = rng.integers(0, vocab, (len(rows), s + 1))
    labels = toks[:, 1:].copy()
    for r, lens in enumerate(rows):
        labels[r, np.cumsum(lens) - 1] = -1
    doc = np.stack([np.repeat(np.arange(len(lens)), lens) for lens in rows])
    return toks[:, :-1], labels, doc


def phase_packed_parity(card):
    cfg = _parity_config()
    batch = _packed_batch(cfg.vocab_size, PACKED_PARITY_ROWS, seed=3)
    emit({"phase": "packed_parity", "card": card,
          "config": "llama3_8b widths, 1 layer, vocab 4096, fp32, TF32 off, "
                    "remat, batch 2 x 512 packed: documents "
                    f"{list(map(list, PACKED_PARITY_ROWS))}",
          **_step_parity("packed_parity", cfg, batch, 2, 3e-4, "flashmask")})


TRAIN_CONFIG = ("llama3_8b widths, 4 layers, bf16 params, fp32 AdamW state, "
                "remat, random weights (seed 0), batch 2 x 2048")
TRAIN_PACKED_CONFIG = ("llama3_8b widths, 4 layers, bf16 params, fp32 AdamW "
                       "state, remat, random weights (seed 0), batch 1 x "
                       f"8192 packed: documents {list(PACKED_DOCS)}")


def _train_model(remat=True, fused_ce=False):
    """Llama-3-8B widths cut to 4 layers, bf16 random weights from seed 0
    on the card, fp32 AdamW state, the step with `remat` and `fused_ce`
    (lr 3e-4, clip 1.0). Returns (config, params, opt_state, step)."""
    import torch
    from paddle_tpu_torch.models import llama_spmd as T
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=4)
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    return cfg, params, T.init_opt_state(params), T.make_train_step(
        cfg, remat=remat, fused_ce=fused_ce, device="cuda")


def train_setup():
    """The train phase's run: `_train_model` and one fixed batch of 2 x
    2048 tokens (numpy seed 4). Returns (config, params, opt_state,
    batch, step)."""
    import torch
    cfg, params, opt, step = _train_model()
    ids, labels = _train_batch(cfg.vocab_size, 2, 2048, seed=4)
    batch = (torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda())
    return cfg, params, opt, batch, step


def train_packed_setup(remat=True, fused_ce=False):
    """The train_packed phase's run: `_train_model` and one fixed row of
    8192 tokens (numpy seed 5) packing the eight documents of
    PACKED_DOCS. Returns (config, params, opt_state, batch, step)."""
    import torch
    cfg, params, opt, step = _train_model(remat, fused_ce)
    batch = _packed_batch(cfg.vocab_size, [PACKED_DOCS], seed=5)
    return cfg, params, opt, tuple(torch.from_numpy(a).cuda()
                                   for a in batch), step


def _attention_pairs(batch):
    """Query-key pairs one head attends to over the batch: causal, and
    within each document when the batch carries doc_ids."""
    import numpy as np
    ids = batch[0]
    b, s = ids.shape
    if len(batch) < 3:
        return b * s * (s + 1) // 2
    doc = batch[2].cpu().numpy()
    lens = [np.unique(row, return_counts=True)[1] for row in doc]
    return int(sum((n * (n + 1) // 2).sum() for n in lens))


def _train_run(card, phase, config, setup, family):
    """Six steps of `setup`'s run on its one fixed batch: launches of
    `family`'s kernels only, finite and falling losses; the phase row."""
    import gc
    import statistics as st
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, params, opt, batch, step = setup()
    (b, s), steps = batch[0].shape, 6
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        _, _, loss = step(params, opt, i, batch)
        losses.append(loss.item())          # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_hidden_layers
    want = _want_counts(family, L, steps)
    if launches != want:
        fail(f"{phase}: launches {launches}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{phase}: losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{phase}: loss did not fall: {losses}")
    # model flops per token, the strict convention of bench.py: 6 N over
    # the matmul parameters (lm_head once, no embedding gather) plus
    # attention charged at the full (non-causal) 12 L H S
    H, F_, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * (H // cfg.num_attention_heads)
    n_layers = L * (2 * H * H + 2 * H * kv + 3 * H * F_)
    flops_tok = 6 * (n_layers + V * H) + 12 * L * H * s
    # attention as the step computes it: 12 L H flops per pair kept
    attn_kept = 12 * L * H * _attention_pairs(batch)
    step_ms = st.median(times[1:])          # the first step allocates
    tok_s = b * s / (step_ms / 1e3)
    kept_flops = 6 * (n_layers + V * H) * b * s + attn_kept
    row = {"phase": phase, "card": card, "config": config,
           "steps": steps, "losses": losses, "step_ms": times,
           "median_step_ms": step_ms, "tokens_per_s": tok_s,
           "model_flops_per_token": flops_tok,
           "model_flops_convention": "bench.py strict: 6 N per token "
                                     "plus attention at the full 12 L H S",
           "model_flops_share_of_989T": flops_tok * tok_s / 989e12,
           "attention_flops_strict_per_step": 12 * L * H * s * b * s,
           "attention_flops_kept_per_step": attn_kept,
           "kept_flops_share_of_989T": kept_flops / (step_ms / 1e3) / 989e12,
           "max_memory_allocated_gb": peak / 1e9, "launches": launches,
           "params_and_state_init_s": init_s}
    emit(row)
    del params, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_train(card):
    return _train_run(card, "train", TRAIN_CONFIG, train_setup, "flash")


def phase_train_packed(card):
    return _train_run(card, "train_packed", TRAIN_PACKED_CONFIG,
                      train_packed_setup, "flashmask")


# ------------------------------------------------------------- FlashMask
MASK_ATTN = {"B": 1, "H": 32, "S": 8192, "D": 128}
FLASHMASK_KERNELS = ("flashmask_fwd", "flashmask_bwd_dq", "flashmask_bwd_dkv")
# The plain versions run over slices of 8 heads at the packed shape: one
# (1, 32, 8192, 8192) fp32 score tensor is 8.6 GB and the backward holds
# several. The kernels run on all 32 heads at once.
PLAIN_HEADS = 8


def _by_heads(fn, *args):
    """fn(*args) over slices of PLAIN_HEADS heads, concatenated: every
    tensor argument with the heads' count on dim 1 is sliced, the shared
    (B, 1, S, n) mask is not. Without dropout only (its hash takes the
    head index)."""
    import torch
    h = args[0].shape[1]
    parts = []
    for a in range(0, h, PLAIN_HEADS):
        parts.append(fn(*(x[:, a:a + PLAIN_HEADS]
                          if torch.is_tensor(x) and x.dim() >= 3
                          and x.shape[1] == h else x for x in args)))
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, dim=1) for p in zip(*parts))
    return torch.cat(parts, dim=1)


def _kept_pairs(sri):
    """Pairs an n=1 causal mask (B, 1, S, 1) keeps per head, summed over
    B: column j keeps rows j .. min(start_j, S) - 1."""
    import torch
    s = sri.shape[2]
    j = torch.arange(s, device=sri.device)
    return int((sri[..., 0].long().clamp(max=s) - j).clamp(min=0).sum())


def _tile_counts(sri, tile=64):
    """(causal 64 x 64 tiles, those the n=1 mask wholly masks) of row 0:
    a tile is skipped when its first row is at or past the largest start
    over its columns, the kernels' test."""
    import torch
    start = sri[0, 0, :, 0].long()
    nt = -(-start.numel() // tile)
    pad = torch.full((nt * tile - start.numel(),), -(1 << 31),
                     device=start.device)
    mx = torch.cat([start, pad]).reshape(nt, tile).amax(1)
    qt = torch.arange(nt, device=start.device)[:, None]
    causal = torch.arange(nt, device=start.device)[None, :] <= qt
    return int(causal.sum()), int((causal & (qt * tile >= mx[None])).sum())


def _doc_sdpa(q, k, v, do, lens):
    """Closures timing F.scaled_dot_product_attention (is_causal) once
    per document: the forward, and forward + backward (one autograd pass
    over every document, so that the host adds one engine call, not
    eight). The per-document copies are made beforehand and not
    timed."""
    import torch
    import torch.nn.functional as F
    edges = [0]
    for n in lens:
        edges.append(edges[-1] + n)
    docs = [[t[:, :, a:b].contiguous() for t in (q, k, v, do)]
            for a, b in zip(edges, edges[1:])]
    grads = [[t.detach().requires_grad_() for t in d[:3]] + [d[3]]
             for d in docs]

    def fwd():
        return [F.scaled_dot_product_attention(qd, kd, vd, is_causal=True)
                for qd, kd, vd, _ in docs]

    def fwd_bwd():
        torch.autograd.backward(
            [F.scaled_dot_product_attention(qd, kd, vd, is_causal=True)
             for qd, kd, vd, _ in grads], [dod for *_, dod in grads])
    return fwd, fwd_bwd


def _check_kernels(label, dname, got, want, lse, lse_ref):
    """Hold kernel outputs to plain ones (TOL, LSE_TOL); returns the max
    |error| of each kernel."""
    import torch
    atol, rtol = TOL[dname]
    if not torch.allclose(lse, lse_ref, atol=LSE_TOL[0], rtol=LSE_TOL[1]):
        fail(f"{label} ({dname}): lse off by "
             f"{float((lse - lse_ref).abs().max())}")
    errs = {}
    for kname in got:
        pairs = list(zip(got[kname], want[kname]))
        errs[kname] = max(float((a.float() - r.float()).abs().max())
                          for a, r in pairs)
        if not all(torch.allclose(a.float(), r.float(), atol=atol,
                                  rtol=rtol) for a, r in pairs):
            fail(f"{label} {kname} ({dname}) vs plain: max |err| "
                 f"{errs[kname]}")
    errs["lse"] = float((lse - lse_ref).abs().max())
    return errs


def _mask_case(name, b, h, s, rng):
    """(sri numpy array or None, causal, window, dropout, seed) of one
    correctness case of the mask_kernel phase."""
    import numpy as np

    def band(lo, hi):
        start = rng.integers(lo, hi, (b, h, s, 1))
        return start, np.minimum(start + rng.integers(0, s // 4 + 1,
                                                      (b, h, s, 1)), s)
    if name == "causal_n2_band":
        return np.concatenate(band(0, s), -1), True, None, 0.0, None
    if name == "noncausal_n2":
        return (np.concatenate([rng.integers(s // 2, s + 1, (b, h, s, 1)),
                                rng.integers(0, s // 2, (b, h, s, 1))], -1),
                False, None, 0.0, None)
    if name == "noncausal_n4":
        return (np.concatenate([*band(0, s // 4), *band(s // 2, s)], -1),
                False, None, 0.0, None)
    if name == "causal_n1_window":
        return rng.integers(1, s + 1, (b, h, s, 1)), True, (256, 0), 0.0, None
    if name == "window_no_sri":
        return None, True, (256, 0), 0.0, None
    if name == "causal_n1_dropout":
        return rng.integers(1, s + 1, (b, h, s, 1)), True, None, 0.1, 1234567
    assert name == "masked_rows"   # rows [s/4, s/2) see nothing
    sri = np.full((b, 1, s, 1), s, np.int64)
    sri[:, :, : s // 2] = s // 4
    return sri, True, None, 0.0, None


MASK_CASES = ("causal_n2_band", "noncausal_n2", "noncausal_n4",
              "causal_n1_window", "window_no_sri", "causal_n1_dropout",
              "masked_rows")


def _mask_flavors(card):
    """Correctness only: every mask flavor at B=2, H=4, S=1000 (a ragged
    final tile), D=64 and 128, bf16 and fp32, and each kernel's computed
    tiles against `tile_plan`'s count."""
    import numpy as np
    import torch
    import paddle_tpu_torch.ops.flashmask_attention as fm
    b, h, s = 2, 4, 1000
    errs = {}
    for name in MASK_CASES:
        for d in (64, 128):
            for dname in ("bfloat16", "float32"):
                rng = np.random.default_rng(d)
                sri, causal, window, rate, seed = _mask_case(name, b, h, s,
                                                             rng)
                g = torch.Generator(device="cuda")
                g.manual_seed(d)
                q, k, v, do = (torch.randn((b, h, s, d), generator=g,
                                           device="cuda").to(
                    getattr(torch, dname)) for _ in range(4))
                sri = None if sri is None else torch.from_numpy(
                    sri.astype(np.int32)).cuda()
                m = fm._Mask(causal, window, 1.0 / math.sqrt(d), rate, seed)
                o, lse, computed = fm._launch_fwd(q, k, v, sri, m,
                                                  count_tiles=True)
                plan = fm.tile_plan(sri, s, s, causal, window)
                want = int((plan != fm.SKIP).sum()) * (
                    b * h // (plan.shape[0] * plan.shape[1]))
                o_ref, lse_ref = fm.flashmask_fwd_reference(q, k, v, sri, *m)
                delta = (do.float() * o_ref.float()).sum(-1)
                args = (q, k, v, sri, do, lse_ref, delta)
                dq, computed_dq = fm._launch_dq(*args, m, count_tiles=True)
                dk, dv, computed_dkv = fm._launch_dkv(*args, m,
                                                      count_tiles=True)
                torch.cuda.synchronize()
                if (computed, computed_dq, computed_dkv) != (want,) * 3:
                    fail(f"{name} d{d} ({dname}): the forward, dQ and dK/dV "
                         f"computed {computed}, {computed_dq} and "
                         f"{computed_dkv} tiles, tile_plan keeps {want}")
                dk_ref, dv_ref = fm.flashmask_bwd_dkv_reference(*args, *m)
                got = {"flashmask_fwd": [o], "flashmask_bwd_dq": [dq],
                       "flashmask_bwd_dkv": [dk, dv]}
                want = {"flashmask_fwd": [o_ref], "flashmask_bwd_dq":
                        [fm.flashmask_bwd_dq_reference(*args, *m)],
                        "flashmask_bwd_dkv": [dk_ref, dv_ref]}
                errs[f"{name}/d{d}/{dname}"] = _check_kernels(
                    name, dname, got, want, lse, lse_ref)
    emit({"phase": "mask_kernel", "card": card, "part": "flavors",
          "shape_bhsd": [b, h, s, "64|128"], "cases": list(MASK_CASES),
          "tol": TOL, "lse_tol": LSE_TOL,
          "max_abs_err": {k: max(v.values()) for k, v in errs.items()}})


def phase_mask_kernel(card):
    import numpy as np
    import torch
    import paddle_tpu_torch.ops.flashmask_attention as fm
    from paddle_tpu_torch.models.llama_spmd import doc_end_indices
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, h, s, d = (MASK_ATTN[x] for x in "BHSD")
    doc = np.repeat(np.arange(len(PACKED_DOCS)), PACKED_DOCS)[None]
    sri = doc_end_indices(torch.from_numpy(doc).cuda())     # (1, 1, S, 1)
    pairs = _kept_pairs(sri) * h
    tiles, skipped = _tile_counts(sri)
    m = fm._Mask(True, None, 1.0 / math.sqrt(d), 0.0, None)
    out = {}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        q, k, v, do = (torch.randn((b, h, s, d), generator=g,
                                   device="cuda").to(dt) for _ in range(4))
        o, lse, computed_fwd = fm._launch_fwd(q, k, v, sri, m,
                                              count_tiles=True)
        o_ref, lse_ref = _by_heads(fm.flashmask_fwd_reference, q, k, v, sri,
                                   *m)
        delta = (do.float() * o_ref.float()).sum(-1)
        args = (q, k, v, sri, do, lse_ref, delta)
        dq, computed_dq = fm._launch_dq(*args, m, count_tiles=True)
        dk, dv, computed_dkv = fm._launch_dkv(*args, m, count_tiles=True)
        torch.cuda.synchronize()
        computed = {"flashmask_fwd": computed_fwd,
                    "flashmask_bwd_dq": computed_dq,
                    "flashmask_bwd_dkv": computed_dkv}
        for kname, n in computed.items():
            if n != (tiles - skipped) * h:
                fail(f"{kname} ({dname}) computed {n} tiles, the skip rule "
                     f"keeps {(tiles - skipped) * h}")
        dk_ref, dv_ref = _by_heads(fm.flashmask_bwd_dkv_reference, *args, *m)
        errs = _check_kernels(
            "mask_kernel", dname,
            {"flashmask_fwd": [o], "flashmask_bwd_dq": [dq],
             "flashmask_bwd_dkv": [dk, dv]},
            {"flashmask_fwd": [o_ref], "flashmask_bwd_dq":
             [_by_heads(fm.flashmask_bwd_dq_reference, *args, *m)],
             "flashmask_bwd_dkv": [dk_ref, dv_ref]}, lse, lse_ref)
        del o, lse, dq, dk, dv, dk_ref, dv_ref
        launch = {"flashmask_fwd": lambda mk: fm._launch_fwd(q, k, v, mk, m),
                  "flashmask_bwd_dq": lambda mk: fm._launch_dq(
                      q, k, v, mk, do, lse_ref, delta, m),
                  "flashmask_bwd_dkv": lambda mk: fm._launch_dkv(
                      q, k, v, mk, do, lse_ref, delta, m)}
        plain = {"flashmask_fwd": fm.flashmask_fwd_reference,
                 "flashmask_bwd_dq": fm.flashmask_bwd_dq_reference,
                 "flashmask_bwd_dkv": fm.flashmask_bwd_dkv_reference}
        plain_args = {"flashmask_fwd": (q, k, v, sri, *m)}
        lib_fwd, lib_fwd_bwd = _doc_sdpa(q, k, v, do, PACKED_DOCS)
        fwd_ms = cuda_ms(lib_fwd, reps=10)
        bwd_ms = cuda_ms(lib_fwd_bwd, reps=10) - fwd_ms
        kernel_ms = {}
        for kname in FLASHMASK_KERNELS:
            kms = kernel_ms[kname] = cuda_ms(lambda: launch[kname](sri),
                                             reps=10)
            causal_ms = cuda_ms(lambda: launch[kname](None), reps=5)
            pa = plain_args.get(kname, (*args, *m))
            plain_ms = cuda_ms(lambda: _by_heads(plain[kname], *pa), reps=3,
                               warmup=1)
            if not kms < 0.5 * causal_ms:
                fail(f"{kname} ({dname}): {kms} ms with the document "
                     f"mask, {causal_ms} ms causal only: the block skip "
                     "does not pay")
            bound_ms, bound_by, nbytes, flops = _attn_bound(
                kname, dname, b, h, s, d, pairs, sri.numel() * 4)
            row = {"phase": "mask_kernel", "card": card, "kernel": kname,
                   "dtype": dname, "shape_bhsd": [b, h, s, d],
                   "documents": list(PACKED_DOCS), "causal": True,
                   "kept_pairs_per_head": pairs // h,
                   "causal_pairs_per_head": s * (s + 1) // 2,
                   "tiles_causal": tiles, "tiles_skipped": skipped,
                   "atol": TOL[dname][0], "rtol": TOL[dname][1],
                   "max_abs_err": errs[kname],
                   "plain_compared_by_heads": PLAIN_HEADS,
                   "kernel_ms": kms, "causal_only_ms": causal_ms,
                   "plain_ms": plain_ms,
                   "library_ms": fwd_ms if kname == "flashmask_fwd"
                   else bwd_ms,
                   "library_call": ("sdpa forward per document, summed"
                                    if kname == "flashmask_fwd" else
                                    "sdpa backward per document (dQ, dK, "
                                    "dV), summed"),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_bytes": nbytes, "bound_flops": flops,
                   "tflops": flops / kms / 1e9, "tf32": False,
                   "tiles_computed": computed[kname]}
            if kname == "flashmask_fwd":
                row["lse_max_abs_err"] = errs["lse"]
            if kname == "flashmask_bwd_dkv":   # the pair against one SDPA bwd
                row["pair_library_factor"] = (
                    kernel_ms["flashmask_bwd_dq"] + kms) / bwd_ms
            emit(_design_row(row, kname, dname))
            out[(kname, dname)] = row
        del q, k, v, do, args, o_ref, lse_ref, delta, lib_fwd, lib_fwd_bwd
        torch.cuda.empty_cache()
    _mask_flavors(card)
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- bucketed serving
# The serve prefill wave: the serve phase's 8 prompts packed into one
# power-of-two bucket, at Llama-3-8B attention widths.
BUCKET_ATTN = {"T": 8192, "H": 32, "KVH": 8, "D": 128}
# pa_decode at 8B widths: 8 slots of 100-2000 cached tokens and a free
# (length-0) slot, page 16, room for 2048 tokens a slot
DECODE_LENS = (100, 400, 700, 1000, 1300, 1700, 2000, 1500, 0)
DECODE_SHAPE = {"QH": 32, "KVH": 8, "D": 128, "PAGE": 16, "MAX_LEN": 2048}


def _segments(lens, total):
    """(total,) int32 segment ids of prompts `lens` packed back to back,
    -1 on the padding."""
    import numpy as np
    seg = np.full((total,), -1, np.int32)
    seg[:sum(lens)] = np.repeat(np.arange(len(lens)), lens)
    return seg


def _varlen_tiles(seg_q, seg_k, causal_diag, tile=64):
    """(64 x 64 tiles a head computes under the kernel's rule, causal
    tiles): a tile is skipped when the [min, max] of the non-negative
    segment ids of its rows and of its columns are disjoint or empty,
    or, with `causal_diag`, when it lies above the diagonal."""
    import numpy as np

    def ranges(seg):
        out = []
        for a in range(0, len(seg), tile):
            s = seg[a:a + tile]
            s = s[s >= 0]
            out.append((s.min(), s.max()) if len(s) else None)
        return out
    rq, rk = ranges(np.asarray(seg_q)), ranges(np.asarray(seg_k))
    n = 0
    for qt, a in enumerate(rq):
        for kt, b in enumerate(rk):
            if a is None or b is None or (causal_diag and kt > qt):
                continue
            n += int(b[0] <= a[1] and b[1] >= a[0])
    return n, len(rq) * (len(rq) + 1) // 2


def _varlen_case_segs(name):
    """The segment ids of one correctness case of the varlen kernels on
    a ragged token axis: (seg_q, seg_k, causal, same_offsets), numpy
    int32, seg_k the same array as seg_q with same offsets. Real segment
    ids are non-decreasing and padding trails."""
    import numpy as np
    if name == "causal_same":        # packed prompts, T = 1000
        seg_q = seg_k = _segments([300, 1, 250, 333], 1000)
        causal, same = True, True
    elif name in ("causal_unequal", "noncausal_unequal"):
        # more keys than queries per segment: bottom-right alignment
        seg_q = _segments([200, 150, 300], 700)
        seg_k = _segments([260, 150, 420], 1000)
        causal, same = name == "causal_unequal", False
    elif name == "unseen_keys":      # q segment 1 has no keys, and no
        seg_q = _segments([100, 200, 300], 1000)    # query has segment 3
        seg_k = np.concatenate([np.zeros(150, np.int32),
                                np.full(400, 2, np.int32),
                                np.full(100, 3, np.int32),
                                np.full(350, -1, np.int32)])
        causal, same = True, False
    else:                            # masked_rows: q segment 1 has no keys
        seg_q = _segments([100, 200, 300], 1000)
        seg_k = np.concatenate([np.zeros(150, np.int32),
                                np.full(400, 2, np.int32),
                                np.full(450, -1, np.int32)])
        causal, same = False, False
    return seg_q, seg_k, causal, same


def _varlen_case(name, dname, h, kvh, d, seed):
    """One correctness case of the varlen kernels (`_varlen_case_segs`):
    (q, k, v, seg_q, seg_k, causal, same_offsets), on the card."""
    import numpy as np
    import torch
    seg_q, seg_k, causal, same = _varlen_case_segs(name)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dt = getattr(torch, dname)
    q = torch.randn((len(seg_q), h, d), generator=g, device="cuda").to(dt)
    k = torch.randn((len(seg_k), kvh, d), generator=g, device="cuda").to(dt)
    v = torch.randn((len(seg_k), kvh, d), generator=g, device="cuda").to(dt)
    sq = torch.from_numpy(np.ascontiguousarray(seg_q)).cuda()
    sk = sq if same else torch.from_numpy(np.ascontiguousarray(seg_k)).cuda()
    return q, k, v, sq, sk, causal, same


VARLEN_CASES = ("causal_same", "causal_unequal", "noncausal_unequal",
                "masked_rows")


def _varlen_flavors():
    """Correctness only: every case of VARLEN_CASES, GQA groups 1 and 4,
    D = 64 and 128, bf16 and fp32. Returns the max |error| of each."""
    import torch
    import paddle_tpu_torch.ops.varlen_attention as va
    errs = {}
    for name in VARLEN_CASES:
        for h, kvh in ((8, 8), (8, 2)):
            for d in (64, 128):
                for dname in ("bfloat16", "float32"):
                    q, k, v, sq, sk, causal, same = _varlen_case(
                        name, dname, h, kvh, d, seed=d + kvh)
                    scale = 1.0 / math.sqrt(d)
                    sqs, sks = va._sentinels(sq, sk)
                    o, lse = va._launch_fwd(q, k, v, sqs, sks, causal, scale,
                                            same)
                    torch.cuda.synchronize()
                    o_ref, lse_ref = va.varlen_fwd_reference(
                        q, k, v, sq, sk, causal, scale)
                    key = f"{name}/g{h // kvh}/d{d}/{dname}"
                    errs[key] = _check_kernels(
                        f"bucket_kernel {key}", dname, {"varlen_fwd": [o]},
                        {"varlen_fwd": [o_ref]}, lse, lse_ref)["varlen_fwd"]
                    dead = sqs < 0
                    if name == "masked_rows":
                        dead = dead | (sqs == 1)
                    if not (bool((o[dead] == 0).all()) and
                            bool((lse[:, dead] == -1e30).all())):
                        fail(f"bucket_kernel {key}: a row that sees nothing "
                             "is not o = 0, lse = -1e30")
    return errs


def _varlen_sdpa(q, k, v, lens):
    """A closure timing F.scaled_dot_product_attention (is_causal) once
    per packed prompt, summed; the per-prompt (1, H, n, D) copies, K/V
    repeated to the query heads, are made beforehand and not timed."""
    import torch.nn.functional as F
    grp = q.shape[1] // k.shape[1]
    docs, a = [], 0
    for n in lens:
        docs.append([t[a:a + n].transpose(0, 1)[None].repeat_interleave(
            r, dim=1).contiguous() for t, r in ((q, 1), (k, grp), (v, grp))])
        a += n

    def call():
        return [F.scaled_dot_product_attention(qd, kd, vd, is_causal=True)
                for qd, kd, vd in docs]
    return call


def _varlen_bound(dname, lens, t, h, kvh, d):
    """Least time for the serve prefill wave's attention: the real rows
    of q, k and v read once, the segment ids and distances (4 x T int32),
    o and lse written for every row, over the memory rate; or 4 flops
    per kept pair and head dim over the peak for the dtype."""
    elem = 4 if dname == "float32" else 2
    real = sum(lens)
    nbytes = (real * (h + 2 * kvh) * d * elem + 4 * t * 4
              + t * h * d * elem + h * t * 4)
    flops = 4 * d * h * sum(n * (n + 1) // 2 for n in lens)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_bucket_kernel(card):
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch.ops.paged_attention as pa
    import paddle_tpu_torch.ops.varlen_attention as va
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t, h, kvh, d = (BUCKET_ATTN[x] for x in ("T", "H", "KVH", "D"))
    _, lens = _serve_rng()
    seg_np = _segments(lens, t)
    want_tiles, causal_tiles = _varlen_tiles(seg_np, seg_np, True)
    seg = torch.from_numpy(seg_np).cuda()
    sq, sk = va._sentinels(seg, seg)
    scale = 1.0 / math.sqrt(d)
    out = {}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        q = torch.randn((t, h, d), generator=g, device="cuda").to(dt)
        k = torch.randn((t, kvh, d), generator=g, device="cuda").to(dt)
        v = torch.randn((t, kvh, d), generator=g, device="cuda").to(dt)
        o, lse, tiles = va._launch_fwd(q, k, v, sq, sk, True, scale, True,
                                       count_tiles=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = va.varlen_fwd_reference(q, k, v, seg, seg, True,
                                                 scale)
        err = _check_kernels("bucket_kernel", dname, {"varlen_fwd": [o]},
                             {"varlen_fwd": [o_ref]}, lse, lse_ref)
        if tiles != want_tiles * h:
            fail(f"va_fwd ({dname}): computed {tiles} tiles, the skip rule "
                 f"gives {want_tiles} x {h} heads")
        if not bool((o[sq < 0] == 0).all()):
            fail(f"va_fwd ({dname}): padding rows are not zero")
        del o, lse, o_ref, lse_ref
        ms = cuda_ms(lambda: va._launch_fwd(q, k, v, sq, sk, True, scale,
                                            True), reps=20)
        plain_ms = cuda_ms(lambda: va.varlen_fwd_reference(
            q, k, v, seg, seg, True, scale), reps=3, warmup=1)
        library_ms = cuda_ms(_varlen_sdpa(q, k, v, lens), reps=20)
        bound_ms, bound_by, nbytes, flops = _varlen_bound(dname, lens, t, h,
                                                          kvh, d)
        row = {"phase": "bucket_kernel", "kernel": "varlen_fwd",
               "card": card, "dtype": dname, "T": t, "H": h, "KVH": kvh,
               "D": d, "prompt_lens": lens, "causal": True,
               "same_offsets": True, "tiles_computed_per_head": tiles // h,
               "tiles_causal_per_head": causal_tiles,
               "atol": TOL[dname][0], "rtol": TOL[dname][1],
               "max_abs_err": err["varlen_fwd"],
               "lse_max_abs_err": err["lse"], "kernel_ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_call": "sdpa (is_causal) per prompt, summed",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_bytes": nbytes, "bound_flops": flops,
               "tflops": flops / ms / 1e9, "tf32": False}
        emit(_design_row(row, "varlen_fwd", dname))
        out[("varlen_fwd", dname)] = row
        del q, k, v
        torch.cuda.empty_cache()
    emit({"phase": "bucket_kernel", "part": "varlen flavors", "card": card,
          "cases": list(VARLEN_CASES), "groups": [1, 4], "head_dims":
          [64, 128], "tol": TOL, "lse_tol": LSE_TOL,
          "max_abs_err": _varlen_flavors()})
    for name in VARIANTS:
        # a (B, QH, 1, D) verify batch is the decode batch, its bases
        # the lengths
        q, k, v, ks, vs, ptab, lengths = _verify_batch(name, DECODE_LENS, 1)
        q = q[:, :, 0].contiguous()
        kw = {"k_scale": ks, "v_scale": vs}
        ker = pa.paged_attention(q, k, v, ptab, lengths, **kw)
        torch.cuda.synchronize()
        ref = pa.paged_decode_reference(q, k, v, ptab, lengths, **kw)
        atol, rtol = TOL[VARIANTS[name][1]]
        max_err = float((ker.float() - ref.float()).abs().max())
        if not torch.allclose(ker.float(), ref.float(), atol=atol, rtol=rtol):
            fail(f"pa_decode vs plain ({name}): max |err| {max_err}")
        if not bool((ker[lengths == 0] == 0).all()):
            fail(f"pa_decode ({name}): the length-0 slot is not zero")
        ms = cuda_ms(lambda: pa.paged_attention(q, k, v, ptab, lengths, **kw),
                     reps=50)
        plain_ms = cuda_ms(lambda: pa.paged_decode_reference(
            q, k, v, ptab, lengths, **kw), reps=5, warmup=1)
        live = torch.nonzero(lengths > 0)[:, 0]
        grp = DECODE_SHAPE["QH"] // DECODE_SHAPE["KVH"]
        ncols = int(lengths.max())
        kd = _dense_kv(k, ks, ptab, live, ncols, grp, q.dtype)
        vd = _dense_kv(v, vs, ptab, live, ncols, grp, q.dtype)
        qd = q[live][:, :, None].contiguous()
        mask = (torch.arange(ncols, device="cuda")[None, :]
                < lengths[live][:, None])[:, None, None]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask), reps=20)
        # decode at length n is a G = 1 verify chunk at base n - 1
        bound_ms, bound_by, nbytes, flops = _verify_bound(
            name, [n - 1 for n in DECODE_LENS], 1)
        kname = "paged_decode_int8" if VARIANTS[name][0] == "int8" \
            else "paged_decode"
        row = {"phase": "bucket_kernel", "kernel": kname, "card": card,
               "variant": name, "pools": VARIANTS[name][0],
               "q_dtype": VARIANTS[name][1], "lengths": list(DECODE_LENS),
               **DECODE_SHAPE, "atol": atol, "rtol": rtol,
               "max_abs_err": max_err, "length0_zero": True,
               "kernel_ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library_call": "sdpa over the live slots' KV gathered "
                               "dense, masked to each length",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_bytes": nbytes, "bound_flops": flops, "tf32": False}
        emit(row)
        out[(kname, name)] = row
        del q, k, v, ks, vs, ker, ref, kd, vd
        torch.cuda.empty_cache()
    return out


def _bucket_counts():
    """Launches of every serving kernel, by kernel name."""
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    import paddle_tpu_torch.ops.flash_attention as fa
    import paddle_tpu_torch.ops.paged_attention as pa
    import paddle_tpu_torch.ops.varlen_attention as va
    return {"varlen_fwd": va.launches_fwd, "flash_fwd": fa.launches_fwd,
            "paged_decode": pa.launches_decode,
            "paged_decode_int8": pa.launches_decode_int8,
            "paged_verify": pa.launches_verify,
            "paged_verify_int8": pa.launches_verify_int8,
            "ragged_paged_attention": rpa.launches}


def _reset_bucket_counts():
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    import paddle_tpu_torch.ops.flash_attention as fa
    import paddle_tpu_torch.ops.paged_attention as pa
    import paddle_tpu_torch.ops.varlen_attention as va
    va.launches_fwd = fa.launches_fwd = rpa.launches = 0
    pa.launches_decode = pa.launches_decode_int8 = 0
    pa.launches_verify = pa.launches_verify_int8 = 0


def _bucket_run(eng, pipelined, marks=None):
    """Run a bucketed engine with its prefill calls counted: (finished
    requests, {"waves": packed prefill_varlen waves, "singles": lone
    prefills}, launches by kernel). Given `marks`, appends the host time
    at which each admission's prefill was done: when the engine's
    prefill method returns, having read the seed logits, which waits
    for the device."""
    from paddle_tpu_torch.models import llama_serving as S
    calls = {"waves": 0, "singles": 0}
    originals = (S.prefill_varlen, S.prefill)

    def counted(fn, key):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper
    S.prefill_varlen = counted(originals[0], "waves")
    S.prefill = counted(originals[1], "singles")
    if marks is not None:
        for name in ("_prefill_packed", "_prefill_into"):
            def marked(*a, _fn=getattr(eng, name), **k):
                out = _fn(*a, **k)
                marks.append(time.perf_counter())
                return out
            setattr(eng, name, marked)
    _reset_bucket_counts()
    try:
        done = eng.run_pipelined() if pipelined else eng.run()
    finally:
        S.prefill_varlen, S.prefill = originals
    return done, calls, _bucket_counts()


def _want_bucket_counts(layers, calls, steps, int8):
    """The launches of a bucketed run: va_fwd per layer and packed wave,
    fa_fwd per layer and lone prefill, pa_decode (its int8 variant with
    int8 pools) per layer and decode step, nothing ragged."""
    want = {k: 0 for k in _bucket_counts()}
    want["varlen_fwd"] = layers * calls["waves"]
    want["flash_fwd"] = layers * calls["singles"]
    want["paged_decode_int8" if int8 else "paged_decode"] = layers * steps
    return want


def phase_bucket_parity(card):
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.models.llama_spmd import init_params
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=2)
    cpu_params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gpu_params = _tree_to(cpu_params, "cuda")
    rng = np.random.default_rng(1)
    lens = [17, 90, 180, 300]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    L = cfg.num_hidden_layers
    runs = {}
    for cache in (None, "int8"):
        results, info = {}, {}
        for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
            eng = ServingEngine(params, cfg, max_seqs=3, max_seq_len=512,
                                page_size=16, cache_dtype=cache,
                                ragged=False, device=dev)
            for i, p in enumerate(prompts):
                eng.submit(Request(i, p, max_new_tokens=16))
            t0 = time.perf_counter()
            done, calls, launches = _bucket_run(eng, pipelined=True)
            if dev == "cuda":
                torch.cuda.synchronize()
            info[dev] = {"seconds": time.perf_counter() - t0,
                         "device_steps": eng.device_steps, "calls": calls,
                         "launches": launches, "pad_tokens": eng.pad_tokens}
            if len(done) != 4 or not eng.pool.conserved(drained=True):
                fail(f"bucket_parity ({dev}): {len(done)} of 4 finished or "
                     "pool leaked")
            results[dev] = {r.rid: list(r.output) for r in done}
        g = info["cuda"]
        if g["calls"] != {"waves": 1, "singles": 1}:
            fail(f"bucket_parity: prefill calls {g['calls']}, want one "
                 "packed wave of three and one lone prefill")
        want = _want_bucket_counts(L, g["calls"], g["device_steps"],
                                   cache == "int8")
        if g["launches"] != want:
            fail(f"bucket_parity: launches {g['launches']}, want {want}")
        if any(info["cpu"]["launches"].values()):
            fail("bucket_parity: the CPU engine launched a CUDA kernel")
        compared = {}
        for rid, p in enumerate(prompts):
            a, b = results["cuda"][rid], results["cpu"][rid]
            j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if j is None:
                compared[rid] = {"identical": len(a), "stopped_at": None}
                continue
            margin = _top2_margin(cpu_params, cfg, p + b[:j], 16)
            if margin >= 1e-3:
                fail(f"bucket_parity: request {rid} diverges at token {j} "
                     f"with CPU top-2 margin {margin}")
            compared[rid] = {"identical": j, "stopped_at": j,
                             "cpu_top2_margin": margin}
        name = "fp32" if cache is None else "int8"
        row = {"phase": "bucket_parity", "card": card, "pool": name,
               "config": "llama3_8b widths, 2 layers, fp32, TF32 off, "
                         "ragged=False, max_seqs 3, run_pipelined",
               "prompt_lens": lens, "new_tokens": 16, "requests": compared,
               "prefill_calls": g["calls"], "launches": g["launches"],
               "device_steps": g["device_steps"],
               "pad_tokens": g["pad_tokens"],
               "cuda_seconds": g["seconds"],
               "cpu_seconds": info["cpu"]["seconds"]}
        emit(row)
        runs[name] = row
    del gpu_params
    torch.cuda.empty_cache()
    return runs


def phase_bucket_serve(card, cfg, params, init_s):
    import torch
    runs = {}
    for cache in (None, "int8"):
        eng, reqs = serve_engine(cfg, params, cache, ragged=False)
        lens = [len(r.prompt) for r in reqs]
        finishes, prefills = [], []
        finish = eng.step_finish

        def timed_finish(ticket, inflight=None, _finish=finish):
            n = _finish(ticket, inflight=inflight)
            finishes.append(time.perf_counter())
            return n
        eng.step_finish = timed_finish
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done, calls, launches = _bucket_run(eng, pipelined=True,
                                            marks=prefills)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        name = "bf16" if cache is None else "int8"
        if len(done) != 8:
            fail(f"bucket_serve ({name}): {len(done)} of 8 requests finished")
        for r in done:
            if len(r.output) != 64:
                fail(f"bucket_serve ({name}): request {r.rid} has "
                     f"{len(r.output)} tokens, want 64")
            if not all(0 <= t < cfg.vocab_size for t in r.output):
                fail(f"bucket_serve ({name}): request {r.rid} left the "
                     "vocabulary")
        want = _want_bucket_counts(cfg.num_hidden_layers, calls,
                                   eng.device_steps, cache == "int8")
        if launches != want:
            fail(f"bucket_serve ({name}): launches {launches}, want {want}")
        if not eng.pool.conserved(drained=True):
            fail(f"bucket_serve ({name}): page pool not conserved")
        # decode-only intervals: consecutive finishes with no prefill
        # call returning between them
        gaps = [b - a for a, b in zip(finishes, finishes[1:])
                if not any(a < p <= b for p in prefills)]
        last_prefill = max(prefills, default=t0)
        row = {"phase": "bucket_serve", "card": card, "pool": name,
               "config": SERVE_CONFIG + ", ragged=False",
               "prompt_lens": lens, "new_tokens": 64, "sampled": [0, 1],
               "wall_s": wall, "device_steps": eng.device_steps,
               "prefill_calls": calls, "prefill_tokens": eng.prefill_tokens,
               "pad_tokens": eng.pad_tokens,
               "prefill_tok_s": eng.prefill_tokens / (last_prefill - t0),
               "decode_step_ms_median": (statistics.median(gaps) * 1e3
                                         if gaps else None),
               "output_tok_s": 8 * 64 / wall, "launches": launches,
               "params_init_s": init_s}
        emit(row)
        runs[name] = row
        del eng
        torch.cuda.empty_cache()
    return runs


# ------------------------------------------- speculative decoding
# pa_verify at 8B widths: bucket_kernel's 8 live slots as the cache
# lengths BEFORE a G = 4 chunk (the longest, 2000 + 4, fits 2048)
VERIFY_BASES = DECODE_LENS[:8]
VERIFY_G = 4
# correctness shapes (QH, KVH, G): the JAX tests' awkward rows, and 8B
# widths at chunked-prefill widths 16 (one 64-row tile) and 64 (four)
VERIFY_CASES = ((4, 2, 3), (4, 2, 5), (6, 2, 3), (32, 8, 16), (32, 8, 64))


def _verify_batch(variant, bases, g, qh=32, kvh=8, d=128, page=16, seed=0):
    """pa_verify operands on the card, room for 2048 tokens a slot, pages
    in random order: (q (B, QH, G, D), k, v, ks, vs, ptab, base)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.paged_attention import quantize_kv
    pps = -(-DECODE_SHAPE["MAX_LEN"] // page)
    B = len(bases)
    P = B * pps + 1
    rng = np.random.default_rng(seed)
    ptab = rng.permutation(P - 1)[:B * pps].reshape(B, pps).astype(np.int32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    pools, qname = VARIANTS[variant]
    qdt = getattr(torch, qname)
    q = torch.randn((B, qh, g, d), generator=gen, device="cuda").to(qdt)
    k = torch.randn((kvh, P, page, d), generator=gen, device="cuda")
    v = torch.randn((kvh, P, page, d), generator=gen, device="cuda")
    ks = vs = None
    if pools == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    else:
        k, v = k.to(qdt), v.to(qdt)
    return (q, k.contiguous(), v.contiguous(), ks, vs,
            torch.from_numpy(ptab).cuda(),
            torch.tensor(bases, dtype=torch.int32, device="cuda"))


def _verify_bound(variant, bases, g):
    """Least time for one pa_verify call at 8B widths (a pa_decode call
    at lengths n is one at bases n - 1, G = 1): each slot's K/V up to
    base + G (and their int8 scales) read once for all of a KV head's
    group x G rows, q read and the output written once, the page table
    and base lengths, over the memory rate; or 4 flops per (query row,
    column it sees, head dim) over the peak for q's type."""
    pools, qname = VARIANTS[variant]
    QH, KVH, D = (DECODE_SHAPE[x] for x in ("QH", "KVH", "D"))
    kv_elem = {"float32": 4, "bfloat16": 2, "int8": 1}[pools]
    q_elem = 4 if qname == "float32" else 2
    toks = sum(b + g for b in bases)
    per_tok = KVH * D * kv_elem * 2 + (KVH * 4 * 2 if pools == "int8" else 0)
    B = len(bases)
    nbytes = (toks * per_tok + 2 * B * QH * g * D * q_elem
              + B * (DECODE_SHAPE["MAX_LEN"] // DECODE_SHAPE["PAGE"] + 1) * 4)
    flops = 4 * QH * D * sum(b + i + 1 for b in bases for i in range(g))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[qname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def _verify_flavors():
    """Correctness only: every VERIFY_CASES shape, D = 64 and 128, page 8
    and 16, every pool variant, on slots of base 0, 1, page - 1, 300 and
    2000 - G; each held to TOL. Returns the max |error| of each."""
    import torch
    import paddle_tpu_torch.ops.paged_attention as pa
    errs = {}
    for qh, kvh, g in VERIFY_CASES:
        for d in (64, 128):
            for page in (8, 16):
                for name in VARIANTS:
                    q, k, v, ks, vs, ptab, base = _verify_batch(
                        name, (0, 1, page - 1, 300, 2000 - g), g, qh, kvh,
                        d, page, seed=d + g)
                    kw = {"k_scale": ks, "v_scale": vs}
                    ker = pa.paged_verify_attention(q, k, v, ptab, base, **kw)
                    torch.cuda.synchronize()
                    ref = pa.paged_verify_reference(q, k, v, ptab, base, **kw)
                    atol, rtol = TOL[VARIANTS[name][1]]
                    key = f"{qh}/{kvh}/g{g}/d{d}/p{page}/{name}"
                    errs[key] = float((ker.float() - ref.float()).abs().max())
                    if not torch.allclose(ker.float(), ref.float(), atol=atol,
                                          rtol=rtol):
                        fail(f"pa_verify vs plain ({key}): max |err| "
                             f"{errs[key]}")
    return errs


def phase_spec_kernel(card):
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch.ops.paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grp = DECODE_SHAPE["QH"] // DECODE_SHAPE["KVH"]
    out = {}
    for name in VARIANTS:
        q, k, v, ks, vs, ptab, base = _verify_batch(name, VERIFY_BASES,
                                                    VERIFY_G)
        kw = {"k_scale": ks, "v_scale": vs}
        ker = pa.paged_verify_attention(q, k, v, ptab, base, **kw)
        torch.cuda.synchronize()
        ref = pa.paged_verify_reference(q, k, v, ptab, base, **kw)
        atol, rtol = TOL[VARIANTS[name][1]]
        max_err = float((ker.float() - ref.float()).abs().max())
        if not torch.allclose(ker.float(), ref.float(), atol=atol, rtol=rtol):
            fail(f"pa_verify vs plain ({name}): max |err| {max_err}")
        # (b) G = 1 at base is pa_decode at base + 1, both kernels
        q1 = q[:, :, :1].contiguous()
        ver1 = pa.paged_verify_attention(q1, k, v, ptab, base, **kw)
        dec = pa.paged_attention(q1[:, :, 0].contiguous(), k, v, ptab,
                                 base + 1, **kw)
        torch.cuda.synchronize()
        g1_err = float((ver1[:, :, 0].float() - dec.float()).abs().max())
        if not torch.allclose(ver1[:, :, 0].float(), dec.float(), atol=atol,
                              rtol=rtol):
            fail(f"pa_verify G=1 vs pa_decode ({name}): max |err| {g1_err}")
        ms = cuda_ms(lambda: pa.paged_verify_attention(q, k, v, ptab, base,
                                                       **kw), reps=50)
        plain_ms = cuda_ms(lambda: pa.paged_verify_reference(
            q, k, v, ptab, base, **kw), reps=5, warmup=1)
        ncols = int(base.max()) + VERIFY_G
        slots = torch.arange(len(VERIFY_BASES), device="cuda")
        kd = _dense_kv(k, ks, ptab, slots, ncols, grp, q.dtype)
        vd = _dense_kv(v, vs, ptab, slots, ncols, grp, q.dtype)
        limit = base[:, None] + torch.arange(VERIFY_G, device="cuda") + 1
        mask = (torch.arange(ncols, device="cuda")[None, None]
                < limit[:, :, None])[:, None]             # (B, 1, G, cols)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask), reps=20)
        bound_ms, bound_by, nbytes, flops = _verify_bound(name, VERIFY_BASES,
                                                          VERIFY_G)
        kname = "paged_verify_int8" if VARIANTS[name][0] == "int8" \
            else "paged_verify"
        row = {"phase": "spec_kernel", "kernel": kname, "card": card,
               "variant": name, "pools": VARIANTS[name][0],
               "q_dtype": VARIANTS[name][1], "base_lengths":
               list(VERIFY_BASES), "G": VERIFY_G, **DECODE_SHAPE,
               "blocks": len(VERIFY_BASES) * DECODE_SHAPE["KVH"],
               "atol": atol, "rtol": rtol, "max_abs_err": max_err,
               "g1_vs_pa_decode_max_abs_err": g1_err,
               "kernel_ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library_call": "sdpa over the slots' KV gathered dense, "
                               "each row masked to base + g + 1",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_bytes": nbytes, "bound_flops": flops, "tf32": False}
        emit(row)
        out[name] = row
        del q, k, v, ks, vs, ker, ref, kd, vd, ver1, dec
        torch.cuda.empty_cache()
    emit({"phase": "spec_kernel", "part": "verify shapes", "card": card,
          "cases": [list(c) for c in VERIFY_CASES], "head_dims": [64, 128],
          "pages": [8, 16], "variants": list(VARIANTS), "tol": TOL,
          "max_abs_err": _verify_flavors()})
    return out


# the spec engines: name -> engine arguments
SPEC_ENGINES = {"bucketed": {"ragged": False, "spec_decode": 4},
                "chunked": {"ragged": False, "spec_decode": 4,
                            "chunked_prefill": True},
                "ragged": {"spec_decode": 4}}
SPEC_PARITY_LENS = (17, 45, 90, 150)
# new tokens a spec_parity request: the depth-2 random model falls into
# repeats (which prompt lookup drafts from) only after 16-30 tokens
SPEC_PARITY_NEW = 32


def _want_spec_counts(ragged, layers, calls, steps, int8):
    """The launches of a spec run: the ragged kernel per layer and step
    on the ragged engine; else pa_verify (its int8 variant with int8
    pools) per layer and step, va_fwd per layer and admission wave,
    fa_fwd per layer and lone prefill (none with chunked prefill), no
    decode kernel."""
    want = {k: 0 for k in _bucket_counts()}
    if ragged:
        want["ragged_paged_attention"] = layers * steps
        return want
    want["paged_verify_int8" if int8 else "paged_verify"] = layers * steps
    want["varlen_fwd"] = layers * calls["waves"]
    want["flash_fwd"] = layers * calls["singles"]
    return want


def phase_spec_parity(card):
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.models.llama_spmd import init_params
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=2)
    cpu_params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gpu_params = _tree_to(cpu_params, "cuda")
    prompts = _motif_prompts(np.random.default_rng(1), cfg.vocab_size,
                             SPEC_PARITY_LENS)
    L = cfg.num_hidden_layers
    runs = {}
    for engine, ekw in SPEC_ENGINES.items():
        for cache in (None, "int8"):
            results, info = {}, {}
            for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
                # all four requests at once: the CPU engine's steps are
                # most of the phase's time
                eng = ServingEngine(params, cfg, max_seqs=4, max_seq_len=512,
                                    page_size=16, ragged_tokens=16,
                                    cache_dtype=cache, device=dev, **ekw)
                for i, p in enumerate(prompts):
                    eng.submit(Request(i, p, max_new_tokens=SPEC_PARITY_NEW))
                t0 = time.perf_counter()
                done, calls, launches = _bucket_run(eng, pipelined=False)
                if dev == "cuda":
                    torch.cuda.synchronize()
                info[dev] = {"seconds": time.perf_counter() - t0,
                             "device_steps": eng.device_steps,
                             "calls": calls, "launches": launches,
                             "spec_drafted": eng.spec_drafted,
                             "spec_accepted": eng.spec_accepted}
                if len(done) != 4 or not eng.pool.conserved(drained=True):
                    fail(f"spec_parity ({engine}, {dev}): {len(done)} of 4 "
                         "finished or pool leaked")
                if eng.spec_drafted == 0:
                    fail(f"spec_parity ({engine}, {dev}): nothing drafted")
                results[dev] = {r.rid: list(r.output) for r in done}
            g = info["cuda"]
            want = _want_spec_counts(engine == "ragged", L, g["calls"],
                                     g["device_steps"], cache == "int8")
            if g["launches"] != want:
                fail(f"spec_parity ({engine}): launches {g['launches']}, "
                     f"want {want}")
            if engine != "bucketed" and g["calls"] != {"waves": 0,
                                                       "singles": 0}:
                fail(f"spec_parity ({engine}): prefill calls {g['calls']}")
            if any(info["cpu"]["launches"].values()):
                fail(f"spec_parity ({engine}): the CPU engine launched a "
                     "CUDA kernel")
            compared = {}
            for rid, p in enumerate(prompts):
                a, b = results["cuda"][rid], results["cpu"][rid]
                j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         None)
                if j is None and len(a) == len(b):
                    compared[rid] = {"identical": len(a), "stopped_at": None}
                    continue
                if j is None:
                    fail(f"spec_parity ({engine}): request {rid} lengths "
                         f"{len(a)} / {len(b)}")
                margin = _top2_margin(cpu_params, cfg, p + b[:j], 16)
                if margin >= 1e-3:
                    fail(f"spec_parity ({engine}): request {rid} diverges at "
                         f"token {j} with CPU top-2 margin {margin}")
                compared[rid] = {"identical": j, "stopped_at": j,
                                 "cpu_top2_margin": margin}
            name = f"{engine}_{'fp32' if cache is None else 'int8'}"
            row = {"phase": "spec_parity", "card": card, "run": name,
                   "engine": ekw, "config": "llama3_8b widths, 2 layers, "
                   "fp32, TF32 off, max_seqs 4, run()",
                   "prompt_lens": list(SPEC_PARITY_LENS),
                   "new_tokens": SPEC_PARITY_NEW,
                   "requests": compared, "prefill_calls": g["calls"],
                   "launches": g["launches"],
                   "device_steps": g["device_steps"],
                   "spec_drafted": g["spec_drafted"],
                   "spec_accepted": g["spec_accepted"],
                   "cuda_seconds": g["seconds"],
                   "cpu_seconds": info["cpu"]["seconds"]}
            emit(row)
            runs[name] = row
    del gpu_params
    torch.cuda.empty_cache()
    return runs


# the spec_serve runs: name -> (engine arguments, pool)
SPEC_SERVE = {
    "bucketed_g4_bf16": ({"ragged": False, "spec_decode": 4}, None),
    "bucketed_g4_int8": ({"ragged": False, "spec_decode": 4}, "int8"),
    "chunked_g16_bf16": ({"ragged": False, "spec_decode": 16,
                          "chunked_prefill": True}, None),
    "ragged_g4_bf16": ({"ragged": True, "spec_decode": 4,
                        "ragged_tokens": None}, None)}


def phase_spec_serve(card, cfg, params, init_s, bserve):
    import torch
    prompts = echo_prompts(cfg, params)
    runs = {}
    for name, (ekw, cache) in SPEC_SERVE.items():
        eng, reqs = serve_engine(cfg, params, cache, prompts=prompts, **ekw)
        lens = [len(r.prompt) for r in reqs]
        steps, prefills = [], []
        spec_step = eng._spec_step

        def timed_step(_step=spec_step, _eng=eng):
            pre = any(_eng._prefilling(_eng._slots[s]) for s in _eng._live)
            a = time.perf_counter()
            n = _step()
            steps.append((a, time.perf_counter(), pre))
            return n
        eng._spec_step = timed_step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done, calls, launches = _bucket_run(eng, pipelined=False,
                                            marks=prefills)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(done) != 8:
            fail(f"spec_serve ({name}): {len(done)} of 8 requests finished")
        for r in done:
            if len(r.output) != 64:
                fail(f"spec_serve ({name}): request {r.rid} has "
                     f"{len(r.output)} tokens, want 64")
            if not all(0 <= t < cfg.vocab_size for t in r.output):
                fail(f"spec_serve ({name}): request {r.rid} left the "
                     "vocabulary")
        want = _want_spec_counts(ekw["ragged"], cfg.num_hidden_layers, calls,
                                 eng.device_steps, cache == "int8")
        if launches != want:
            fail(f"spec_serve ({name}): launches {launches}, want {want}")
        if not eng.pool.conserved(drained=True):
            fail(f"spec_serve ({name}): page pool not conserved")
        if eng.spec_drafted == 0:
            fail(f"spec_serve ({name}): nothing drafted")
        # a step that fed no prompt chunk is a pure verify step; the
        # prefill ends with the last admission prefill or chunk fed
        verify = [b - a for a, b, pre in steps if not pre]
        last_prefill = max(prefills + [b for _, b, pre in steps if pre],
                           default=t0)
        plain = bserve.get("int8" if cache else "bf16", {})
        row = {"phase": "spec_serve", "card": card, "run": name,
               "engine": {k: v for k, v in ekw.items()}, "pool":
               "int8" if cache else "bf16",
               "config": SERVE_CONFIG + ", echo prompts (`echo_prompts`)",
               "prompt_lens": lens, "new_tokens": 64, "sampled": [0, 1],
               "wall_s": wall, "device_steps": eng.device_steps,
               "verify_steps": len(verify), "prefill_calls": calls,
               "prefill_tokens": eng.prefill_tokens,
               "prefill_tok_s": eng.prefill_tokens / (last_prefill - t0),
               "verify_step_ms_median": (statistics.median(verify) * 1e3
                                         if verify else None),
               "output_tok_s": 8 * 64 / wall,
               "spec_drafted": eng.spec_drafted,
               "spec_accepted": eng.spec_accepted,
               "accept_rate": eng.spec_accepted / eng.spec_drafted,
               "logit_rows": eng.logit_rows, "launches": launches,
               "bucket_serve_plain": {
                   k: plain.get(k) for k in (
                       "output_tok_s", "decode_step_ms_median",
                       "prefill_tok_s", "device_steps")},
               "params_init_s": init_s}
        emit(row)
        runs[name] = row
        del eng
        torch.cuda.empty_cache()
    return runs


# ------------------------------------------------------- varlen training
VARLEN_BWD_KERNELS = tuple(VARLEN_BWD_TPU_KERNELS)
# the packed row of train_packed in the varlen layout: q (T, H, D), k and
# v (T, KVH, D), as Llama-3-8B's projections give them
VARLEN_TRAIN_ATTN = {"T": 8192, "H": 32, "KVH": 8, "D": 128}
# the correctness cases of the backward: the forward's, and a key
# segment that no query has
VARLEN_BWD_CASES = VARLEN_CASES + ("unseen_keys",)


def _varlen_counts():
    """Launches of the three varlen kernels, by kernel name."""
    import paddle_tpu_torch.ops.varlen_attention as va
    return {"varlen_fwd": va.launches_fwd, "varlen_bwd_dq": va.launches_dq,
            "varlen_bwd_dkv": va.launches_dkv}


def _reset_varlen_counts():
    import paddle_tpu_torch.ops.varlen_attention as va
    va.launches_fwd = va.launches_dq = va.launches_dkv = 0


def _varlen_bwd_bound(kname, dname, lens, t, h, kvh, d):
    """Least time for one backward kernel on a packed row: 6 (dQ) or 8
    (dK/dV) flops per kept pair and head dim over the peak for the dtype,
    or each operand byte once over the memory rate: q and dO (T, H, D),
    k and v (T, KVH, D), lse and delta (H, T) fp32 and the segment ids
    and distances (4 x T int32) read; dQ (T, H, D), or dK and dV (T, KVH,
    D), written."""
    elem = 4 if dname == "float32" else 2
    big_q, big_k = t * h * d * elem, t * kvh * d * elem
    out = big_q if kname == "varlen_bwd_dq" else 2 * big_k
    nbytes = 2 * big_q + 2 * big_k + 2 * h * t * 4 + 4 * t * 4 + out
    pairs = h * sum(n * (n + 1) // 2 for n in lens)
    flops = (6 if kname == "varlen_bwd_dq" else 8) * d * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def _varlen_operands(dname, t, h, kvh, d, seed, device="cuda"):
    """q, dO (t, h, d) and k, v (t, kvh, d) from a seeded generator."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    dt = getattr(torch, dname)
    q, do = (torch.randn((t, h, d), generator=g, device=device).to(dt)
             for _ in range(2))
    k, v = (torch.randn((t, kvh, d), generator=g, device=device).to(dt)
            for _ in range(2))
    return q, k, v, do


def _profiled_ms(fn, names, reps=10):
    """Device time of one call of fn spent in the kernels whose names
    hold one of `names`, from torch.profiler over `reps` calls after a
    warm-up; None when the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if any(n in e.key for n in names):
            dev = getattr(e, "self_device_time_total", None)
            us += dev if dev is not None else e.self_cuda_time_total
    return us / 1e3 / reps if us else None


def _varlen_bwd_plain(q, k, v, do, seg_q, seg_k, causal, scale):
    """(o, lse, delta, dq, dk, dv) of the plain versions."""
    import paddle_tpu_torch.ops.varlen_attention as va
    o, lse = va.varlen_fwd_reference(q, k, v, seg_q, seg_k, causal, scale)
    delta = (do.float() * o.float()).sum(-1).T.contiguous()
    sq, sk = va._sentinels(seg_q, seg_k)
    args = (q, k, v, do, lse, delta, sq, sk, causal, scale)
    return (o, lse, delta, va.varlen_bwd_dq_reference(*args),
            *va.varlen_bwd_dkv_reference(*args))


def _varlen_bwd_flavors():
    """Correctness only: every case of VARLEN_BWD_CASES, GQA groups 1 and
    4, D = 64 and 128, bf16 and fp32; rows that see nothing get dQ = 0,
    keys nobody sees dK = dV = 0. Returns the max |error| of each."""
    import torch
    import paddle_tpu_torch.ops.varlen_attention as va
    errs = {}
    for name in VARLEN_BWD_CASES:
        for h, kvh in ((8, 8), (8, 2)):
            for d in (64, 128):
                for dname in ("bfloat16", "float32"):
                    q, k, v, sq, sk, causal, same = _varlen_case(
                        name, dname, h, kvh, d, seed=d + kvh)
                    do = torch.randn_like(q)
                    scale = 1.0 / math.sqrt(d)
                    _, lse, delta, *want = _varlen_bwd_plain(
                        q, k, v, do, sq, sk, causal, scale)
                    sqs, sks = va._sentinels(sq, sk)
                    args = (q, k, v, do, lse, delta, sqs, sks, causal, scale,
                            same)
                    dq = va._launch_bwd_dq(*args)
                    dk, dv = va._launch_bwd_dkv(*args)
                    torch.cuda.synchronize()
                    key = f"{name}/g{h // kvh}/d{d}/{dname}"
                    errs[key] = _check_kernels(
                        f"varlen_kernel {key}", dname,
                        {"varlen_bwd_dq": [dq], "varlen_bwd_dkv": [dk, dv]},
                        {"varlen_bwd_dq": want[:1],
                         "varlen_bwd_dkv": want[1:]}, lse, lse)
                    dead_q, dead_k = sqs < 0, sks < 0
                    if name in ("masked_rows", "unseen_keys"):
                        dead_q = dead_q | (sqs == 1)
                    if name == "unseen_keys":
                        dead_k = dead_k | (sks == 3)
                    if not (bool((dq[dead_q] == 0).all())
                            and bool((dk[dead_k] == 0).all())
                            and bool((dv[dead_k] == 0).all())):
                        fail(f"varlen_kernel {key}: a row or key that sees "
                             "nothing has a gradient")
                    del errs[key]["lse"]
    return errs


def phase_varlen_kernel(card):
    import numpy as np
    import torch
    import paddle_tpu_torch.ops.flashmask_attention as fm
    import paddle_tpu_torch.ops.varlen_attention as va
    from paddle_tpu_torch.models.llama_spmd import doc_end_indices
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t, h, kvh, d = (VARLEN_TRAIN_ATTN[x] for x in ("T", "H", "KVH", "D"))
    lens = PACKED_DOCS
    seg_np = _segments(lens, t)
    want_tiles, causal_tiles = _varlen_tiles(seg_np, seg_np, True)
    seg = torch.from_numpy(seg_np).cuda()
    sq, sk = va._sentinels(seg, seg)
    sri = doc_end_indices(torch.from_numpy(seg_np[None]).cuda())
    scale = 1.0 / math.sqrt(d)
    m = fm._Mask(True, None, scale, 0.0, None)
    grp = h // kvh
    out = {}
    for dname in ("bfloat16", "float32"):
        q, k, v, do = _varlen_operands(dname, t, h, kvh, d, seed=0)
        o_ref, lse, delta, *want = _varlen_bwd_plain(q, k, v, do, seg, seg,
                                                     True, scale)
        args = (q, k, v, do, lse, delta, sq, sk, True, scale, True)
        dq, n_dq = va._launch_bwd_dq(*args, count_tiles=True)
        dk, dv, n_dkv = va._launch_bwd_dkv(*args, count_tiles=True)
        torch.cuda.synchronize()
        # no lse here: the kernels read the plain forward's
        errs = _check_kernels(
            "varlen_kernel", dname,
            {"varlen_bwd_dq": [dq], "varlen_bwd_dkv": [dk, dv]},
            {"varlen_bwd_dq": want[:1], "varlen_bwd_dkv": want[1:]},
            lse, lse)
        o, lse_k, n_fwd = va._launch_fwd(q, k, v, sq, sk, True, scale, True,
                                         count_tiles=True)
        torch.cuda.synchronize()
        errs.update(_check_kernels(
            "varlen_kernel", dname, {"varlen_fwd": [o]},
            {"varlen_fwd": [o_ref]}, lse_k, lse))
        for kname, n in (("varlen_fwd", n_fwd), ("varlen_bwd_dq", n_dq),
                         ("varlen_bwd_dkv", n_dkv)):
            if n != want_tiles * h:
                fail(f"{kname} ({dname}): computed {n} tiles, the skip rule "
                     f"gives {want_tiles} x {h} heads")
        del dq, dk, dv, want, o, lse_k
        kernel_ms = {
            "varlen_fwd": cuda_ms(lambda: va._launch_fwd(
                q, k, v, sq, sk, True, scale, True), reps=10),
            "varlen_bwd_dq": cuda_ms(lambda: va._launch_bwd_dq(*args),
                                     reps=10),
            "varlen_bwd_dkv": cuda_ms(lambda: va._launch_bwd_dkv(*args),
                                      reps=10)}
        # the kernels alone: the wrappers' times above also hold
        # va_positions and the tile ranges
        kernel_only_ms = {
            "varlen_bwd_dq": _profiled_ms(lambda: va._launch_bwd_dq(*args),
                                          ("dq_tc_kernel", "va_dq_kernel")),
            "varlen_bwd_dkv": _profiled_ms(
                lambda: va._launch_bwd_dkv(*args),
                ("dkv_tc_kernel", "va_dkv_kernel"))}
        plain_ms = {
            "varlen_fwd": cuda_ms(lambda: va.varlen_fwd_reference(
                q, k, v, seg, seg, True, scale), reps=3, warmup=1),
            "varlen_bwd_dq": cuda_ms(lambda: va.varlen_bwd_dq_reference(
                *args[:-1]), reps=3, warmup=1),
            "varlen_bwd_dkv": cuda_ms(lambda: va.varlen_bwd_dkv_reference(
                *args[:-1]), reps=3, warmup=1)}
        # (1, H, T, D) copies, K/V repeated to the query heads, for SDPA
        # and the FlashMask yardstick; made beforehand and not timed
        qb, dob = (x.transpose(0, 1)[None].contiguous() for x in (q, do))
        kb, vb = (x.repeat_interleave(grp, dim=1).transpose(0, 1)[None]
                  .contiguous() for x in (k, v))
        lib_fwd, lib_fwd_bwd = _doc_sdpa(qb, kb, vb, dob, lens)
        lib_fwd_ms = cuda_ms(lib_fwd, reps=10)
        library_ms = {"varlen_fwd": lib_fwd_ms}
        library_ms["varlen_bwd_dq"] = library_ms["varlen_bwd_dkv"] = \
            cuda_ms(lib_fwd_bwd, reps=10) - lib_fwd_ms
        fm_args = (qb, kb, vb, sri, dob, lse[None], delta[None], m)
        flashmask_ms = {
            "varlen_fwd": cuda_ms(lambda: fm._launch_fwd(qb, kb, vb, sri, m),
                                  reps=10),
            "varlen_bwd_dq": cuda_ms(lambda: fm._launch_dq(*fm_args),
                                     reps=10),
            "varlen_bwd_dkv": cuda_ms(lambda: fm._launch_dkv(*fm_args),
                                      reps=10)}
        for kname in ("varlen_fwd",) + VARLEN_BWD_KERNELS:
            bound_ms, bound_by, nbytes, flops = (
                _varlen_bound(dname, lens, t, h, kvh, d)
                if kname == "varlen_fwd" else
                _varlen_bwd_bound(kname, dname, lens, t, h, kvh, d))
            row = {"phase": "varlen_kernel", "card": card, "kernel": kname,
                   "dtype": dname, "T": t, "H": h, "KVH": kvh, "D": d,
                   "documents": list(lens), "causal": True,
                   "same_offsets": True,
                   "tiles_computed_per_head": want_tiles,
                   "tiles_causal_per_head": causal_tiles,
                   "kept_pairs_per_head": sum(n * (n + 1) // 2 for n in lens),
                   "atol": TOL[dname][0], "rtol": TOL[dname][1],
                   "max_abs_err": errs[kname], "kernel_ms": kernel_ms[kname],
                   "plain_ms": plain_ms[kname],
                   "library_ms": library_ms[kname],
                   "library_call": "sdpa forward per document, summed"
                   if kname == "varlen_fwd" else
                   "sdpa backward per document (dQ, dK, dV), summed",
                   "flashmask_ms": flashmask_ms[kname],
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_bytes": nbytes, "bound_flops": flops,
                   "tflops": flops / kernel_ms[kname] / 1e9, "tf32": False}
            if kname == "varlen_fwd":
                row["lse_max_abs_err"] = errs["lse"]
            else:
                row["kernel_only_ms"] = kernel_only_ms[kname]
            if kname == "varlen_bwd_dkv":   # the pair against SDPA and FM
                pair = (kernel_ms["varlen_bwd_dq"]
                        + kernel_ms["varlen_bwd_dkv"])
                row["pair_library_factor"] = pair / library_ms[kname]
                row["pair_flashmask_factor"] = pair / (
                    flashmask_ms["varlen_bwd_dq"]
                    + flashmask_ms["varlen_bwd_dkv"])
            emit(_design_row(row, kname, dname))
            out[(kname, dname)] = row
        del q, k, v, do, qb, kb, vb, dob, args, fm_args, lib_fwd, lib_fwd_bwd
        del o_ref, lse, delta
        torch.cuda.empty_cache()
    emit({"phase": "varlen_kernel", "part": "flavors", "card": card,
          "cases": list(VARLEN_BWD_CASES), "groups": [1, 4],
          "head_dims": [64, 128], "tol": TOL,
          "max_abs_err": _varlen_bwd_flavors()})
    # (c) the main path: autograd through flash_attn_unpadded, bf16
    q, k, v, do = _varlen_operands("bfloat16", t, h, kvh, d, seed=1)
    cu = torch.tensor([0, *np.cumsum(lens)], dtype=torch.int32,
                      device="cuda")
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    _reset_varlen_counts()
    o, _ = va.flash_attn_unpadded(*leaves, cu, cu, causal=True)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    launches = _varlen_counts()
    want_launches = dict.fromkeys(launches, 1)
    if launches != want_launches:
        fail(f"varlen_kernel autograd: launches {launches}, want "
             f"{want_launches}")
    o_ref, lse, _, *want = _varlen_bwd_plain(q, k, v, do, seg, seg, True,
                                             scale)
    errs = _check_kernels(
        "varlen_kernel autograd", "bfloat16",
        {"varlen_fwd": [o.detach()], "varlen_bwd_dq": grads[:1],
         "varlen_bwd_dkv": list(grads[1:])},
        {"varlen_fwd": [o_ref], "varlen_bwd_dq": want[:1],
         "varlen_bwd_dkv": want[1:]}, lse, lse)
    del errs["lse"]
    emit({"phase": "varlen_kernel", "part": "autograd", "card": card,
          "call": "flash_attn_unpadded(causal=True), torch.autograd.grad",
          "dtype": "bfloat16", "documents": list(lens), "launches": launches,
          "max_abs_err": errs})
    out["launches"] = launches
    del q, k, v, do, leaves, o, grads, o_ref, want
    torch.cuda.empty_cache()
    return out


# a vocabulary of two 8192-column chunks of the fused head, the second
# short
FUSED_PARITY_VOCAB = 12000


def phase_fused_parity(card):
    cfg = dataclasses.replace(_parity_config(),
                              vocab_size=FUSED_PARITY_VOCAB)
    batch = _packed_batch(cfg.vocab_size, PACKED_PARITY_ROWS, seed=3)
    runs = {}
    for name, kw in (("fused_ce", {"fused_ce": True}),
                     ("dots", {"remat": "dots"})):
        runs[name] = _step_parity(f"fused_parity ({name})", cfg, batch, 2,
                                  3e-4, "flashmask", **kw)
    # the card's losses through the fused head against those through the
    # full logits (the dots run), the same limits as card against CPU
    fused, full = runs["fused_ce"]["losses_cuda"], runs["dots"]["losses_cuda"]
    if any(abs(a - c) > 1e-5 * abs(c) + 1e-5 for a, c in zip(fused, full)):
        fail(f"fused_parity: fused losses {fused} vs full logits {full}")
    emit({"phase": "fused_parity", "card": card,
          "config": f"llama3_8b widths, 1 layer, vocab {cfg.vocab_size}, "
                    "fp32, TF32 off, batch 2 x 512 packed: documents "
                    f"{list(map(list, PACKED_PARITY_ROWS))}",
          "runs": {"fused_ce=True, remat=True": runs["fused_ce"],
                   "fused_ce=False, remat='dots'": runs["dots"]},
          "fused_vs_full_logits_loss_abs_err":
              [abs(a - c) for a, c in zip(fused, full)]})


TRAIN_FUSED_CONFIG = TRAIN_PACKED_CONFIG.replace(
    "remat,", "remat='dots', fused_ce=True,")
# bf16: the fused head's logits are fp32 sums of exact bf16 products,
# the full head's are rounded to bf16 (about 2^-9 of each logit); the
# mean NLL of 8184 tokens near 12.6 moves by far less than 2e-3 of it
FIRST_LOSS_RTOL = 2e-3


def phase_train_fused(card, packed):
    import torch
    from paddle_tpu_torch.models import llama_spmd as T
    # the full-logits first loss of the same seed weights and batch
    # (train_packed's first loss), built again: train_packed updates its
    # weights in place
    cfg, params, _, batch, _ = train_packed_setup()
    with torch.no_grad():
        ref = float(T.loss_fn(params, batch, cfg, remat=False))
    del params, batch
    torch.cuda.empty_cache()
    row = _train_run(card, "train_fused", TRAIN_FUSED_CONFIG,
                     lambda: train_packed_setup("dots", True), "flashmask")
    first = row["losses"][0]
    if not abs(first - ref) <= FIRST_LOSS_RTOL * abs(ref):
        fail(f"train_fused: first loss {first}, full logits {ref}")
    emit({"phase": "train_fused", "card": card, "part": "against train_packed",
          "first_loss": first, "first_loss_full_logits": ref,
          "rtol": FIRST_LOSS_RTOL,
          "train_packed_first_loss": packed["losses"][0] if packed else None,
          "median_step_ms": row["median_step_ms"],
          "train_packed_median_step_ms":
              packed["median_step_ms"] if packed else None,
          "max_memory_allocated_gb": row["max_memory_allocated_gb"],
          "train_packed_max_memory_allocated_gb":
              packed["max_memory_allocated_gb"] if packed else None})
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    secs = {}                # wall seconds of each phase run

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[phase] = time.perf_counter() - t0
        return out

    smi, name = timed("device", phase_device)
    if "build" in phases:
        timed("build", phase_build, smi)
    kern = timed("kernel", phase_kernel, smi) if "kernel" in phases else {}
    if "parity" in phases:
        timed("parity", phase_parity, smi)
    serve, bserve, sserve = {}, {}, {}
    if {"serve", "bucket_serve", "spec_serve"} & set(phases):
        # the 8B parameters, built once for the three serve phases
        t0 = time.perf_counter()
        cfg, params = serve_params()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if "serve" in phases:
            serve = timed("serve", phase_serve, smi, cfg, params, init_s)
        if "bucket_serve" in phases:
            bserve = timed("bucket_serve", phase_bucket_serve, smi, cfg,
                           params, init_s)
        if "spec_serve" in phases:
            sserve = timed("spec_serve", phase_spec_serve, smi, cfg, params,
                           init_s, bserve)
        del params
        torch.cuda.empty_cache()
    tk = timed("train_kernel", phase_train_kernel, smi) \
        if "train_kernel" in phases else {}
    if "train_parity" in phases:
        timed("train_parity", phase_train_parity, smi)
    train = timed("train", phase_train, smi) if "train" in phases else {}
    mk = timed("mask_kernel", phase_mask_kernel, smi) \
        if "mask_kernel" in phases else {}
    if "packed_parity" in phases:
        timed("packed_parity", phase_packed_parity, smi)
    packed = timed("train_packed", phase_train_packed, smi) \
        if "train_packed" in phases else {}
    bk = timed("bucket_kernel", phase_bucket_kernel, smi) \
        if "bucket_kernel" in phases else {}
    if "bucket_parity" in phases:
        timed("bucket_parity", phase_bucket_parity, smi)
    sk = timed("spec_kernel", phase_spec_kernel, smi) \
        if "spec_kernel" in phases else {}
    if "spec_parity" in phases:
        timed("spec_parity", phase_spec_parity, smi)
    vk = timed("varlen_kernel", phase_varlen_kernel, smi) \
        if "varlen_kernel" in phases else {}
    if "fused_parity" in phases:
        timed("fused_parity", phase_fused_parity, smi)
    if "train_fused" in phases:
        timed("train_fused", phase_train_fused, smi, packed)
    emit({"phase_seconds": secs})
    kernels = []
    for kname, pools, run in (("ragged_paged_attention", "bfloat16", "bf16"),
                              ("ragged_paged_attention_int8", "int8",
                               "int8")):
        k = kern.get(pools)
        if k is None:
            continue
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": TPU_KERNEL,
            "launches": serve[run]["launches"] if run in serve else None,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    for kname in FLASH_KERNELS:
        k = tk.get((kname, "bfloat16"))
        if k is None:
            continue
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_TPU_KERNELS[kname],
            "launches": train["launches"][kname] if train else None,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    for kname in FLASHMASK_KERNELS:
        k = mk.get((kname, "bfloat16"))
        if k is None:
            continue
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flashmask_attention.cu",
            "replaces": FLASHMASK_TPU_KERNELS[kname],
            "launches": packed["launches"][kname] if packed else None,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    for kname, (src, tpu, row, run) in BUCKET_KERNELS.items():
        k = bk.get(row)
        if k is None:
            continue
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{src}.cu", "replaces": tpu,
            "launches": bserve[run]["launches"][kname] if run in bserve
            else None,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    for kname, (tpu, row, run) in SPEC_KERNELS.items():
        k = sk.get(row)
        if k is None:
            continue
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": tpu,
            "launches": sserve[run]["launches"][kname] if run in sserve
            else None,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    for kname in VARLEN_BWD_KERNELS:
        k = vk.get((kname, "bfloat16"))
        if k is None:
            continue
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/varlen_attention.cu",
            "replaces": VARLEN_BWD_TPU_KERNELS[kname],
            "launches": vk["launches"][kname],
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
