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
               source, all started together;
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
               yardstick only;
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
               that are finite and fall.

The line before the last lists every kernel with its launches on the
main path, its error against the plain version and its times; the last
line is {"ok": true, "device": {...}}.
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
          "train_parity", "train")
SOURCES = ("ragged_paged_attention", "flash_attention")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 CUDA cores; bf16 dense
TPU_KERNEL = "paddle_tpu/kernels/ragged_paged_attention.py:185"
FLASH_TPU_KERNELS = {"flash_fwd": "paddle_tpu/ops/flash_attention.py:107",
                     "flash_bwd_dq": "paddle_tpu/ops/flash_attention.py:220",
                     "flash_bwd_dkv": "paddle_tpu/ops/flash_attention.py:277"}


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


def phase_build(card):
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:   # one nvcc per source
        secs = dict(zip(SOURCES, ex.map(_build.build, SOURCES)))
    wall = time.perf_counter() - t0
    for name in SOURCES:
        ptxas = [ln.strip() for ln in _build.ptxas_report(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "card": card, "seconds": secs[name],
              "wall_seconds_all_sources": wall,
              "source": str(_build.lib_path(name).name), "ptxas": ptxas})


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


def serve_engine(cfg, params, cache_dtype, new_tokens=64):
    """The serve phase's engine with its 8 requests submitted: prompts
    of 64-1500 tokens (numpy seed 2), requests 0 and 1 sampled
    (temperature 0.8, top_k 50, seed = rid), the rest greedy. Returns
    (engine, requests)."""
    import numpy as np
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    rng = np.random.default_rng(2)
    lens = rng.integers(64, 1501, 8).tolist()
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    eng = ServingEngine(params, cfg, max_seqs=8, max_seq_len=2048,
                        page_size=16, ragged_tokens=256,
                        cache_dtype=cache_dtype, device="cuda")
    reqs = [Request(i, p, max_new_tokens=new_tokens,
                    **({"temperature": 0.8, "top_k": 50, "seed": i}
                       if i < 2 else {}))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return eng, reqs


def phase_serve(card):
    import torch
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    t0 = time.perf_counter()
    cfg, params = serve_params()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
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
# Kernel vs plain, by dtype, as TOL above: both compute in fp32 from the
# same operands and sum in another order; bf16 outputs round the same
# fp32 value, one ulp apart at most. lse is fp32 on both sides.
LSE_TOL = (1e-5, 1e-5)


def _flash_counts():
    import paddle_tpu_torch.ops.flash_attention as fa
    return {"flash_fwd": fa.launches_fwd, "flash_bwd_dq": fa.launches_dq,
            "flash_bwd_dkv": fa.launches_dkv}


def _reset_flash_counts():
    import paddle_tpu_torch.ops.flash_attention as fa
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0


def _flash_bound(kernel, dtype, b, h, s, d):
    """Least time for one causal call: flops over the causal pairs
    (4, 6, 8 flops per pair and head dim: QK^T and PV; S, dP and dQ; S,
    dP, dV and dK) over the peak for the dtype, or each operand byte
    once over the memory rate."""
    pairs = s * (s + 1) // 2
    flops = {"flash_fwd": 4, "flash_bwd_dq": 6,
             "flash_bwd_dkv": 8}[kernel] * b * h * d * pairs
    big = b * h * s * d * (4 if dtype == "float32" else 2)
    vec = b * h * s * 4                                   # lse, delta
    nbytes = {"flash_fwd": 4 * big + vec,       # q k v in, o and lse out
              "flash_bwd_dq": 5 * big + 2 * vec,   # q k v dO lse delta, dQ
              "flash_bwd_dkv": 6 * big + 2 * vec}[kernel]  # ..., dK dV
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
        pairs = {"flash_fwd": [(o, o_ref)], "flash_bwd_dq": [(dq, dq_ref)],
                 "flash_bwd_dkv": [(dk, dk_ref), (dv, dv_ref)]}
        if not torch.allclose(lse, lse_ref, atol=LSE_TOL[0],
                              rtol=LSE_TOL[1]):
            fail(f"flash_fwd ({dname}): lse off by "
                 f"{float((lse - lse_ref).abs().max())}")
        errs = {}
        for kname, ps in pairs.items():
            errs[kname] = max(float((a.float() - r.float()).abs().max())
                              for a, r in ps)
            if not all(torch.allclose(a.float(), r.float(), atol=atol,
                                      rtol=rtol) for a, r in ps):
                fail(f"{kname} ({dname}) vs plain: max |err| {errs[kname]}")
        lse_err = float((lse - lse_ref).abs().max())
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
            bound_ms, bound_by, nbytes, flops = _flash_bound(
                kname, dname, b, h, s, d)
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
            emit(row)
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


def phase_train_parity(card):
    import torch
    from paddle_tpu_torch.models import llama_spmd as T
    from paddle_tpu_torch.models.llama import LlamaConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=1,
                              vocab_size=4096)
    b, s, steps, lr = 1, 512, 2, 3e-4
    ids, labels = _train_batch(cfg.vocab_size, b, s, seed=3)
    cpu_params = T.init_params(cfg, seed=0, dtype=torch.float32,
                               device="cpu")
    res = {}
    for dev in ("cuda", "cpu"):
        params = _tree_to(cpu_params, dev)
        opt = T.init_opt_state(params)
        batch = (torch.from_numpy(ids).to(dev),
                 torch.from_numpy(labels).to(dev))
        _, grads = T.loss_and_grads(params, batch, cfg, remat=True)
        grads = [g.cpu() for g in T._leaves(grads)]
        step = T.make_train_step(cfg, remat=True, lr=lr, device=dev)
        _reset_flash_counts()
        t0 = time.perf_counter()
        losses = [float(step(params, opt, i, batch)[2]) for i in range(steps)]
        res[dev] = {"losses": losses, "grads": grads,
                    "params": [p.cpu() for p in T._leaves(params)],
                    "launches": _flash_counts(),
                    "seconds": time.perf_counter() - t0}
        del params, opt, batch
    del cpu_params
    torch.cuda.empty_cache()
    L = cfg.num_hidden_layers
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
            "flash_bwd_dkv": L * steps}
    if res["cuda"]["launches"] != want:
        fail(f"train_parity: launches {res['cuda']['launches']}, want {want}")
    if any(res["cpu"]["launches"].values()):
        fail("train_parity: the CPU step launched a CUDA kernel")
    gpu, cpu = res["cuda"], res["cpu"]
    loss_err = [abs(a - c) for a, c in zip(gpu["losses"], cpu["losses"])]
    if any(e > 1e-5 * abs(c) + 1e-5
           for e, c in zip(loss_err, cpu["losses"])):
        fail(f"train_parity: losses {gpu['losses']} vs {cpu['losses']}")
    grad_worst = 0.0        # largest |err| / (allowed |err|)
    for a, c in zip(gpu["grads"], cpu["grads"]):
        allowed = (PARITY_GRAD_RTOL * c.abs()
                   + PARITY_GRAD_SCALE * float(c.abs().max()) + 1e-30)
        grad_worst = max(grad_worst, float(((a - c).abs() / allowed).max()))
    if grad_worst > 1.0:
        fail(f"train_parity: step-1 gradients off, worst {grad_worst} of "
             "the tolerance")
    p_err = max(float((a - c).abs().max())
                for a, c in zip(gpu["params"], cpu["params"]))
    p_rel = max(float((a - c).norm() / c.norm())
                for a, c in zip(gpu["params"], cpu["params"]))
    if p_err > 2.5 * lr * steps or p_rel > 1e-5:
        fail(f"train_parity: parameters off by {p_err} (relative norm "
             f"{p_rel})")
    emit({"phase": "train_parity", "card": card,
          "config": "llama3_8b widths, 1 layer, vocab 4096, fp32, TF32 off, "
                    "remat, batch 1 x 512", "steps": steps,
          "losses_cuda": gpu["losses"], "losses_cpu": cpu["losses"],
          "loss_abs_err": loss_err,
          "grad_worst_share_of_tol": grad_worst,
          "param_max_abs_err": p_err, "param_max_rel_norm_err": p_rel,
          "launches": gpu["launches"], "cuda_seconds": gpu["seconds"],
          "cpu_seconds": cpu["seconds"]})


TRAIN_CONFIG = ("llama3_8b widths, 4 layers, bf16 params, fp32 AdamW state, "
                "remat, random weights (seed 0), batch 2 x 2048")


def train_setup():
    """The train phase's run: Llama-3-8B widths cut to 4 layers, bf16
    random weights from seed 0 on the card, fp32 AdamW state, one fixed
    batch of 2 x 2048 tokens (numpy seed 4), the step with remat on.
    Returns (config, params, opt_state, batch, step)."""
    import torch
    from paddle_tpu_torch.models import llama_spmd as T
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=4)
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    opt = T.init_opt_state(params)
    ids, labels = _train_batch(cfg.vocab_size, 2, 2048, seed=4)
    batch = (torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda())
    return cfg, params, opt, batch, T.make_train_step(cfg, remat=True,
                                                      device="cuda")


def phase_train(card):
    import gc
    import statistics as st
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, params, opt, batch, step = train_setup()
    (b, s), steps = batch[0].shape, 6
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        _, _, loss = step(params, opt, i, batch)
        losses.append(loss.item())          # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    launches = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_hidden_layers
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
            "flash_bwd_dkv": L * steps}
    if launches != want:
        fail(f"train: launches {launches}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train: loss did not fall: {losses}")
    # model flops per token, the strict convention of bench.py: 6 N over
    # the matmul parameters (lm_head once, no embedding gather) plus
    # attention charged at the full (non-causal) 12 L H S
    H, F_, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * (H // cfg.num_attention_heads)
    n_layers = L * (2 * H * H + 2 * H * kv + 3 * H * F_)
    flops_tok = 6 * (n_layers + V * H) + 12 * L * H * s
    step_ms = st.median(times[1:])          # the first step allocates
    tok_s = b * s / (step_ms / 1e3)
    row = {"phase": "train", "card": card, "config": TRAIN_CONFIG,
           "steps": steps, "losses": losses, "step_ms": times,
           "median_step_ms": step_ms, "tokens_per_s": tok_s,
           "model_flops_per_token": flops_tok,
           "model_flops_share_of_989T": flops_tok * tok_s / 989e12,
           "max_memory_allocated_gb": peak / 1e9, "launches": launches,
           "params_and_state_init_s": init_s}
    emit(row)
    del params, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()
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

    smi, name = phase_device()
    if "build" in phases:
        phase_build(smi)
    kern = phase_kernel(smi) if "kernel" in phases else {}
    if "parity" in phases:
        phase_parity(smi)
    serve = phase_serve(smi) if "serve" in phases else {}
    tk = phase_train_kernel(smi) if "train_kernel" in phases else {}
    if "train_parity" in phases:
        phase_train_parity(smi)
    train = phase_train(smi) if "train" in phases else {}
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
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
