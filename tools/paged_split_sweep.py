#!/usr/bin/env python3
"""Time the paged kernels' split rule on one CUDA card.

The tensor-core paged decode and verify kernels
(`paddle_tpu_torch/ops/paged_attention.py`, `paged_tc_kernel` then
`paged_merge_kernel`) split a sequence's columns over blocks by
`split_rule`, from shapes alone. This script times the two kernels alone
(torch.profiler, the median of three `chip_smoke._profiled_ms` readings
of ten calls each, out of at most six: a reading that shows no device
time is dropped) at 8B attention widths (QH 32, KVH 8, D 128, page 16),
bf16 q over bf16 and int8 pages:

  * `width`: chip_smoke.py's decode batch (8 slots of 100-2000 tokens and
    a free one) and verify batch (the 8 slots before a G = 4 chunk) at
    each split width, set through `SPLIT_COLS`, and with no split;
  * `threshold`: batches on both sides of the no-split threshold
    (B x KVH x row tiles against 2 x SMs: decode at 32, 33 and 40 slots,
    verify chunks of G = 16 and 64 at 8 and 9 slots), each timed with the
    rule's choice and with the other one (no split, or splits of
    SPLIT_COLS);
  * `long_cap`: the decode batch in slots of 32768 columns (the rule
    keeps SPLIT_COLS: 86 splits, most of whose blocks exit at once),
    against no split, and of 131072 (MAX_SPLIT_WORKSPACE widens the
    split), against splits of SPLIT_COLS with no budget.

Each reading prints one JSON line (also written to `--out`) with the
split, the grid's blocks, the workspace's bytes and the largest
difference from the rule's output. The card's name and power limit come
first, as nvidia-smi gives them.

    python3 tools/paged_split_sweep.py [--out sweep.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

WIDTHS = (128, 256, 384, 512, 640, 768, 1024)
QH, KVH, D, PAGE = 32, 8, 128, 16


def _operands(variant, lens, g, cap, seed=0):
    """Operands of one call: q (B, QH, D) for decode (g None) or (B, QH,
    G, D) for verify, pages with room for `cap` columns a slot in random
    order, `lens` as lengths or base lengths."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.paged_attention import quantize_kv
    pps = -(-cap // PAGE)
    n_pages = len(lens) * pps + 1
    rng = np.random.default_rng(seed)
    ptab = rng.permutation(n_pages - 1)[:len(lens) * pps].reshape(
        len(lens), pps).astype(np.int32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (len(lens), QH, D) if g is None else (len(lens), QH, g, D)
    q = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    k = torch.randn((KVH, n_pages, PAGE, D), generator=gen, device="cuda")
    v = torch.randn((KVH, n_pages, PAGE, D), generator=gen, device="cuda")
    ks = vs = None
    if variant == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    else:
        k, v = k.bfloat16(), v.bfloat16()
    return (q, k, v, ks, vs, torch.from_numpy(ptab).cuda(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def _time(pa, smoke, ops, split):
    """(kernel-alone ms, counts, out) of one call, the split forced to
    `split` ((S, n_splits), or None for the rule's)."""
    q, k, v, ks, vs, ptab, lens = ops
    fn = pa._launch if q.dim() == 3 else pa._launch_verify
    rule = pa.split_rule
    if split is not None:
        pa.split_rule = lambda *a, **kw: split
    try:
        def call():
            return fn(q, k, v, ptab, lens, D ** -0.5, ks, vs)
        out, counts = fn(q, k, v, ptab, lens, D ** -0.5, ks, vs,
                         count_tiles=True)
        names = ["paged_tc_kernel", "paged_merge_kernel"]
        got = []
        for _ in range(6):
            ms = smoke._profiled_ms(call, names)
            if ms is not None:
                got.append(ms)
            if len(got) == 3:
                break
        ms = statistics.median(got) if got else None
    finally:
        pa.split_rule = rule
    return ms, counts, out


def _reading(pa, smoke, kind, label, variant, ops, split, ref):
    ms, counts, out = _time(pa, smoke, ops, split)
    q = ops[0]
    g = 1 if q.dim() == 3 else q.shape[2]
    rt = pa.row_tiles(QH // KVH, g)
    return {"sweep": kind, "case": label, "pool": variant,
            "slots": q.shape[0], "G": g,
            "cap": ops[5].shape[1] * PAGE,
            "forced": split is not None,
            "split_cols": counts["split_cols"],
            "max_splits": counts["max_splits"],
            "blocks": q.shape[0] * KVH * rt * counts["max_splits"],
            "working_blocks": counts["splits"],
            "k_tiles": counts["k_tiles"],
            "workspace_bytes": counts["workspace_bytes"],
            "kernel_only_ms": ms,
            "max_abs_diff_vs_rule": (out.float() - ref.float()).abs()
            .max().item() if ref is not None else 0.0}


def _unsplit(cap):
    return -(-cap // 64) * 64, 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("paged_split_sweep: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as smoke
    import paddle_tpu_torch.ops.paged_attention as pa
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = None
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        out = open(args.out, "w")

    def emit(row):
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
    n_sm = pa._sm_count(torch.device("cuda"))
    emit({"card": card, "sms": n_sm, "split_cols": pa.SPLIT_COLS,
          "max_split_workspace": pa.MAX_SPLIT_WORKSPACE})

    cap = smoke.DECODE_SHAPE["MAX_LEN"]
    live = list(smoke.DECODE_LENS[:8])
    batches = {"decode": (list(smoke.DECODE_LENS), None),
               "verify_g4": (list(smoke.VERIFY_BASES), smoke.VERIFY_G)}
    chosen = pa.SPLIT_COLS
    for variant in ("bfloat16", "int8"):
        for label, (lens, g) in batches.items():
            ops = _operands(variant, lens, g, cap)
            _, _, ref = _time(pa, smoke, ops, None)
            for w in WIDTHS:
                pa.SPLIT_COLS = w
                try:
                    emit(_reading(pa, smoke, "width", label, variant, ops,
                                  None, ref))
                finally:
                    pa.SPLIT_COLS = chosen
            emit(_reading(pa, smoke, "width", label, variant, ops,
                          _unsplit(cap), ref))

    for variant in ("bfloat16", "int8"):
        for label, slots, g in (("decode", 32, None), ("decode", 33, None),
                                ("decode", 40, None), ("verify", 8, 16),
                                ("verify", 8, 64), ("verify", 9, 64)):
            n_tok = g or 1
            lens = [live[i % 8] for i in range(slots)]
            if g is not None:
                lens = [min(n, cap - g) for n in lens]
            ops = _operands(variant, lens, g, cap)
            _, ns = pa.split_rule(slots, KVH, QH // KVH, n_tok, cap, D, n_sm)
            other = _unsplit(cap) if ns > 1 else \
                (chosen, -(-cap // chosen))
            _, _, ref = _time(pa, smoke, ops, None)
            emit(_reading(pa, smoke, "threshold", label, variant, ops,
                          None, ref))
            emit(_reading(pa, smoke, "threshold", label, variant, ops,
                          other, ref))

    for long_cap in (32768, 131072):
        for variant in ("bfloat16", "int8"):
            ops = _operands(variant, list(smoke.DECODE_LENS), None,
                            long_cap)
            s, _ = pa.split_rule(len(smoke.DECODE_LENS), KVH, QH // KVH, 1,
                                 long_cap, D, n_sm)
            other = _unsplit(long_cap) if s == chosen else \
                (chosen, -(-long_cap // chosen))
            _, _, ref = _time(pa, smoke, ops, None)
            emit(_reading(pa, smoke, "long_cap", "decode", variant, ops,
                          None, ref))
            emit(_reading(pa, smoke, "long_cap", "decode", variant, ops,
                          other, ref))
            del ops, ref
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
