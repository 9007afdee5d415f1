#!/usr/bin/env python3
"""Does the order of documents in a packed row move the bf16 FlashMask
kernels' time, on one CUDA card?

The kernels launch one block per (batch*head, 64-row tile) in a fixed
order (dQ and the forward the last q tiles first, dK/dV the first k
tiles first), and under a document mask a block's work is its
document's: 3 to 47 tiles on `chip_smoke.py`'s packed row. How well the
blocks fill the card at the end of a launch then depends on where the
long documents lie. This times `fm_fwd`, `fm_bwd_dq` and `fm_bwd_dkv`
(bf16, B 1, H 32, S 8192, D 128, as chip_smoke's mask_kernel) on the
row's eight documents in three orders: longest first (chip_smoke's),
shortest first, and a seeded shuffle, in turns (each order twice,
mirrored), and prints one JSON line per order with each kernel's median
time, the tiles it computed a head and its time per 1,000 tiles (the
orders cut the row into tiles differently), then the card's name and
power limit.

    python3 tools/flashmask_doc_order.py
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("flashmask_doc_order: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(here), here]
    import chip_smoke
    import paddle_tpu_torch.ops.flashmask_attention as fm
    from paddle_tpu_torch.models.llama_spmd import doc_end_indices
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    b, h, s, d = (chip_smoke.MASK_ATTN[x] for x in "BHSD")
    docs = tuple(chip_smoke.PACKED_DOCS)
    orders = {"longest_first": docs,
              "shortest_first": docs[::-1],
              "shuffled_seed0": tuple(np.random.default_rng(0).permutation(
                  docs).tolist())}
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q, k, v, do = (torch.randn((b, h, s, d), generator=g, device="cuda")
                   .bfloat16() for _ in range(4))
    m = fm._Mask(True, None, 1.0 / math.sqrt(d), 0.0, None)
    cases = {}
    for name, lens in orders.items():
        doc = np.repeat(np.arange(len(lens)), lens)[None]
        sri = doc_end_indices(torch.from_numpy(doc).cuda())
        o, lse = fm._launch_fwd(q, k, v, sri, m)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, sri, do, lse, delta, m)
        tiles = {"flashmask_fwd": fm._launch_fwd(q, k, v, sri, m,
                                                 count_tiles=True)[2],
                 "flashmask_bwd_dq": fm._launch_dq(*args,
                                                   count_tiles=True)[1],
                 "flashmask_bwd_dkv": fm._launch_dkv(*args,
                                                     count_tiles=True)[2]}
        launch = {"flashmask_fwd": lambda sri=sri: fm._launch_fwd(
                      q, k, v, sri, m),
                  "flashmask_bwd_dq": lambda a=args: fm._launch_dq(*a),
                  "flashmask_bwd_dkv": lambda a=args: fm._launch_dkv(*a)}
        cases[name] = (lens, tiles, launch, {kn: [] for kn in launch})
    turns = list(cases) + list(cases)[::-1]
    for name in turns:
        _, _, launch, times = cases[name]
        for kn, fn in launch.items():
            times[kn].append(chip_smoke.cuda_ms(fn, reps=20))
    for name, (lens, tiles, _, times) in cases.items():
        row = {"order": name, "documents": list(lens), "card": card,
               "shape_bhsd": [b, h, s, d], "dtype": "bfloat16"}
        for kn in times:
            ms = float(np.median(times[kn]))
            row[kn] = {"ms": ms, "ms_per_turn": times[kn],
                       "tiles_per_head": tiles[kn] // h,
                       "ms_per_1000_tiles_a_head": ms * 1000 * h / tiles[kn]}
        print(json.dumps(row), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
