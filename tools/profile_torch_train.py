#!/usr/bin/env python3
"""Where the time of a paddle_tpu_torch train step goes, on one CUDA
card.

Builds the run of `chip_smoke.py`'s train phase (`chip_smoke.
train_setup`: Llama-3-8B widths cut to 4 layers, bf16 params, fp32
AdamW state, remat, one batch of 2 x 2048 tokens) or, with --packed, of
its train_packed phase (`chip_smoke.train_packed_setup`: the same model
on one row of 8192 tokens packing eight documents, on the FlashMask
kernels), with the step's `remat` and `fused_ce` as given (train_fused
is `--packed --remat dots --fused-ce`), takes two warm-up steps, then
profiles STEPS steps with torch.profiler. Prints one JSON line with the
window's wall time, summed kernel time, the device's busy share (summed
kernel time over wall time, one stream), kernel time grouped as
attention (the port's flash or FlashMask kernels), matmul and everything
else, with the kernels that take the most device time, and the peak
memory of the window. With --layer it profiles layer_train's step
instead (`chip_smoke.layer_train_setup`: the Paddle-shaped Layer-tree
Llama, bf16, no remat, eager AdamW with fp32 masters, the same batch
shape), which takes no other option.

    python3 tools/profile_torch_train.py [--packed] [--remat dots]
                                         [--fused-ce]
    python3 tools/profile_torch_train.py --layer
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

STEPS = 2           # train steps in the profiled window


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--packed", action="store_true",
                    help="profile the packed-document step (train_packed)")
    ap.add_argument("--remat", choices=("full", "dots"), default="full",
                    help="the step's activation checkpointing")
    ap.add_argument("--fused-ce", action="store_true",
                    help="the loss through the fused linear+CE head")
    ap.add_argument("--layer", action="store_true",
                    help="profile layer_train's Layer-tree step")
    args = ap.parse_args()
    if args.layer and (args.packed or args.fused_ce or
                       args.remat != "full"):
        ap.error("--layer takes no other option")
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(here), here]
    import chip_smoke
    from profile_torch_serving import _window
    from paddle_tpu_torch.models import llama_spmd as T
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.layer:
        cfg, model, layer_step = chip_smoke.layer_train_setup()
        for _ in range(2):                      # warm-up
            layer_step().item()

        def layer_steps():
            for _ in range(STEPS):
                layer_step()
            return STEPS
        torch.cuda.reset_peak_memory_stats()
        _window(f"layer train step ({chip_smoke.LAYER_TRAIN_CONFIG})",
                layer_steps, card)
        print(json.dumps({"max_memory_allocated_gb":
                          torch.cuda.max_memory_allocated() / 1e9}),
              flush=True)
        print(card, flush=True)
        return 0
    setup, config = ((chip_smoke.train_packed_setup,
                      chip_smoke.TRAIN_PACKED_CONFIG) if args.packed else
                     (chip_smoke.train_setup, chip_smoke.TRAIN_CONFIG))
    cfg, params, opt, batch, step = setup()
    remat = "dots" if args.remat == "dots" else True
    step = T.make_train_step(cfg, remat=remat, fused_ce=args.fused_ce,
                             device="cuda")
    for i in range(2):                          # warm-up
        step(params, opt, i, batch)

    def steps():
        for i in range(2, 2 + STEPS):
            step(params, opt, i, batch)
        return STEPS
    torch.cuda.reset_peak_memory_stats()
    _window(f"train step ({config}; remat {args.remat}, fused_ce "
            f"{args.fused_ce})", steps, card)
    print(json.dumps({"max_memory_allocated_gb":
                      torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
