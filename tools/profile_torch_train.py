#!/usr/bin/env python3
"""Where the time of a paddle_tpu_torch train step goes, on one CUDA
card.

Builds the run of `chip_smoke.py`'s train phase (`chip_smoke.
train_setup`: Llama-3-8B widths cut to 4 layers, bf16 params, fp32
AdamW state, remat, one batch of 2 x 2048 tokens), takes two warm-up
steps, then profiles STEPS steps with torch.profiler. Prints one JSON
line with the window's wall time, summed kernel time, the device's busy
share (summed kernel time over wall time, one stream), and kernel time
grouped as attention (the port's flash kernels), matmul and everything
else, with the kernels that take the most device time.

    python3 tools/profile_torch_train.py
"""
from __future__ import annotations

import os
import subprocess
import sys

STEPS = 2           # train steps in the profiled window


def main():
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(here), here]
    import chip_smoke
    from profile_torch_serving import _window
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg, params, opt, batch, step = chip_smoke.train_setup()
    for i in range(2):                          # warm-up
        step(params, opt, i, batch)

    def steps():
        for i in range(2, 2 + STEPS):
            step(params, opt, i, batch)
        return STEPS
    _window(f"train step ({chip_smoke.TRAIN_CONFIG})", steps, card)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
