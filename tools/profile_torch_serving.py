#!/usr/bin/env python3
"""Where the time of a paddle_tpu_torch serving step goes, on one CUDA
card.

Builds the engine and requests of `chip_smoke.py`'s serve phase
(`chip_smoke.serve_params` and `serve_engine`: full-width Llama-3-8B,
the same 8 requests, each asking for 16 more tokens here), then profiles
with torch.profiler one prefill-heavy wave (one synchronous step), and,
after stepping until every request has its first token, 16 decode-only
steps driven like run_pipelined(). Prints one JSON line per window:
wall time, summed kernel time, the device's busy share (summed kernel
time over wall time, one stream), and the kernels with the most device
time, grouped as attention (the port's CUDA kernel), matmul, and
everything else.

    python3 tools/profile_torch_serving.py [--pool bf16|int8]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

STEPS = 16          # decode steps in the profiled window


def _group(name):
    n = name.lower()
    if "ragged_kernel" in n:
        return "attention (ragged_paged_attention.cu)"
    if any(s in n for s in ("fwd_kernel", "dq_kernel", "dkv_kernel")):
        return "attention (flash_attention.cu)"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
        return "matmul"
    return "other"


def _window(label, fn, card):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type.name == "CUDA" and dev_us > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + dev_us / 1e3
    busy = sum(kernels.values())
    groups = {}
    for k, ms in kernels.items():
        groups[_group(k)] = groups.get(_group(k), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "window": label, "card": card, "steps": steps,
        "wall_ms": wall * 1e3, "kernel_ms": busy,
        "device_busy_share": busy / (wall * 1e3) if wall else None,
        "per_step_wall_ms": wall * 1e3 / max(steps, 1),
        "groups_ms": groups,
        "top_kernels_ms": [[k[:90], ms] for k, ms in top]}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pool", choices=("bf16", "int8"), default="bf16")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg, params = chip_smoke.serve_params()
    eng, reqs = chip_smoke.serve_engine(
        cfg, params, None if args.pool == "bf16" else "int8",
        new_tokens=64 + STEPS)
    eng.step()                                  # warm-up: first wave

    def prefill_wave():
        eng.step()
        return 1
    _window("prefill_wave (256 prompt rows)", prefill_wave, card)
    warm = 2
    while not all(r.output for r in reqs):      # every prompt seeded
        eng.step()
        warm += 1

    def decode_steps():
        # the run_pipelined() pump: launch N+1 before consuming N
        pending = None
        for _ in range(STEPS):
            ticket = eng.step_launch(carry=pending)
            if pending is not None:
                eng.step_finish(pending, inflight=ticket)
            pending = ticket
        eng.step_finish(pending)
        return STEPS
    _window(f"decode ({len(reqs)} rows, after {warm} step() calls)",
            decode_steps, card)
    eng.run()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
