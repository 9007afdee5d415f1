#!/usr/bin/env python3
"""Where the time of a paddle_tpu_torch serving step goes, on one CUDA
card.

Builds the engine and requests of `chip_smoke.py`'s serve phase
(`chip_smoke.serve_params` and `serve_engine`: full-width Llama-3-8B,
the same 8 requests, each asking for 16 more tokens here), then profiles
with torch.profiler one prefill-heavy wave (one synchronous step), and,
after stepping until every request has its first token, 16 decode-only
steps driven like run_pipelined(). With `--bucketed` the engine is the
bucketed one (`ragged=False`, chip_smoke's bucket_serve phase): its
first step admits all 8 prompts in one packed prefill_varlen wave and
decodes once, so a warm-up engine runs that step first and a fresh one
is profiled. With `--spec G` the engine is the bucketed one with
speculative decoding (`spec_decode=G`, chip_smoke's spec_serve phase
and its `echo_prompts`): the first window is the
admission wave and the first verify step, the second 16 verify steps
driven by step(), each of them synchronous. Prints one JSON line per
window: wall time, summed kernel time, the device's busy share (summed
kernel time over wall time, one stream), and the kernels with the most
device time, grouped as attention (by the port's CUDA source), matmul,
and everything else.

    python3 tools/profile_torch_serving.py [--pool bf16|int8] [--bucketed]
                                           [--spec G]
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
    # before the generic fwd_kernel test below: va_fwd_kernel ends in it
    if "va_fwd_kernel" in n or "tile_ranges_kernel" in n:
        return "attention (varlen_attention.cu)"
    if "decode_kernel" in n or "verify_kernel" in n:
        return "attention (paged_attention.cu)"
    # the bf16 forwards are attn_fwd_sm90.cuh's fwd_tc_kernel, told apart
    # by their mask policy
    if any(s in n for s in ("fm_fwd_kernel", "fm_dq_kernel",
                            "fm_dkv_kernel", "fmpolicy", "tile_agg_kernel")):
        return "attention (flashmask_attention.cu)"
    if any(s in n for s in ("fwd_kernel", "dq_kernel", "dkv_kernel",
                            "flashpolicy")):
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
    ap.add_argument("--bucketed", action="store_true",
                    help="profile the bucketed engine (ragged=False)")
    ap.add_argument("--spec", type=int, default=0, metavar="G",
                    help="profile the bucketed engine with spec_decode=G")
    args = ap.parse_args(argv)
    if args.spec == 1 or args.spec < 0:
        ap.error("--spec takes a chunk width G >= 2")
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

    bucketed = args.bucketed or args.spec > 1
    spec = {"spec_decode": args.spec,
            "prompts": chip_smoke.echo_prompts(cfg, params)} \
        if args.spec > 1 else {}

    def engine():
        return chip_smoke.serve_engine(
            cfg, params, None if args.pool == "bf16" else "int8",
            new_tokens=64 + STEPS, ragged=not bucketed, **spec)
    eng, reqs = engine()
    eng.step()                                  # warm-up: first wave
    if bucketed:
        del eng
        eng, reqs = engine()                    # the profiled admission
        label = "prefill_wave (prefill_varlen over 8 prompts, 1 " + \
            (f"verify step, G={args.spec})" if spec else "decode)")
    else:
        label = "prefill_wave (256 prompt rows)"

    def prefill_wave():
        eng.step()
        return 1
    _window(label, prefill_wave, card)
    warm = 2
    while not all(r.output for r in reqs):      # every prompt seeded
        eng.step()
        warm += 1

    def decode_steps():
        if spec:            # a spec engine steps synchronously
            for _ in range(STEPS):
                eng.step()
            return STEPS
        # the run_pipelined() pump: launch N+1 before consuming N
        pending = None
        for _ in range(STEPS):
            ticket = eng.step_launch(carry=pending)
            if pending is not None:
                eng.step_finish(pending, inflight=ticket)
            pending = ticket
        eng.step_finish(pending)
        return STEPS
    what = f"verify (G={args.spec}, " if spec else "decode ("
    _window(f"{what}{len(reqs)} slots, after {warm} step() calls)",
            decode_steps, card)
    if spec:
        print(json.dumps({"spec_drafted": eng.spec_drafted,
                          "spec_accepted": eng.spec_accepted,
                          "device_steps": eng.device_steps}), flush=True)
    eng.run()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
