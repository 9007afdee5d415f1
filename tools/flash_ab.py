#!/usr/bin/env python3
"""Rows 3-5 (the flash forward, dQ and dK/dV kernels) of two checkouts,
timed in one process on one CUDA card.

Each checkout's `csrc/flash_attention.cu` is built by that checkout's own
`paddle_tpu_torch.kernels._build` (in child processes run at once, so
that the two packages never share one interpreter) unless its library
exists, and both libraries are loaded through ctypes. On the same tensors (B, H, S,
D, causal), bf16 and fp32, each kernel runs first on both to compare
their outputs, then is timed in ROUNDS alternating rounds (the order
swapped each round) of REPS launches after 3 warm-up launches, by CUDA
events. Prints one JSON line: the card's name and power limit, and for
each dtype and kernel both medians, their ratio, every sample and the
largest difference between the two outputs. Whole-script timings of
two trees in separate processes can differ by more than a kernel
change; this holds everything else equal.

    python3 tools/flash_ab.py --base _archive/parent --head . \\
        [--shape 2,32,2048,128]
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import statistics
import subprocess
import sys

ROUNDS = 8
REPS = 20
KERNELS = ("fwd", "dq", "dkv")


def _build(roots):
    """Build each checkout's flash library (if needed), all at once."""
    procs = [subprocess.Popen([sys.executable, "-c",
                               "from paddle_tpu_torch.kernels import "
                               "_build; _build.build('flash_attention')"],
                              cwd=root) for root in roots]
    for root, proc in zip(roots, procs):
        if proc.wait() != 0:
            raise SystemExit(f"{root}: the build failed")


def _library(root):
    """Load `root`'s flash library with its C signatures."""
    paths = glob.glob(os.path.join(
        root, "paddle_tpu_torch", "_build", "flash_attention-*.so"))
    if len(paths) != 1:
        raise SystemExit(f"{root}: want one flash library, found {paths}")
    lib = ctypes.CDLL(paths[0])
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [ci] * 4 + [cf, ci, ci, vp]
    lib.fa_fwd.argtypes = [vp] * 5 + tail
    lib.fa_bwd_dq.argtypes = [vp] * 7 + tail
    lib.fa_bwd_dkv.argtypes = [vp] * 8 + tail
    for fn in (lib.fa_fwd, lib.fa_bwd_dq, lib.fa_bwd_dkv):
        fn.restype = ci
    return lib


def _compare(libs, b, h, s, d, dtype, code):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    o = torch.empty_like(q)
    lse = torch.empty(b, h, s, device="cuda")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    scale = d ** -0.5
    operands = {}

    def call(lib, name):
        if name == "fwd":
            fn, ptrs = lib.fa_fwd, (q, k, v, o, lse)
        elif name == "dq":
            fn, ptrs = lib.fa_bwd_dq, (q, k, v, do, lse, operands["delta"],
                                       dq)
        else:
            fn, ptrs = lib.fa_bwd_dkv, (q, k, v, do, lse,
                                        operands["delta"], dk, dv)
        rc = fn(*[t.data_ptr() for t in ptrs], b * h, s, s, d, scale, 1,
                code, stream)
        if rc != 0:
            raise SystemExit(f"{name}: launch failed ({rc})")

    call(libs["base"], "fwd")
    operands["delta"] = (do.float() * o.float()).sum(-1).contiguous()
    outs = {}
    for tag, lib in libs.items():
        for name in KERNELS:
            call(lib, name)
        torch.cuda.synchronize()
        outs[tag] = [t.float().clone() for t in (o, dq, dk, dv)]
    diff = max(float((x - y).abs().max())
               for x, y in zip(outs["base"], outs["head"]))
    samples = {(tag, n): [] for tag in libs for n in KERNELS}
    for rnd in range(ROUNDS):
        order = ("base", "head") if rnd % 2 == 0 else ("head", "base")
        for name in KERNELS:
            for tag in order:
                for _ in range(3):
                    call(libs[tag], name)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(REPS):
                    call(libs[tag], name)
                e1.record()
                torch.cuda.synchronize()
                samples[(tag, name)].append(e0.elapsed_time(e1) / REPS)
    row = {"max_abs_diff": diff}
    for name in KERNELS:
        base = statistics.median(samples[("base", name)])
        head = statistics.median(samples[("head", name)])
        row[name] = {"base_ms": base, "head_ms": head,
                     "head_over_base": head / base,
                     "base_samples": samples[("base", name)],
                     "head_samples": samples[("head", name)]}
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the first checkout")
    ap.add_argument("--head", required=True, help="the second checkout")
    ap.add_argument("--shape", default="2,32,2048,128",
                    help="B,H,S,D (default: train_kernel's)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA device")
    b, h, s, d = (int(x) for x in args.shape.split(","))
    roots = {"base": os.path.abspath(args.base),
             "head": os.path.abspath(args.head)}
    _build(list(roots.values()))
    libs = {tag: _library(root) for tag, root in roots.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = {"card": card, "shape": [b, h, s, d], "causal": True, **roots}
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        out[str(dtype).split(".")[1]] = _compare(libs, b, h, s, d, dtype,
                                                 code)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
