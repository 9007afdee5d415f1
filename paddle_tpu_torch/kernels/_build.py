"""Build the port's CUDA kernel from its source in `csrc/`.

`csrc/<name>.cu` is compiled by nvcc into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds) and loaded
with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library lands in `paddle_tpu_torch/_build/`, named by a hash of the
source, every header of `csrc/` (`*.cuh`, which a source may include)
and the flags, so an edited source or header rebuilds and an unchanged
one is reused. Nothing here runs at import time; a missing nvcc or a failed
compile raises."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["build", "load", "lib_path", "ptxas_report"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded = {}


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "paddle_tpu_torch: nvcc not found (looked in $CUDA_HOME/bin, "
            "/usr/local/cuda/bin and PATH); the CUDA kernels are built "
            "from source at first use")
    return found


def _source(name):
    return CSRC / f"{name}.cu"


def lib_path(name) -> Path:
    h = hashlib.sha256(_source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _log_path(name) -> Path:
    return lib_path(name).with_suffix(".log")


def build(name):
    """Compile `csrc/<name>.cu` unless its library exists. Returns the
    seconds spent. Raises RuntimeError with nvcc's output on failure."""
    t0 = time.perf_counter()
    out = lib_path(name)
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        p = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _log_path(name).write_text(p.stdout)
        if p.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"paddle_tpu_torch: building {name} failed (nvcc exit "
                f"{p.returncode}):\n{p.stdout}")
        os.replace(tmp, out)
    return time.perf_counter() - t0


def ptxas_report(name):
    """nvcc's output for `name`'s last build (registers, shared
    memory and spills per kernel, from `-Xptxas -v`), or ''."""
    p = _log_path(name)
    return p.read_text() if p.is_file() else ""


def load(name) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if
    needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(lib_path(name)))
            _loaded[name] = lib
        return lib
