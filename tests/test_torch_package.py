"""paddle_tpu_torch stands alone: it imports neither jax nor any module
of paddle_tpu, and its entry points run on the card unless the caller
asks for the CPU."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.models.llama import LlamaConfig

ROOT = Path(paddle_tpu_torch.__file__).resolve().parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(ROOT)], prefix="paddle_tpu_torch."))


def test_every_module_imports_without_jax_or_paddle_tpu():
    mods = _modules()
    for m in ("models.llama_serving", "ops.varlen_attention",
              "ops.paged_attention", "_env", "utils.trace",
              "distributed", "distributed.rpc", "distributed.collective",
              "distributed.env", "distributed.launch", "parallel",
              "parallel.mesh", "parallel.pp", "parallel.ring",
              "parallel.ulysses", "_core", "_core.dtypes", "_core.state",
              "_core.tensor", "_core.engine", "device", "autograd",
              "tensor", "tensor.creation", "tensor.math", "tensor.linalg",
              "tensor.manipulation", "tensor.random", "nn",
              "nn.functional", "nn.functional.attention", "nn.layer",
              "nn.layer.layers", "nn.initializer", "nn.clip", "optimizer",
              "optimizer.optimizer", "optimizer.rules", "optimizer.lr",
              "regularizer",
              *(f"models.{n}" for n in (
                  "qwen2", "gpt2", "moe_llm", "deepseek", "llama_decode",
                  "generation")),
              *(f"serving.{n}" for n in (
                  "client", "faults", "fleet", "metrics", "replica",
                  "router", "scheduler", "server", "timeline", "wire")),
              *(f"observability.{n}" for n in (
                  "chrome_trace", "compile_telemetry", "device_telemetry",
                  "fleet_obs", "flight_recorder", "health", "logging",
                  "pulse", "trace_context"))):
        assert f"paddle_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT.parent), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_name_no_jax_and_no_paddle_tpu_import():
    imp = re.compile(r"^\s*(import|from)\s+(jax\b|paddle_tpu\b(?!_torch))",
                     re.M)
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) >= 15
    for f in files:
        assert not imp.search(f.read_text()), f


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_engine_without_device_raises_on_a_box_without_cuda(no_card):
    from paddle_tpu_torch.models.llama_serving import ServingEngine
    params = {"embed": torch.zeros(1)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, LlamaConfig.tiny())


def test_init_params_without_device_raises_on_a_box_without_cuda(no_card):
    from paddle_tpu_torch.models.llama_spmd import init_params
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(LlamaConfig.tiny())


def test_resolve_device():
    assert paddle_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="not supported"):
        paddle_tpu_torch.resolve_device("meta")


def test_engine_refuses_params_on_another_device():
    from paddle_tpu_torch.models.llama_serving import ServingEngine
    params = {"embed": torch.zeros(1, device="meta")}
    with pytest.raises(ValueError, match="params live on"):
        ServingEngine(params, LlamaConfig.tiny(), device="cpu")


def test_kernel_wrapper_raises_off_cpu_and_cuda():
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    meta = {"device": "meta"}
    q = torch.empty((3, 4, 16), **meta)
    pages = torch.empty((2, 5, 8, 16), **meta)
    idx = torch.zeros((3,), dtype=torch.int32, **meta)
    ptab = torch.zeros((1, 5), dtype=torch.int32, **meta)
    before = rpa.launches
    with pytest.raises(ValueError, match="meta"):
        rpa.ragged_paged_attention(q, pages, pages, ptab, idx, idx)
    assert rpa.launches == before


def test_build_is_lazy_and_names_the_sources():
    """Importing the build module compiles nothing; the library name
    follows the source's hash."""
    from paddle_tpu_torch.kernels import _build
    name = "ragged_paged_attention"
    assert (_build.CSRC / f"{name}.cu").is_file()
    lib = _build.lib_path(name)
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith(name + "-") and lib.suffix == ".so"


def test_lib_path_follows_the_shared_headers(tmp_path, monkeypatch):
    """A source that includes a header of csrc/ (the tensor-core forward
    of attn_fwd_sm90.cuh) rebuilds when that header changes: the header
    is part of the library's hash, and an unchanged tree keeps it."""
    import shutil
    from paddle_tpu_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("flash_attention", "flashmask_attention")
    before = [_build.lib_path(n) for n in names]
    assert [_build.lib_path(n) for n in names] == before
    header = csrc / "attn_fwd_sm90.cuh"
    assert '#include "attn_fwd_sm90.cuh"' in (csrc / f"{names[0]}.cu"
                                              ).read_text()
    header.write_text(header.read_text() + "\n// edited\n")
    after = [_build.lib_path(n) for n in names]
    assert all(a != b for a, b in zip(after, before))
    assert all(a.parent == _build.BUILD_DIR for a in after)


def test_make_train_step_without_device_raises_on_a_box_without_cuda(
        no_card):
    from paddle_tpu_torch.models.llama_spmd import make_train_step
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(LlamaConfig.tiny())


def test_flash_attention_has_its_own_source():
    from paddle_tpu_torch.kernels import _build
    assert (_build.CSRC / "flash_attention.cu").is_file()
    lib = _build.lib_path("flash_attention")
    assert lib.name.startswith("flash_attention-") and lib.suffix == ".so"
    assert lib != _build.lib_path("ragged_paged_attention")


def test_flashmask_attention_has_its_own_source():
    from paddle_tpu_torch.kernels import _build
    assert (_build.CSRC / "flashmask_attention.cu").is_file()
    lib = _build.lib_path("flashmask_attention")
    assert lib.name.startswith("flashmask_attention-") and lib.suffix == ".so"
    assert lib not in (_build.lib_path("flash_attention"),
                       _build.lib_path("ragged_paged_attention"))


def test_flashmask_wrapper_raises_off_cpu_and_cuda():
    import paddle_tpu_torch.ops.flashmask_attention as fm
    q = torch.empty((1, 2, 8, 16), device="meta")
    sri = torch.zeros((1, 1, 8, 1), dtype=torch.int32, device="meta")
    before = (fm.launches_fwd, fm.launches_dq, fm.launches_dkv)
    with pytest.raises(ValueError, match="meta"):
        fm.flashmask_attention_bhsd(q, q, q, sri, causal=True)
    assert (fm.launches_fwd, fm.launches_dq, fm.launches_dkv) == before


@pytest.mark.parametrize("name", ["varlen_attention", "paged_attention"])
def test_bucketed_kernels_have_their_own_sources(name):
    from paddle_tpu_torch.kernels import _build
    assert (_build.CSRC / f"{name}.cu").is_file()
    lib = _build.lib_path(name)
    assert lib.name.startswith(f"{name}-") and lib.suffix == ".so"
    others = ("ragged_paged_attention", "flash_attention",
              "flashmask_attention", "varlen_attention", "paged_attention")
    assert lib not in [_build.lib_path(o) for o in others if o != name]


def test_bucketed_engine_without_device_raises_on_a_box_without_cuda(
        no_card):
    from paddle_tpu_torch.models.llama_serving import ServingEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine({"embed": torch.zeros(1)}, LlamaConfig.tiny(),
                      ragged=False)


def test_fleet_worker_without_device_raises_on_a_box_without_cuda(no_card):
    """A spawned fleet worker's spec runs on the card unless it says
    "device": "cpu": without one it raises before it binds anything."""
    from paddle_tpu_torch.serving.fleet import run_worker
    spec = {"name": "w0", "master": "127.0.0.1:1", "rank": 1,
            "world_size": 2, "model": vars(LlamaConfig.tiny())}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_worker(spec)


@pytest.fixture
def card_missing(monkeypatch):
    """No CUDA device, and no set_device("cpu") in effect."""
    from paddle_tpu_torch._core import state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(state, "_device", None)


@pytest.mark.parametrize("make", [
    lambda p: p.to_tensor([1.0, 2.0]),
    lambda p: p.randn([2, 3]),
    lambda p: p.nn.Linear(4, 2),
], ids=["to_tensor", "randn", "nn.Linear"])
def test_surface_without_a_card_names_set_device_cpu(card_missing, make):
    """The Paddle-shaped surface makes tensors and parameters on the card:
    without one it raises, naming the way to the CPU."""
    import paddle_tpu_torch as paddle
    assert paddle.get_device() == "gpu:0"
    with pytest.raises(RuntimeError, match=r'set_device\("cpu"\)'):
        make(paddle)


def test_set_device_maps_gpu_to_cuda_and_cpu_to_cpu(monkeypatch):
    from paddle_tpu_torch._core import state
    monkeypatch.setattr(state, "_device", None)
    assert state.set_device("gpu") == "gpu:0"
    assert state.set_device("cuda:1") == "gpu:1"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            state.torch_device()
    assert state.set_device("cpu") == "cpu"
    assert state.torch_device() == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown device"):
        state.set_device("tpu")


def test_top_level_names_of_the_reference_surface():
    """The reference's top-level names for the ported surface
    (paddle_tpu/__init__.py:17-35, the device names and every op of the
    ported tensor modules) are the port's top level too."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tensor import (creation, linalg, logic,
                                         manipulation, math, random,
                                         search, stat)
    names = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16",
             "bfloat16", "float32", "float64", "complex64", "complex128",
             "float8_e4m3fn", "float8_e5m2", "set_default_dtype",
             "get_default_dtype", "finfo", "iinfo", "Tensor", "Parameter",
             "seed", "get_rng_state", "is_tensor", "rank", "is_complex",
             "is_floating_point", "is_integer", "no_grad", "enable_grad",
             "grad", "dtype", "in_dynamic_mode", "set_grad_enabled",
             "autograd", "nn", "optimizer", "device", "regularizer",
             "set_device", "get_device", "is_compiled_with_cuda",
             "CPUPlace", "CUDAPlace", "synchronize", "ParamAttr"]
    for mod in (creation, linalg, logic, manipulation, math, random,
                search, stat):
        names += [n for n in mod.__all__ if n != "linalg"]
    missing = [n for n in names if not hasattr(paddle, n)]
    assert not missing
    assert paddle.linalg.inv is linalg.inv
