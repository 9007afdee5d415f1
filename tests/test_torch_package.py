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
              "ops.paged_attention"):
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
