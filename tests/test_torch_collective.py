"""paddle_tpu_torch's collectives, rank mesh and launcher held to the JAX
package.

The port's side runs as gloo ranks on the CPU, spawned once per world
size by `paddle_tpu_torch.distributed.launch.spawn` (a file store under
tmp_path, one thread a rank, a deadline); what they run is
`tests/_torch_ranks.py`. The JAX side runs the same inputs through
`lax.psum`, `all_gather`, `psum_scatter`, `all_to_all` and `ppermute`
under `shard_map` on conftest's CPU devices. Collectives move the same
fp32 values, so the results agree to 1e-6."""
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

import _torch_ranks as R
from paddle_tpu.parallel import mesh as JM
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import env as E
from paddle_tpu_torch.distributed import launch
from paddle_tpu_torch.parallel import mesh as TM

WORLDS = (2, 4)
DEADLINE_S = 120
TOL = dict(atol=1e-6, rtol=1e-6)


def _data(n):
    rng = np.random.default_rng(n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": f(n * 2 * n, 3), "w": f(n * 2 * n, 3), "x0": f(2 * n, 3),
            "w0": f(2 * n, 3), "x3": f(n * 2, 2 * n, 3),
            "w3": f(n * 2 * n, 2, 3)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("store")
    return {n: launch.spawn(R.collectives, n, "gloo", "cpu", DEADLINE_S,
                            args=(_data(n),), threads=1, store_dir=str(d))
            for n in WORLDS}


def _smap(fn, n, in_specs, out_specs):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("i",))
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs)


def _blocks(a, n):
    return np.split(np.asarray(a), n)


def _jax_forward(n, name, d):
    """The JAX answer of each rank, as a list of n arrays."""
    x = jnp.asarray(d["x"])
    si = JP("i")
    ops = {
        "all_reduce_sum": lambda a: lax.psum(a, "i"),
        "all_reduce_max": lambda a: lax.pmax(a, "i"),
        "all_reduce_avg": lambda a: lax.pmean(a, "i"),
        "reduce_scatter": lambda a: lax.psum_scatter(
            a, "i", scatter_dimension=0, tiled=True),
        "alltoall_single": lambda a: lax.all_to_all(a, "i", 0, 0,
                                                    tiled=True),
        "ppermute_ring": lambda a: lax.ppermute(
            a, "i", [(i, (i + 1) % n) for i in range(n)]),
        "ppermute_one": lambda a: lax.ppermute(a, "i", [(0, n - 1)]),
    }
    if name in ops:
        return _blocks(_smap(ops[name], n, si, si)(x), n)
    if name in ("all_gather", "all_gather_list"):
        out = _smap(lambda a: lax.all_gather(a, "i")[None], n, si, si)(x)
        return list(np.asarray(out))
    if name == "all_gather_cat":
        out = _smap(lambda a: lax.all_gather(a, "i", axis=1, tiled=True),
                    n, si, si)(x)
        return _blocks(out, n)
    raise KeyError(name)


FORWARD = ("all_reduce_sum", "all_reduce_max", "all_reduce_avg",
           "all_gather", "all_gather_list", "all_gather_cat",
           "reduce_scatter", "alltoall_single", "ppermute_ring",
           "ppermute_one")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", FORWARD)
def test_collective_equals_jax(ranks, n, name):
    want = _jax_forward(n, name, _data(n))
    for r in range(n):
        np.testing.assert_allclose(ranks[n][r][name], want[r],
                                   err_msg=f"rank {r}", **TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_paddle_forms(ranks, n):
    """Paddle's list forms and the ops without a lax twin, against
    numpy: reduce_scatter(tensor, tensor_list), alltoall of a list,
    broadcast from the last rank, send / recv from rank 0 to 1."""
    blocks = _blocks(_data(n)["x"], n)
    total = sum(blocks)
    for r in range(n):
        got = ranks[n][r]
        np.testing.assert_allclose(got["reduce_scatter_list"],
                                   np.split(total, n)[r], **TOL)
        np.testing.assert_array_equal(
            got["alltoall_list"],
            np.stack([np.split(b, n)[r] for b in blocks]))
        np.testing.assert_array_equal(got["broadcast"], blocks[-1])
        np.testing.assert_array_equal(
            got["recv"], blocks[0] if r == 1 else np.zeros_like(blocks[0]))
        assert got["backend"] == "gloo"


@pytest.mark.parametrize("n", WORLDS)
def test_differentiable_collectives_equal_jax(ranks, n):
    """Forward and gradient of sum(out * w): copy_to_group against
    shard_map's replicated input (its transpose a psum),
    reduce_from_group against psum to a replicated output (its transpose
    the identity), all_to_all and ppermute against lax's (their
    transposes the inverse all-to-all and permutation)."""
    d = _data(n)
    x, w = jnp.asarray(d["x"]), jnp.asarray(d["w"])
    si = JP("i")
    # the replicated x0 meets each rank's block of w
    f = _smap(lambda a, b: a * b, n, (JP(), si), si)
    g_copy = jax.grad(lambda a: jnp.sum(f(a, w)))(jnp.asarray(d["x0"]))
    red = _smap(lambda a: lax.psum(a, "i"), n, si, JP())
    y_red = red(x)
    g_red = jax.grad(lambda a: jnp.sum(red(a) * d["w0"]))(x)
    a2a = _smap(lambda a: lax.all_to_all(a, "i", 1, 0, tiled=True), n, si,
                si)
    x3, w3 = jnp.asarray(d["x3"]), jnp.asarray(d["w3"])
    y_a2a = a2a(x3)
    g_a2a = jax.grad(lambda a: jnp.sum(a2a(a) * w3))(x3)
    ring = [(i, (i + 1) % n) for i in range(n)]
    pp = _smap(lambda a: lax.ppermute(a, "i", ring), n, si, si)
    y_pp = pp(x)
    g_pp = jax.grad(lambda a: jnp.sum(pp(a) * w))(x)
    for r in range(n):
        got = ranks[n][r]
        np.testing.assert_allclose(got["copy_to_group_grad"], g_copy, **TOL)
        np.testing.assert_allclose(got["reduce_from_group"], y_red, **TOL)
        np.testing.assert_allclose(got["reduce_from_group_grad"],
                                   _blocks(g_red, n)[r], **TOL)
        np.testing.assert_allclose(got["all_to_all"], _blocks(y_a2a, n)[r],
                                   **TOL)
        np.testing.assert_allclose(got["all_to_all_grad"],
                                   _blocks(g_a2a, n)[r], **TOL)
        np.testing.assert_allclose(got["ppermute"], _blocks(y_pp, n)[r],
                                   **TOL)
        np.testing.assert_allclose(got["ppermute_grad"],
                                   _blocks(g_pp, n)[r], **TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_bytes_sent_counts_the_ring_all_reduce(ranks, n):
    """One all-reduce of 1000 fp32: 2 (n-1)/n of 4000 bytes, one call."""
    for r in range(n):
        c = ranks[n][r]["counters"]
        assert c["calls"] == 1
        assert c["bytes_sent"] == 2 * (n - 1) * 4000 // n
        assert c["seconds"] > 0


# ------------------------------------------------------------ the mesh
MESHES = [({"dp": 2, "tp": 4}, {}), ({"tp": 2}, {}), ({"pp": 2, "tp": -1}, {}),
          ({"sp": 4}, {}), ({"pp": 2, "dp": 2, "tp": 2}, {}), ({}, {"tp": 8}),
          ({}, {"dp": -1, "sp": 2})]
BAD_MESHES = [{"dp": 3}, {"tp": 3}, {"dp": 2, "tp": 2}, {"pp": 16}]


@pytest.mark.parametrize("axes,kw", MESHES)
def test_create_mesh_equals_jax(axes, kw):
    want = JM.create_mesh(axes or None, devices=jax.devices(), **kw)
    got = TM.create_mesh(axes or None, ranks=range(8), **kw)
    assert dict(got.shape) == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    ids = np.vectorize(lambda dv: dv.id)(want.devices)
    np.testing.assert_array_equal(got.devices, ids)
    assert TM.get_mesh() is got


@pytest.mark.parametrize("axes", BAD_MESHES)
def test_create_mesh_refuses_as_jax(axes):
    with pytest.raises(ValueError) as want:
        JM.create_mesh(axes, devices=jax.devices())
    with pytest.raises(ValueError) as got:
        TM.create_mesh(axes, ranks=range(8))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape", [(4096, 1024), (64, 48), (7, 1000),
                                   (3, 5, 1024), (8,), (), (1024, 6)])
@pytest.mark.parametrize("axes", [{"dp": 8}, {"dp": 2, "tp": 4},
                                  {"tp": 8}, {"dp": 4, "sp": 2}])
def test_fsdp_spec_equals_jax(shape, axes):
    for kw in ({}, {"axis": "tp", "min_size": 16}):
        want = JM.fsdp_spec(shape, JM.create_mesh(axes,
                                                  devices=jax.devices()),
                            **kw)
        got = TM.fsdp_spec(shape, TM.create_mesh(axes, ranks=range(8)), **kw)
        assert tuple(got) == tuple(want), (shape, axes, kw)


def test_a_mesh_without_a_process_group_has_no_groups():
    mesh = TM.create_mesh({"dp": 2}, ranks=range(2))
    assert mesh.coords == {"dp": 0}
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        mesh.group("dp")
    with pytest.raises(RuntimeError, match="not initialised"):
        C.all_reduce(torch.ones(2), group=C.Group([0, 1]))
    # a group of one rank needs no process group: every op is identity
    one = TM.create_mesh({"dp": 1}, ranks=[0])
    x = torch.arange(3.)
    assert C.all_reduce(x, group=one.group("dp")) is x


# ------------------------------------------------------------ launching
def test_spawn_reraises_a_failed_rank_with_its_traceback(tmp_path):
    with pytest.raises(RuntimeError) as e:
        launch.spawn(R.boom, 2, "gloo", "cpu", DEADLINE_S, threads=1,
                     store_dir=str(tmp_path))
    assert "rank 1 of 2 failed" in str(e.value)
    assert "ValueError: rank one says no" in str(e.value)
    assert "in boom" in str(e.value)


def test_spawn_kills_every_rank_at_the_deadline(tmp_path):
    import time
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="every rank was killed"):
        launch.spawn(R.sleeper, 2, "gloo", "cpu", 5, threads=1,
                     store_dir=str(tmp_path))
    assert time.monotonic() - t0 < 40


def test_launch_module_runs_a_script_on_each_rank(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(textwrap.dedent("""
        import sys, torch
        from paddle_tpu_torch.distributed import collective as C, env
        rank = env.init_parallel_env()
        x = torch.tensor([float(rank + 1)])
        C.all_reduce(x)
        open(sys.argv[1] + f"/out{rank}", "w").write(
            f"{env.get_world_size()} {C.get_backend()} {x.item()}")
    """))
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc", "2", "--backend", "gloo", "--device", "cpu",
         "--deadline", "90", str(script), str(tmp_path)],
        capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    for r in range(2):
        assert (tmp_path / f"out{r}").read_text() == "2 gloo 3.0"


no_card = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="checks the behaviour without a card")


@no_card
def test_spawn_computes_on_the_card_unless_asked_and_names_its_backend(
        tmp_path, monkeypatch):
    with pytest.raises(TypeError, match="backend"):
        launch.spawn(R.boom, 2)
    with pytest.raises(ValueError, match="name 'nccl'"):
        launch.spawn(R.boom, 2, None, "cpu", DEADLINE_S)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.spawn(R.boom, 2, "gloo", deadline_s=DEADLINE_S,
                     store_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())      # no rank was started
    monkeypatch.delenv("PT_SPAWN_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.rank_device()
    assert launch.rank_device("cpu") == "cpu"
    monkeypatch.setenv("PT_SPAWN_DEVICE", "cpu")
    assert launch.rank_device() == "cpu"


@no_card
@pytest.mark.parametrize("flags, code, words", [
    (["--backend", "gloo"], 1, "device='cpu'"),
    (["--device", "cpu"], 2, "--backend"),
])
def test_launch_module_needs_a_backend_and_a_card_or_device_cpu(
        tmp_path, flags, code, words):
    script = tmp_path / "job.py"
    script.write_text("open(__file__ + '.ran', 'w')\n")
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc", "2", *flags, str(script)], capture_output=True,
        text=True, timeout=60)
    assert out.returncode == code and words in out.stderr, out.stderr
    assert not (tmp_path / "job.py.ran").exists()


def test_init_parallel_env_names_its_backend_and_fails_loudly(monkeypatch,
                                                             tmp_path):
    monkeypatch.delenv("PT_DIST_BACKEND", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert E.init_parallel_env() == 0      # a world of one process
    with pytest.raises(ValueError, match="name the backend"):
        E.init_parallel_env(init_method="file:///nonexistent/x",
                            world_size=2)
    # the second rank never comes: the rendezvous times out and raises
    with pytest.raises(RuntimeError, match="rendezvous failed"):
        E.init_parallel_env("gloo", f"file://{tmp_path}/store", rank=0,
                            world_size=2, timeout_s=2)
    assert not E.is_initialized()
