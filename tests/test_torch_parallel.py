"""paddle_tpu_torch's sequence and pipeline parallelism held to the JAX
package: ring and Ulysses attention at sp 2 and 4, the GPipe, 1F1B and
interleaved pipelines at pp 2 and 4, the interleaved schedule's tables,
the virtual-stage layout and the bubble fractions.

The port's side runs as gloo ranks on the CPU (`tests/_torch_ranks.py`,
spawned once per world size with a deadline); the JAX side runs the
same numpy inputs through `paddle_tpu.parallel` on conftest's CPU
devices (Ulysses through the JAX package's flash attention on the CPU).
fp32 on both sides, sums in another order: 1e-5."""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_ranks as R
from paddle_tpu.parallel import pp as JPP
from paddle_tpu.parallel.ring import ring_attention as j_ring
from paddle_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from paddle_tpu_torch.distributed import launch
from paddle_tpu_torch.parallel import pp as TPP

WORLDS = (2, 4)
DEADLINE_S = 150
TOL = dict(atol=1e-5, rtol=1e-5)


def _attn_data(n):
    rng = np.random.default_rng(10 + n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    B, H, S, D = 2, 4, 8 * n, 16
    return {"q": f(B, H, S, D), "kv": (f(B, H, S, D), f(B, H, S, D)),
            "kv_gqa": (f(B, 2, S, D), f(B, 2, S, D)), "w": f(B, H, S, D),
            "q_chunk": 4}


PIPE = dict(L=8, B=8, T=3, D=8, n_micro=4, vpp=2)


def _pipe_data(n):
    rng = np.random.default_rng(20 + n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    L, B, T, D = PIPE["L"], PIPE["B"], PIPE["T"], PIPE["D"]
    tgt = f(B, T, D)
    tgt[1, :, 0] = -1.0            # rows the head leaves out
    tgt[5, 1:, 0] = -1.0
    return {"w": f(L, D, D) * 0.5, "b": f(L, D) * 0.1, "extra": f(D),
            "x": f(B, T, D), "tgt": tgt, "head_w": f(D, D) * 0.5,
            "wy": f(B, T, D), "n_micro": PIPE["n_micro"], "vpp": PIPE["vpp"]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("store"))

    jobs = {(kind, n): (fn, data(n)) for kind, fn, data in (
        ("sp", R.sequence_parallel, _attn_data),
        ("pp", R.pipelines, _pipe_data)) for n in WORLDS}
    # the four worlds run at once, one thread a rank
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {key: pool.submit(launch.spawn, fn, key[1], "gloo", "cpu",
                                 DEADLINE_S, args=(data,), threads=1,
                                 store_dir=d)
                for key, (fn, data) in jobs.items()}
        out = {"sp": {}, "pp": {}}
        for (kind, n), fut in futs.items():
            out[kind][n] = fut.result()
    return out


def _mesh(n, name):
    return Mesh(np.asarray(jax.devices()[:n]), (name,))


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["ring", "ulysses", "ulysses_gqa"])
@pytest.mark.parametrize("n", WORLDS)
def test_sequence_parallel_attention_equals_jax(ranks, n, impl, causal):
    d = _attn_data(n)
    q, (k, v) = jnp.asarray(d["q"]), map(jnp.asarray, d[
        "kv_gqa" if impl == "ulysses_gqa" else "kv"])
    mesh = _mesh(n, "sp")
    if impl == "ring":
        fn = lambda a, b, c: j_ring(a, b, c, mesh, "sp", causal=causal,  # noqa: E731
                                    q_chunk=d["q_chunk"])
    else:
        fn = lambda a, b, c: j_ulysses(a, b, c, mesh, "sp", causal=causal)  # noqa: E731
    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * d["w"]),
                             argnums=(0, 1, 2)))(q, k, v)
    for r in range(n):
        got = ranks["sp"][n][r][(impl, causal)]
        for name, want, g in zip(("out", "dq", "dk", "dv"),
                                 (out,) + tuple(grads), got):
            np.testing.assert_allclose(
                g, np.split(np.asarray(want), n, axis=2)[r],
                err_msg=f"{name} rank {r}", **TOL)


def test_ulysses_refuses_heads_that_do_not_divide():
    from paddle_tpu_torch.distributed.collective import Group
    from paddle_tpu_torch.parallel.ulysses import ulysses_attention_local
    q = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError, match=r"heads \(4\) divisible by the sp "
                                         r"axis size \(8\)"):
        ulysses_attention_local(q, q, q, Group(range(8)), causal=True)
    with pytest.raises(ValueError, match="divisible"):
        j_ulysses(jnp.zeros((1, 4, 64, 16)), jnp.zeros((1, 4, 64, 16)),
                  jnp.zeros((1, 4, 64, 16)), _mesh(8, "sp"), "sp")


# ------------------------------------------------------------ pipelines
def _j_layer(lp, h, extra):
    return jnp.tanh(h @ lp["w"] + lp["b"]) * extra


def _j_head(hp, h, tgt):
    keep = (tgt[..., 0] >= 0).astype(jnp.float32)
    err = jnp.sum((h @ hp["w"] - tgt) ** 2, -1)
    return jnp.sum(err * keep), jnp.sum(keep)


def _stacked(d):
    return {"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}


@pytest.mark.parametrize("n", WORLDS)
def test_pipeline_apply_equals_jax(ranks, n):
    d = _pipe_data(n)
    mesh = _mesh(n, "pp")
    extra = jnp.asarray(d["extra"])

    def fn(x, st):
        return JPP.pipeline_apply(JPP.group_stages(st, n), x, _j_layer, mesh,
                                  "pp", d["n_micro"], extra)
    x, st = jnp.asarray(d["x"]), _stacked(d)
    y = jax.jit(fn)(x, st)
    gx, gst = jax.jit(jax.grad(lambda a, b: jnp.sum(fn(a, b) * d["wy"]),
                               argnums=(0, 1)))(x, st)
    for r in range(n):
        got_y, got_gx, got_gb, got_gw = ranks["pp"][n][r]["apply"]
        np.testing.assert_allclose(got_y, y, **TOL)
        np.testing.assert_allclose(got_gx, gx, **TOL)
        np.testing.assert_allclose(got_gb, np.split(np.asarray(gst["b"]),
                                                    n)[r], **TOL)
        np.testing.assert_allclose(got_gw, np.split(np.asarray(gst["w"]),
                                                    n)[r], **TOL)


@pytest.mark.parametrize("schedule", ["1f1b", "interleave"])
@pytest.mark.parametrize("n", WORLDS)
def test_pipeline_train_equals_jax(ranks, n, schedule):
    d = _pipe_data(n)
    mesh = _mesh(n, "pp")
    x, tgt, extra = (jnp.asarray(d[k]) for k in ("x", "tgt", "extra"))
    head = {"w": jnp.asarray(d["head_w"])}
    if schedule == "1f1b":
        staged = JPP.group_stages(_stacked(d), n)
        run = jax.jit(lambda st, a, t, h, e: JPP.pipeline_train_1f1b(
            st, a, t, _j_layer, _j_head, h, mesh, "pp", d["n_micro"],
            extra=e))
    else:
        staged = JPP.group_virtual_stages(_stacked(d), n, d["vpp"])
        run = jax.jit(lambda st, a, t, h, e: JPP.pipeline_train_interleaved(
            st, a, t, _j_layer, _j_head, h, mesh, "pp", d["n_micro"],
            vpp=d["vpp"], extra=e))
    loss, gst, gh, dx = run(staged, x, tgt, head, extra)
    for r in range(n):
        g_loss, g_st, g_h, g_dx = ranks["pp"][n][r][schedule]
        np.testing.assert_allclose(g_loss, loss, **TOL)
        for key in ("w", "b"):
            np.testing.assert_allclose(g_st[key], np.asarray(gst[key])[r],
                                       err_msg=key, **TOL)
        np.testing.assert_allclose(g_h["w"], gh["w"], **TOL)
        np.testing.assert_allclose(g_dx, dx, **TOL)


@pytest.mark.parametrize("m,s,v", [(2, 2, 2), (4, 2, 2), (4, 4, 2),
                                   (8, 4, 2), (3, 2, 3), (6, 3, 2),
                                   (5, 4, 4)])
def test_interleaved_schedule_tables_equal_jax(m, s, v):
    want = JPP.build_interleaved_schedule(m, s, v)
    got = TPP.build_interleaved_schedule(m, s, v)
    assert sorted(got) == sorted(want)
    for key, a in want.items():
        np.testing.assert_array_equal(got[key], a, err_msg=key)


@pytest.mark.parametrize("args", [(4, 2, "1f1b", 1), (8, 4, "gpipe", 1),
                                  (4, 4, "interleave", 2),
                                  (16, 8, "interleave", 4),
                                  (1, 2, "1f1b", 1)])
def test_bubble_fraction_equals_jax(args):
    assert TPP.pipeline_bubble_fraction(*args) == \
        JPP.pipeline_bubble_fraction(*args)
    with pytest.raises(AssertionError):
        TPP.pipeline_bubble_fraction(4, 2, "interleave", 1)


@pytest.mark.parametrize("s,v", [(2, 2), (4, 2), (2, 4)])
def test_virtual_stage_layout_equals_jax(s, v):
    a = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    want = JPP.group_virtual_stages({"a": jnp.asarray(a)}, s, v)["a"]
    got = TPP.group_virtual_stages({"a": torch.from_numpy(a)}, s, v)["a"]
    np.testing.assert_array_equal(got.numpy(), want)
    back = TPP.ungroup_virtual_stages({"a": got}, s, v)["a"]
    np.testing.assert_array_equal(back.numpy(), a)
    np.testing.assert_array_equal(
        TPP.group_stages({"a": torch.from_numpy(a)}, s)["a"].numpy(),
        JPP.group_stages({"a": jnp.asarray(a)}, s)["a"])
