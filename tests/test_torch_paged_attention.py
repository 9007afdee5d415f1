"""paddle_tpu_torch's paged decode attention held to the JAX package's on
the CPU: `paged_attention` (its plain version) against JAX's
`paged_attention_reference` for rows of length >= 1, and against the
Pallas decode kernels run in interpret mode (`use_pallas=True,
interpret=True`) for every row, length 0 included; fp32 and int8 pages,
GQA groups 1, 2 and 4, page-table entries past a row's length pointing
at the trash page. fp32 to 1e-5: the same sums in another order.

A length-0 row is where the two JAX sides differ: the reference's
softmax over all-masked scores is uniform (the mean of the gathered V),
the kernel skips every page and writes zeros. The port follows the
kernel; engines discard such rows (free slots).

The tensor-core kernel's split of a sequence's columns over blocks is
held here on the CPU: its plain twin `paged_split_plan` to its rule (on
chip_smoke.py's decode batch too), and `paged_split_merge_reference`,
the split-then-merge arithmetic, to JAX's reference; `route` to its
rule."""
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as TP

# the module itself: `paddle_tpu.ops` exports a function of the same name
JP = importlib.import_module("paddle_tpu.ops.paged_attention")

ATOL = 1e-5
LENGTHS = [13, 5, 0, 32, 1]


def _batch(kvh, group, quant, d=16, page=8, pps=5, seed=0):
    """Pools with a trash page (the last) full of large values, a page
    table whose entries past each row's length point at it, and q."""
    rng = np.random.default_rng(seed)
    b = len(LENGTHS)
    npg = b * pps + 1
    shape = (kvh, npg, page, d)
    ptab = np.full((b, pps), npg - 1, np.int32)
    perm = rng.permutation(npg - 1)
    for i, n in enumerate(LENGTHS):
        used = -(-n // page)
        ptab[i, :used] = perm[i * pps:i * pps + used]
    if quant:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, shape[:-1] + (1,)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, shape[:-1] + (1,)).astype(np.float32)
        ks[:, -1] = vs[:, -1] = 50.0
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        kp[:, -1] = vp[:, -1] = 1e4
        ks = vs = None
    q = rng.standard_normal((b, kvh * group, d)).astype(np.float32)
    return q, kp, vp, ptab, np.asarray(LENGTHS, np.int32), ks, vs


def _torch(q, kp, vp, ptab, lens, ks, vs):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return TP.paged_attention(t(q), t(kp), t(vp), t(ptab), t(lens),
                              k_scale=t(ks), v_scale=t(vs)).numpy()


def _jax(q, kp, vp, ptab, lens, ks, vs, **kw):
    jn = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return np.asarray(JP.paged_attention(
        jn(q), jn(kp), jn(vp), jn(ptab), jn(lens), k_scale=jn(ks),
        v_scale=jn(vs), **kw))


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("kvh,group", [(4, 1), (2, 2), (2, 4)],
                         ids=["g1", "g2", "g4"])
def test_matches_jax_reference_for_nonempty_rows(quant, kvh, group):
    args = _batch(kvh, group, quant)
    got = _torch(*args)
    want = _jax(*args, use_pallas=False, interpret=False)
    live = args[4] > 0
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("kvh,group", [(4, 1), (2, 2), (2, 4)],
                         ids=["g1", "g2", "g4"])
def test_matches_pallas_kernel_interpret_every_row(quant, kvh, group):
    args = _batch(kvh, group, quant, seed=1)
    got = _torch(*args)
    want = _jax(*args, use_pallas=True, interpret=True)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.all(got[args[4] == 0] == 0)


def test_reference_copy_equals_jax_reference_length0_included():
    """The copied JAX reference keeps its length-0 answer (the mean of
    the gathered V), which the decode plain version does not."""
    q, kp, vp, ptab, lens, _, _ = _batch(2, 2, False, seed=2)
    t = torch.from_numpy
    got = TP.paged_attention_reference(t(q), t(kp), t(vp), t(ptab),
                                       t(lens)).numpy()
    want = np.asarray(JP.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ptab),
        jnp.asarray(lens)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    dec = TP.paged_decode_reference(t(q), t(kp), t(vp), t(ptab),
                                    t(lens)).numpy()
    assert np.abs(got[lens == 0]).max() > 0.1
    assert np.all(dec[lens == 0] == 0)
    np.testing.assert_array_equal(dec[lens > 0] != 0, got[lens > 0] != 0)


def test_sm_scale_and_output_dtype():
    q, kp, vp, ptab, lens, _, _ = _batch(2, 2, False, seed=3)
    t = torch.from_numpy
    got = TP.paged_attention(t(q), t(kp), t(vp), t(ptab), t(lens),
                             sm_scale=0.7)
    want = np.asarray(JP.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ptab),
        jnp.asarray(lens), sm_scale=0.7, use_pallas=True, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    bf = TP.paged_attention(t(q).bfloat16(), t(kp).bfloat16(),
                            t(vp).bfloat16(), t(ptab), t(lens))
    assert bf.dtype == torch.bfloat16


def test_scales_come_together():
    q, kp, vp, ptab, lens, ks, _ = _batch(2, 2, True)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="together"):
        TP.paged_attention(t(q), t(kp), t(vp), t(ptab), t(lens),
                           k_scale=t(ks))


def test_wrapper_raises_off_cpu_and_cuda():
    meta = {"device": "meta"}
    q = torch.empty((3, 4, 16), **meta)
    pages = torch.empty((2, 5, 8, 16), **meta)
    ptab = torch.zeros((3, 2), dtype=torch.int32, **meta)
    lens = torch.zeros((3,), dtype=torch.int32, **meta)
    before = (TP.launches_decode, TP.launches_decode_int8)
    with pytest.raises(ValueError, match="meta"):
        TP.paged_attention(q, pages, pages, ptab, lens)
    assert (TP.launches_decode, TP.launches_decode_int8) == before


# ------------------------------------------ the tensor-core kernel's split
ROOT = Path(__file__).resolve().parent.parent


def _script(rel):
    """A script of the repo (chip_smoke.py, a tool) as a module; their
    top levels import only the standard library."""
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# split-boundary lengths at S = 128: S - 1, S, S + 1, 64k +- 1, 0 and 1
SPLIT_LENGTHS = [127, 128, 129, 191, 193, 0, 1, 255, 257, 63, 65]


@pytest.mark.parametrize("split_cols", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 3, 4, 64])
def test_split_plan_covers_each_column_once(group, split_cols):
    """Every column below a row's limit lies in exactly one split, no
    split starts at or past its tile's lim, and a split is a multiple of
    64 columns wide."""
    cap = 1024
    plan = TP.paged_split_plan(SPLIT_LENGTHS, group, 1, 2, split_cols, 132,
                               cap, 128)
    assert plan["split_cols"] % 64 == 0 and plan["max_splits"] > 1
    assert plan["max_splits"] * plan["split_cols"] >= cap
    for n, row in zip(SPLIT_LENGTHS, plan["tiles"]):
        (lim, parts), = row
        assert lim == min(n, cap)
        seen = np.zeros(cap, np.int64)
        for kt0, kt1 in parts:
            assert kt0 * 64 < lim and kt0 < kt1
            assert (kt1 - kt0) * 64 <= plan["split_cols"]
            assert kt0 * 64 % plan["split_cols"] == 0
            seen[kt0 * 64:min(kt1 * 64, lim)] += 1
        np.testing.assert_array_equal(seen[:lim], 1)
        assert seen[lim:].sum() == 0
    assert plan["k_tiles"] == sum(-(-min(n, cap) // 64)
                                  for n in SPLIT_LENGTHS)


@pytest.mark.parametrize("batch,kvh,n_sm,split", [
    (9, 8, 132, True), (33, 8, 132, False), (32, 8, 132, True),
    (66, 4, 132, False), (65, 4, 132, True), (8, 1, 4, False),
    (3, 1, 4, True)])
def test_split_rule_follows_the_shapes(batch, kvh, n_sm, split):
    """No split when batch x KVH x row tiles blocks fill twice the SMs
    (decode: one row tile), splits of S = 256 otherwise; the lengths
    play no part."""
    cap = 2048
    for lens in ([2000] * batch, [1] * batch):
        plan = TP.paged_split_plan(lens, 4, 1, kvh, 256, n_sm, cap, 128)
        assert (plan["max_splits"] > 1) == split
        if split:
            assert plan["split_cols"] == 256 and plan["max_splits"] == 8
        else:
            assert plan["split_cols"] >= cap
            assert all(len(parts) <= 1 for row in plan["tiles"]
                       for _, parts in row)
        assert plan["blocks"] == batch * kvh * plan["max_splits"]


@pytest.mark.parametrize("cap", [2048, 8192, 32768, 131072])
@pytest.mark.parametrize("batch,kvh,group,n_tok,d", [
    (8, 8, 4, 1, 128), (1, 8, 4, 1, 128), (8, 8, 4, 16, 128),
    (8, 8, 4, 64, 128), (4, 2, 4, 64, 128), (3, 2, 64, 1, 32),
    (2, 1, 1, 1, 64)])
def test_split_workspace_is_bounded_whatever_the_cap(batch, kvh, group,
                                                     n_tok, d, cap):
    """The fp32 partials of a split launch (rows x splits x (D + 2)
    floats) stay within MAX_SPLIT_WORKSPACE however long the slots: S
    grows with the cap, by 64s, from SPLIT_COLS, the splits still cover
    every column, and a launch whose two splits would pass the budget
    (a G = 64 chunk on 8 slots of KVH 8) does not split."""
    n_sm = 132
    s, ns = TP.split_rule(batch, kvh, group, n_tok, cap, d, n_sm)
    rows = batch * kvh * group * n_tok
    per_split = rows * (d + 2) * 4
    assert s % 64 == 0 and (ns - 1) * s < cap <= ns * s
    if ns > 1:
        assert s >= TP.SPLIT_COLS
        assert rows * ns * (d + 2) * 4 <= TP.MAX_SPLIT_WORKSPACE
    if -(-cap // TP.SPLIT_COLS) * per_split <= TP.MAX_SPLIT_WORKSPACE and \
            cap > TP.SPLIT_COLS:
        assert s == TP.SPLIT_COLS
    assert (ns > 1) == (2 * per_split <= TP.MAX_SPLIT_WORKSPACE and
                        cap > TP.SPLIT_COLS)
    if (batch, n_tok) == (8, 64):
        assert ns == 1


def test_split_sweep_tool_needs_a_card():
    """tools/paged_split_sweep.py times the kernels on a CUDA card only:
    without one it returns 2 before it builds or times anything."""
    assert _script("tools/paged_split_sweep.py").main([]) == 2


def test_split_plan_of_the_chip_smoke_decode_batch():
    """chip_smoke.py's decode batch (8 slots of 100-2000 tokens and a
    free one, KVH 8) at S = 256 on 132 SMs: 140 k tiles and 37 splits a
    KV head, 296 working blocks of a grid of 576, at most 4 k tiles a
    block where one block a slot walked up to 32; at the kernel's S =
    384, 27 splits."""
    smoke = _script("chip_smoke.py")
    shape = smoke.DECODE_SHAPE
    plan = TP.paged_split_plan(smoke.DECODE_LENS, shape["QH"] // shape["KVH"],
                               1, shape["KVH"], 256, 132, shape["MAX_LEN"],
                               shape["D"])
    assert (plan["k_tiles"], plan["splits"]) == (140, 37)
    assert plan["splits"] * shape["KVH"] == 296 and plan["blocks"] == 576
    assert max(kt1 - kt0 for row in plan["tiles"] for _, parts in row
               for kt0, kt1 in parts) == 4
    # the width the kernel takes (measured best there): 27 splits a KV
    # head, 216 working blocks, one wave at 2 blocks an SM
    plan = TP.paged_split_plan(smoke.DECODE_LENS, shape["QH"] // shape["KVH"],
                               1, shape["KVH"], TP.SPLIT_COLS, 132,
                               shape["MAX_LEN"], shape["D"])
    assert TP.SPLIT_COLS == 384
    assert (plan["k_tiles"], plan["splits"], plan["blocks"]) == \
        (140, 27, 432)


def _quantize_pool(rng, shape):
    """An int8 pool and its scales as the engine quantizes them."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return tuple(a.numpy() for a in TP.quantize_kv(x))


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("kvh,group", [(4, 1), (2, 3), (2, 4)],
                         ids=["g1", "g3", "g4"])
def test_split_merge_reference_matches_jax(quant, kvh, group):
    """Partial softmax states over splits of 128 columns, merged, are the
    JAX reference on every live row at split boundaries and 64k +- 1;
    a length-0 row is exactly 0."""
    rng = np.random.default_rng(group)
    b, d, page, pps = len(SPLIT_LENGTHS), 16, 16, 17
    npg = b * pps + 1
    shape = (kvh, npg, page, d)
    ptab = rng.permutation(npg - 1)[:b * pps].reshape(b, pps).astype(np.int32)
    if quant:
        (kp, ks), (vp, vs) = (_quantize_pool(rng, shape) for _ in range(2))
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    q = rng.standard_normal((b, kvh * group, d)).astype(np.float32)
    lens = np.asarray(SPLIT_LENGTHS, np.int32)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = TP.paged_split_merge_reference(
        t(q)[:, :, None], t(kp), t(vp), t(ptab), t(lens - 1), 128,
        k_scale=t(ks), v_scale=t(vs))[:, :, 0].numpy()
    want = _jax(q, kp, vp, ptab, lens, ks, vs, use_pallas=False,
                interpret=False)
    live = lens > 0
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=0)
    assert np.all(got[~live] == 0)


@pytest.mark.parametrize("q_dtype,kv_dtype,d,group,want", [
    (torch.bfloat16, torch.bfloat16, 128, 4, TP.TENSOR_CORES),
    (torch.bfloat16, torch.int8, 128, 4, TP.TENSOR_CORES),
    (torch.bfloat16, torch.bfloat16, 64, 4, TP.TENSOR_CORES),
    (torch.bfloat16, torch.int8, 64, 1, TP.TENSOR_CORES),
    (torch.bfloat16, torch.bfloat16, 256, 4, TP.CUDA_CORES),
    (torch.bfloat16, torch.int8, 256, 4, TP.CUDA_CORES),
    (torch.float32, torch.float32, 128, 4, TP.CUDA_CORES),
    (torch.float32, torch.int8, 128, 4, TP.CUDA_CORES)])
def test_route_rule(q_dtype, kv_dtype, d, group, want):
    """bf16 q over bf16 or int8 pages at D 64 and 128 takes the tensor
    cores; fp32 q (either pool) and D 256 the CUDA cores."""
    assert TP.route(q_dtype, kv_dtype, d, group) == want


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::paged_tc_kernel<128, __nv_bfloat16>("
    "(anonymous namespace)::PagedArgs)",
    "void (anonymous namespace)::paged_tc_kernel<128, signed char>("
    "(anonymous namespace)::PagedArgs)",
    "(anonymous namespace)::paged_merge_kernel((anonymous namespace)::"
    "PagedArgs)",
    "void (anonymous namespace)::decode_kernel<float, float>(...)",
    "void (anonymous namespace)::verify_kernel<float, float, 16, 4>(...)"])
def test_serving_profile_groups_the_paged_kernels(name):
    """tools/profile_torch_serving.py charges both designs and the merge
    to the paged source."""
    assert _script("tools/profile_torch_serving.py")._group(name) == \
        "attention (paged_attention.cu)"
