"""paddle_tpu_torch's paged verify attention held to the JAX package's on
the CPU: `paged_verify_attention` (its plain version,
`paged_verify_reference`) against JAX's `paged_verify_reference` and
against the Pallas verify kernels run in interpret mode (`use_pallas=True,
interpret=True`), fp32 and int8 pages, over the JAX tests' setup and its
awkward (QH, KVH, G) shapes, with the JAX tests' own limits: fp32 to 2e-5
and int8 to 2e-4 (the same sums in another order; int8 pages dequantize
to values up to 127 times their scale). G = 1 equals the decode plain
version at base + 1. The tensor-core kernel's split of a sequence's
columns over blocks: its plain twin `paged_split_plan` held to its rule
for chunks of several row tiles and on chip_smoke.py's verify batch, and
`paged_split_merge_reference` to JAX's verify reference on chunks that
straddle a split boundary."""
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

ATOL = {False: 2e-5, True: 2e-4}
SHAPES = {"setup": (8, 4, 4), "g2x3": (4, 2, 3), "g2x5": (4, 2, 5),
          "g3x3": (6, 2, 3), "g1x16": (4, 4, 16)}


def _setup(qh=8, kvh=4, g=4, d=64, page=16, num_pages=32, ppseq=4, seed=0,
           quant=False, b=3):
    """The JAX tests' inputs, in numpy: base lengths 5, 17 and the last
    one that keeps base + G inside the owned pages; the table's unused
    page ids hold values that no row may read."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, qh, g, d) * 0.3).astype(np.float32)
    kp = (rng.randn(kvh, num_pages, page, d) * 0.3).astype(np.float32)
    vp = (rng.randn(kvh, num_pages, page, d) * 0.3).astype(np.float32)
    table = rng.permutation(num_pages)[:b * ppseq].reshape(
        b, ppseq).astype(np.int32)
    base = np.asarray([5, 17, page * ppseq - g], np.int32)[:b]
    ks = vs = None
    if quant:
        kq, ks = JP.quantize_kv(jnp.asarray(kp))
        vq, vs = JP.quantize_kv(jnp.asarray(vp))
        kp, vp, ks, vs = (np.array(x) for x in (kq, vq, ks, vs))
    return q, kp, vp, table, base, ks, vs


def _torch(q, kp, vp, table, base, ks, vs, **kw):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return TP.paged_verify_attention(t(q), t(kp), t(vp), t(table), t(base),
                                     k_scale=t(ks), v_scale=t(vs),
                                     **kw).numpy()


def _jax(fn, q, kp, vp, table, base, ks, vs, **kw):
    jn = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return np.asarray(fn(jn(q), jn(kp), jn(vp), jn(table), jn(base),
                         k_scale=jn(ks), v_scale=jn(vs), **kw))


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_matches_jax_reference(quant, shape):
    qh, kvh, g = SHAPES[shape]
    args = _setup(qh=qh, kvh=kvh, g=g, quant=quant)
    got = _torch(*args)
    want = _jax(JP.paged_verify_reference, *args)
    assert got.shape == want.shape == args[0].shape
    np.testing.assert_allclose(got, want, atol=ATOL[quant], rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_matches_pallas_kernel_interpret(quant, shape):
    qh, kvh, g = SHAPES[shape]
    args = _setup(qh=qh, kvh=kvh, g=g, quant=quant, seed=1)
    got = _torch(*args)
    want = _jax(JP.paged_verify_attention, *args, use_pallas=True,
                interpret=True)
    np.testing.assert_allclose(got, want, atol=ATOL[quant], rtol=0)


def test_reference_is_the_plain_version():
    """The wrapper on a CPU tensor is `paged_verify_reference`, bit for
    bit, and launches nothing."""
    args = _setup(seed=2)
    t = torch.from_numpy
    before = (TP.launches_verify, TP.launches_verify_int8)
    got = _torch(*args)
    want = TP.paged_verify_reference(*(t(a) for a in args[:5])).numpy()
    np.testing.assert_array_equal(got, want)
    assert (TP.launches_verify, TP.launches_verify_int8) == before


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_chunk_token_equals_single_token_decode(quant):
    """Token g of the chunk is a decode at length base + g + 1; G = 1 is
    the decode plain version at base + 1."""
    q, kp, vp, table, base, ks, vs = _setup(b=2, g=3, quant=quant, seed=3)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = _torch(q, kp, vp, table, base, ks, vs)
    for g in range(3):
        single = TP.paged_decode_reference(
            t(np.ascontiguousarray(q[:, :, g])), t(kp), t(vp), t(table),
            t(base + g + 1), k_scale=t(ks), v_scale=t(vs)).numpy()
        np.testing.assert_allclose(out[:, :, g], single, atol=ATOL[quant],
                                   rtol=0)
        one = _torch(np.ascontiguousarray(q[:, :, g:g + 1]), kp, vp, table,
                     base + g, ks, vs)
        np.testing.assert_allclose(one[:, :, 0], single, atol=ATOL[quant],
                                   rtol=0)


def test_sm_scale_and_output_dtype():
    q, kp, vp, table, base, _, _ = _setup(seed=4)
    got = _torch(q, kp, vp, table, base, None, None, sm_scale=0.7)
    want = _jax(JP.paged_verify_attention, q, kp, vp, table, base, None,
                None, sm_scale=0.7, use_pallas=True, interpret=True)
    np.testing.assert_allclose(got, want, atol=ATOL[False], rtol=0)
    t = torch.from_numpy
    bf = TP.paged_verify_attention(t(q).bfloat16(), t(kp).bfloat16(),
                                   t(vp).bfloat16(), t(table), t(base))
    assert bf.dtype == torch.bfloat16 and bf.shape == q.shape


def test_scales_come_together():
    q, kp, vp, table, base, ks, _ = _setup(quant=True)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="together"):
        TP.paged_verify_attention(t(q), t(kp), t(vp), t(table), t(base),
                                  k_scale=t(ks))


def test_wrapper_raises_off_cpu_and_cuda():
    meta = {"device": "meta"}
    q = torch.empty((3, 4, 2, 16), **meta)
    pages = torch.empty((2, 5, 8, 16), **meta)
    table = torch.zeros((3, 2), dtype=torch.int32, **meta)
    base = torch.zeros((3,), dtype=torch.int32, **meta)
    before = (TP.launches_verify, TP.launches_verify_int8)
    with pytest.raises(ValueError, match="meta"):
        TP.paged_verify_attention(q, pages, pages, table, base)
    assert (TP.launches_verify, TP.launches_verify_int8) == before


# ------------------------------------------ the tensor-core kernel's split
def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("group,g", [(1, 64), (3, 30), (4, 4), (4, 64),
                                     (64, 3)])
def test_split_plan_covers_each_row_once(group, g):
    """A chunk of G tokens in row tiles of 64 // group tokens: every
    column below each token's own limit lies in exactly one split of its
    tile, a tile's lim is its last token's limit, and no split starts at
    or past it."""
    bases = [0, 120, 250, 1000, 2040 - g]
    cap = 2048
    plan = TP.paged_split_plan([b + 1 for b in bases], group, g, 2, 256, 132,
                               cap, 128)
    per_tile = 64 // group
    assert plan["row_tiles"] == -(-g // per_tile)
    for base, row in zip(bases, plan["tiles"]):
        assert len(row) == plan["row_tiles"]
        for rt, (lim, parts) in enumerate(row):
            toks = range(rt * per_tile, min((rt + 1) * per_tile, g))
            assert lim == min(base + toks[-1] + 1, cap)
            seen = np.zeros(cap, np.int64)
            for kt0, kt1 in parts:
                assert kt0 * 64 < lim
                seen[kt0 * 64:min(kt1 * 64, lim)] += 1
            for tok in toks:
                np.testing.assert_array_equal(
                    seen[:min(base + tok + 1, cap)], 1)


def test_split_plan_of_the_chip_smoke_verify_batch():
    """chip_smoke.py's verify batch (the 8 live slots before a G = 4
    chunk, KVH 8) at S = 256 on 132 SMs: one row tile of 16 rows a KV
    head, 140 k tiles and 37 splits a KV head (296 working blocks; 27 at
    the kernel's S = 384); a G = 64 chunked-prefill step there (256
    blocks, under 2 x 132) does not split: two splits' partials, 17 MB,
    pass MAX_SPLIT_WORKSPACE."""
    smoke = _chip_smoke()
    shape = smoke.DECODE_SHAPE
    kvh, group = shape["KVH"], shape["QH"] // shape["KVH"]
    lims = [b + 1 for b in smoke.VERIFY_BASES]
    plan = TP.paged_split_plan(lims, group, smoke.VERIFY_G, kvh, 256, 132,
                               shape["MAX_LEN"], shape["D"])
    assert (plan["k_tiles"], plan["splits"], plan["row_tiles"]) == \
        (140, 37, 1)
    assert plan["splits"] * kvh == 296 and plan["blocks"] == 512
    plan = TP.paged_split_plan(lims, group, smoke.VERIFY_G, kvh,
                               TP.SPLIT_COLS, 132, shape["MAX_LEN"],
                               shape["D"])
    assert (plan["k_tiles"], plan["splits"]) == (140, 27)
    wide = TP.paged_split_plan(lims, group, 64, kvh, 256, 132,
                               shape["MAX_LEN"], shape["D"])
    assert wide["row_tiles"] == 4 and wide["max_splits"] == 1


@pytest.mark.parametrize("g,k_tiles,row_tiles", [(512, 3176, 32),
                                                 (2048, 24864, 128)])
def test_split_plan_of_the_chip_smoke_suffix_prefill(g, k_tiles, row_tiles):
    """chip_smoke.py's suffix-prefill verify calls (prefix_kernel (a)):
    8 slots of 3072 columns, one active at base 1024, a chunk of G = 512
    or 2048 rows. B x KVH x row tiles (2048 or 8192 blocks) is past 2 x
    SMs, so nothing splits: one working block a (slot, KV head, row
    tile), the k tiles the plan counts."""
    smoke = _chip_smoke()
    shape = smoke.DECODE_SHAPE
    kvh, group = shape["KVH"], shape["QH"] // shape["KVH"]
    lims = [b + 1 for b in smoke.PREFIX_VERIFY_BASES]
    assert (len(lims), lims[0]) == (8, 1025)
    assert g in [G for _, G in smoke.PREFIX_SUFFIXES]
    plan = TP.paged_split_plan(lims, group, g, kvh, TP.SPLIT_COLS, 132,
                               smoke.PREFIX_VERIFY_CAP, shape["D"])
    assert (plan["k_tiles"], plan["row_tiles"], plan["max_splits"]) == \
        (k_tiles, row_tiles, 1)
    assert plan["splits"] == plan["blocks"] // kvh == 8 * row_tiles
    assert TP.split_rule(8, kvh, group, g, smoke.PREFIX_VERIFY_CAP,
                         shape["D"], 132)[1] == 1


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("kvh,group,g", [(4, 1, 5), (2, 3, 3), (2, 4, 4)],
                         ids=["g1", "g3", "g4"])
def test_split_merge_reference_matches_jax(quant, kvh, group, g):
    """Chunks that straddle a split boundary of 128 columns (and one at
    the pages' end), each split's partial state merged: JAX's verify
    reference, at this file's limits."""
    page, ppseq = 16, 12
    q, kp, vp, table, _, ks, vs = _setup(qh=kvh * group, kvh=kvh, g=g, d=32,
                                         page=page, num_pages=4 * ppseq + 1,
                                         ppseq=ppseq, seed=5, quant=quant,
                                         b=4)
    base = np.asarray([128 - g // 2, 126, 0, page * ppseq - g], np.int32)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = TP.paged_split_merge_reference(t(q), t(kp), t(vp), t(table),
                                         t(base), 128, k_scale=t(ks),
                                         v_scale=t(vs)).numpy()
    want = _jax(JP.paged_verify_reference, q, kp, vp, table, base, ks, vs)
    np.testing.assert_allclose(got, want, atol=ATOL[quant], rtol=0)
