"""paddle_tpu_torch's varlen attention forward held to the JAX package's
on the CPU: `rev_pos` and `seg_ids_from_cu_seqlens` equal JAX's, and
`flash_attention_varlen` / `varlen_fwd_reference` agree with JAX's
`varlen_reference` and with the Pallas kernel `_vfwd_pallas` run in
interpret mode (o and lse), causal and not, same and unequal
cu_seqlens, GQA, and padding rows (o = 0, lse = -1e30). fp32 to 1e-5:
the same sums in another order. The bf16 kernels' tile rule
(`tile_plan`) is held to the dense mask and to `chip_smoke.py`'s count,
the dK/dV kernel's walk over it by columns (`dkv_walk`) to `tile_plan`,
and the wrapper's pad and realign step to the plain version and JAX."""
import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops import varlen_attention as JV
from paddle_tpu_torch.ops import varlen_attention as TV
from paddle_tpu_torch.ops.flash_attention import tensor_core_operands

ATOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent


def _script(rel):
    """A script of the repo (chip_smoke.py, a tool) as a module; their
    top levels import only the standard library."""
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seg(lens, total, pad):
    s = np.full((total,), pad, np.int32)
    s[:sum(lens)] = np.repeat(np.arange(len(lens)), lens)
    return s


def _cu(lens, slots):
    cu = np.zeros((slots + 1,), np.int32)
    cu[1:len(lens) + 1] = np.cumsum(lens)
    cu[len(lens) + 1:] = sum(lens)
    return cu


def _qkv(tq, tk, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((tq, h, d)).astype(np.float32),
            rng.standard_normal((tk, kvh, d)).astype(np.float32),
            rng.standard_normal((tk, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("seg", [
    [0, 0, 0, 1, 1, 2, -1, -1],
    [0, 1, 2, 3],
    [0, 0, 0, 0, -2, -2, -2],
    [3, 3, 7, 7, 7, 7, -1],
    [-1, -1]])
def test_rev_pos_equals_jax(seg):
    seg = np.asarray(seg, np.int32)
    want = np.asarray(JV.rev_pos(jnp.asarray(seg)))
    got = TV.rev_pos(torch.from_numpy(seg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lens,slots,total", [
    ([5, 3, 7], 4, 20), ([1], 3, 1), ([4, 0, 2], 5, 8), ([6, 6], 2, 16)])
def test_seg_ids_from_cu_seqlens_equals_jax(lens, slots, total):
    cu = _cu(lens, slots)
    want = np.asarray(JV.seg_ids_from_cu_seqlens(jnp.asarray(cu), total))
    got = TV.seg_ids_from_cu_seqlens(torch.from_numpy(cu), total)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# (q segment lengths, Tq, k segment lengths, Tk): same offsets, and
# unequal (more keys than queries: bottom-right causal alignment)
LAYOUTS = {"same": ([9, 30, 1, 20], 70, None, None),
           "unequal": ([9, 25, 12], 50, [14, 25, 30], 80)}


def _case(layout, h, kvh, d=16, seed=0):
    lq, tq, lk, tk = LAYOUTS[layout]
    seg_q = _seg(lq, tq, -1)
    seg_k = seg_q if lk is None else _seg(lk, tk, -2)
    q, k, v = _qkv(tq, len(seg_k), h, kvh, d, seed)
    return q, k, v, seg_q, seg_k


def _jax_reference(q, k, v, seg_q, seg_k, causal, scale):
    """JAX's varlen_reference on (T, H, D) numpy operands, K/V repeated to
    the query heads: (o (Tq, H, D), lse (H, Tq)) as numpy."""
    rep = q.shape[1] // k.shape[1]
    jo, jl = JV.varlen_reference(
        jnp.asarray(q).swapaxes(0, 1),
        jnp.repeat(jnp.asarray(k), rep, axis=1).swapaxes(0, 1),
        jnp.repeat(jnp.asarray(v), rep, axis=1).swapaxes(0, 1),
        jnp.asarray(np.where(seg_q < 0, -1, seg_q)),
        jnp.asarray(np.where(seg_k < 0, -2, seg_k)), causal, scale)
    return np.asarray(jo).swapaxes(0, 1), np.asarray(jl)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 2)],
                         ids=["g1", "g2", "g4"])
def test_matches_jax_reference(causal, layout, h, kvh):
    q, k, v, seg_q, seg_k = _case(layout, h, kvh)
    scale = 16 ** -0.5
    jo, jl = _jax_reference(q, k, v, seg_q, seg_k, causal, scale)
    t = torch.from_numpy
    o, lse = TV.varlen_fwd_reference(t(q), t(k), t(v), t(seg_q), t(seg_k),
                                     causal, scale)
    np.testing.assert_allclose(o.numpy(), jo, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), jl, atol=ATOL, rtol=1e-6)
    # the public entry on a CPU tensor is the plain version, and agrees
    # with the JAX entry (its XLA path)
    want = JV.flash_attention_varlen(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg_q),
        jnp.asarray(seg_k), causal=causal, use_pallas=False, interpret=False,
        same_offsets=layout == "same")
    got = TV.flash_attention_varlen(t(q), t(k), t(v), t(seg_q), t(seg_k),
                                    causal=causal,
                                    same_offsets=layout == "same")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _pad_to(a, n, value):
    out = np.full((n,) + a.shape[1:], value, a.dtype)
    out[:len(a)] = a
    return out


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_matches_pallas_kernel_interpret(causal, layout):
    """o and lse of the TPU kernel, run in interpret mode on inputs
    padded to its blocks (q to 64 rows, k to 128 columns), against the
    plain version on the unpadded ones."""
    h, kvh, d = 4, 2, 16
    q, k, v, seg_q, seg_k = _case(layout, h, kvh, d, seed=1)
    scale = d ** -0.5
    sq = np.where(seg_q < 0, -1, seg_q).astype(np.int32)
    sk = np.where(seg_k < 0, -2, seg_k).astype(np.int32)
    tq, tk = len(sq), len(sk)
    tq_p, tk_p = -(-tq // 64) * 64, -(-tk // 128) * 128
    pq = np.asarray(JV.rev_pos(jnp.asarray(sq)))
    pk = np.asarray(JV.rev_pos(jnp.asarray(sk)))
    kr, vr = np.repeat(k, h // kvh, 1), np.repeat(v, h // kvh, 1)
    jo, jl = JV._vfwd_pallas(
        jnp.asarray(_pad_to(q, tq_p, 0).swapaxes(0, 1)),
        jnp.asarray(_pad_to(kr, tk_p, 0).swapaxes(0, 1)),
        jnp.asarray(_pad_to(vr, tk_p, 0).swapaxes(0, 1)),
        jnp.asarray(_pad_to(sq, tq_p, -1)), jnp.asarray(_pad_to(sk, tk_p, -2)),
        jnp.asarray(_pad_to(pq, tq_p, 0)), jnp.asarray(_pad_to(pk, tk_p, 0)),
        causal, layout == "same", scale, 64, 128, True)
    t = torch.from_numpy
    o, lse = TV.varlen_fwd_reference(t(q), t(k), t(v), t(seg_q), t(seg_k),
                                     causal, scale)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(jo)[:, :tq].swapaxes(0, 1), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[:, :tq],
                               atol=ATOL, rtol=1e-6)


def test_rows_that_see_nothing_give_zero_and_neg_lse():
    """Padding rows, and a query segment with no key of its own id,
    give o = 0 and lse = -1e30, as the TPU kernel writes them."""
    q, k, v = _qkv(12, 10, 2, 1, 8, seed=2)
    seg_q = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, -1, -1, -1], np.int32)
    seg_k = np.array([0, 0, 0, 0, 2, 2, 2, -1, -1, -1], np.int32)
    t = torch.from_numpy
    for causal in (True, False):
        o, lse = TV.varlen_fwd_reference(t(q), t(k), t(v), t(seg_q),
                                         t(seg_k), causal, 0.3)
        dead = (seg_q < 0) | (seg_q == 1)
        assert bool((o[dead] == 0).all())
        assert bool((lse[:, dead] == -1e30).all())
        assert bool(torch.isfinite(o).all())
        assert bool((lse[:, ~dead] > -1e29).all())


def test_same_offsets_defaults_to_seg_identity():
    """same_offsets=None means `seg_q is seg_k`, as in JAX: the answer
    does not change, only which tiles the kernel may skip."""
    q, k, v, seg_q, _ = _case("same", 4, 2)
    t = torch.from_numpy
    s = t(seg_q)
    a = TV.flash_attention_varlen(t(q), t(k), t(v), s, s, causal=True)
    b = TV.flash_attention_varlen(t(q), t(k), t(v), s, s.clone(), causal=True,
                                  same_offsets=False)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_raises_off_cpu_and_cuda():
    meta = {"device": "meta"}
    q = torch.empty((8, 4, 16), **meta)
    kv = torch.empty((8, 2, 16), **meta)
    seg = torch.zeros((8,), dtype=torch.int32, **meta)
    before = TV.launches_fwd
    with pytest.raises(ValueError, match="meta"):
        TV.flash_attention_varlen(q, kv, kv, seg, seg, causal=True)
    assert TV.launches_fwd == before


# The bf16 kernel's tile rule. (q segment lengths, Tq, k segment lengths
# or None for the same ids and offsets, Tk): LAYOUTS' two; segments
# ending and pads starting inside a tile, with tiles wholly inside one
# segment; Tq of 1, 63 and 65; unequal offsets with a key segment no
# query has.
PLAN_LAYOUTS = {**LAYOUTS,
                "packed": ([130, 64, 200, 1, 70], 520, None, None),
                "t1": ([1], 1, None, None),
                "t63": ([20, 43], 63, None, None),
                "t65": ([30, 33], 65, None, None),
                "unequal_long": ([100, 150], 260, [130, 200, 40], 400)}


def _plan_segs(layout):
    lq, tq, lk, tk = PLAN_LAYOUTS[layout]
    seg_q = torch.from_numpy(_seg(lq, tq, -1))
    seg_k = seg_q if lk is None else torch.from_numpy(_seg(lk, tk, -2))
    return seg_q, seg_k, lk is None


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("layout", sorted(PLAN_LAYOUTS))
def test_tile_plan_is_sound(layout, causal):
    """Against the dense visibility mask (held to JAX's above): no kept
    pair in a skipped tile; every pair of a full tile kept, and no pad
    row or column past an axis in it; and the kept tiles are exactly
    those `chip_smoke.py` counts (`_varlen_tiles`)."""
    seg_q, seg_k, same = _plan_segs(layout)
    plan = TV.tile_plan(seg_q, seg_k, causal, same)
    sq, sk = TV._sentinels(seg_q, seg_k)
    keep = TV._visible(sq, sk, causal)
    tq, tk = len(sq), len(sk)
    n_qt, n_kt = plan.shape
    assert (n_qt, n_kt) == (-(-tq // 64), -(-tk // 64))
    for qt in range(n_qt):
        for kt in range(n_kt):
            rows, cols = slice(qt * 64, qt * 64 + 64), slice(kt * 64,
                                                              kt * 64 + 64)
            blk = keep[rows, cols]
            if plan[qt, kt] == TV.SKIP:
                assert not blk.any(), (qt, kt)
            if plan[qt, kt] == TV.FULL:
                assert blk.shape == (64, 64) and blk.all(), (qt, kt)
                assert (sq[rows] >= 0).all() and (sk[cols] >= 0).all()
    want, _ = _script("chip_smoke.py")._varlen_tiles(
        sq.numpy(), sk.numpy(), causal and same)
    assert int((plan != TV.SKIP).sum()) == want


@pytest.mark.parametrize("wave", ["serve_prefill", "train_packed"])
def test_tile_plan_counts_at_the_main_paths(wave):
    """The tiles a head computes at chip_smoke.py's two varlen shapes,
    causal with same offsets: 666 at the serve prefill wave (its 8
    prompts in an 8192 bucket) and 1,904 at train_packed's row (eight
    documents in 8192), as `_varlen_tiles` counts them; tiles wholly
    inside one document under the diagonal are kept whole."""
    cs = _script("chip_smoke.py")
    lens = cs._serve_rng()[1] if wave == "serve_prefill" else cs.PACKED_DOCS
    seg = cs._segments(lens, 8192)
    plan = TV.tile_plan(torch.from_numpy(seg), torch.from_numpy(seg), True,
                        True)
    kept = int((plan != TV.SKIP).sum())
    assert kept == cs._varlen_tiles(seg, seg, True)[0]
    assert kept == {"serve_prefill": 666, "train_packed": 1904}[wave]
    assert int((plan == TV.FULL).sum()) > 0


# chip_smoke.py's VARLEN_BWD_CASES: the layouts its varlen_kernel phase
# runs the backward kernels on (`_varlen_case_segs`)
BWD_CASES = ("causal_same", "causal_unequal", "noncausal_unequal",
             "masked_rows", "unseen_keys")


def _random_segs(seed):
    """A random packed layout: seg_q and seg_k of up to 700 tokens,
    segments of 1-200 tokens with non-decreasing ids (some ids on one
    side only), padding trailing."""
    rng = np.random.default_rng(seed)

    def side(ids, pad):
        lens = rng.integers(1, 200, size=len(ids))
        seg = np.repeat(ids, lens).astype(np.int32)
        return np.concatenate([seg, np.full(rng.integers(0, 130), pad,
                                            np.int32)])
    ids = np.sort(rng.choice(12, size=rng.integers(1, 6), replace=False))
    return side(ids, -1), side(ids[rng.random(len(ids)) < 0.8], -2)


def _walk_equals_plan(seg_q, seg_k, causal, same):
    begin, end, plan = TV.dkv_walk(seg_q, seg_k, causal, same)
    want = TV.tile_plan(seg_q, seg_k, causal, same).T
    assert torch.equal(plan, want)
    n_kt, n_qt = want.shape
    assert begin.shape == end.shape == (n_kt,)
    # every kept tile lies in its k tile's walk
    qt = torch.arange(n_qt)[None, :]
    kept = want != TV.SKIP
    assert not (kept & ((qt < begin[:, None]) | (qt >= end[:, None]))).any()


@pytest.mark.parametrize("same", [False, True], ids=["offsets", "same"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", BWD_CASES + ("train_packed",))
def test_dkv_walk_reads_tile_plan_by_columns(case, causal, same):
    """The bf16 dK/dV kernel's walk (`dkv_walk`: q_begin, q_end,
    needed_q and full_q per k tile) decides every tile as `tile_plan`
    does by rows, on chip_smoke.py's backward layouts and on
    train_packed's row (eight documents in 8192 tokens), with and
    without causal masking and same offsets."""
    cs = _script("chip_smoke.py")
    assert set(BWD_CASES) == set(cs.VARLEN_BWD_CASES)
    if case == "train_packed":
        seg_q = seg_k = cs._segments(cs.PACKED_DOCS, 8192)
    else:
        seg_q, seg_k, _, _ = cs._varlen_case_segs(case)
    _walk_equals_plan(torch.from_numpy(seg_q), torch.from_numpy(seg_k),
                      causal, same)


@pytest.mark.parametrize("seed", range(8))
def test_dkv_walk_reads_tile_plan_on_random_layouts(seed):
    """As above on random non-decreasing segment layouts, q and k ids
    apart and shared, every combination of causal and same offsets."""
    seg_q, seg_k = (torch.from_numpy(x) for x in _random_segs(seed))
    for causal in (False, True):
        for same in (False, True):
            _walk_equals_plan(seg_q, seg_k, causal, same)
            _walk_equals_plan(seg_q, seg_q, causal, same)


def test_dkv_walk_visits_the_packed_rows_kept_tiles():
    """On train_packed's row, causal with same offsets: 1,904 kept tiles
    a head, the k tiles walking from the diagonal, and no k tile of the
    last document walking before it."""
    cs = _script("chip_smoke.py")
    seg = torch.from_numpy(cs._segments(cs.PACKED_DOCS, 8192))
    begin, end, plan = TV.dkv_walk(seg, seg, True, True)
    assert int((plan != TV.SKIP).sum()) == 1904
    assert torch.equal(begin, torch.arange(128))
    assert bool((end == 128).all())


def _strided(x, d, kind):
    """(T, H, d) views of x's values as the bf16 wrapper may receive
    them: contiguous; a column slice of a fused projection whose rows
    are 2 * d * H + 3 elements apart (not 16-byte aligned); a contiguous
    view one element into its storage (base not 16-byte aligned)."""
    t, h, _ = x.shape
    if kind == "contiguous":
        return x.clone()
    if kind == "fused_odd_rows":
        store = torch.zeros((t, 2 * h * d + 3), dtype=x.dtype)
        store[:, 3:3 + h * d] = x.reshape(t, h * d)
        return store[:, 3:3 + h * d].unflatten(1, (h, d))
    store = torch.zeros(x.numel() + 1, dtype=x.dtype)
    view = store[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("kind", ["contiguous", "fused_odd_rows",
                                  "offset_base"])
@pytest.mark.parametrize("d", [16, 20, 36])
def test_tensor_core_operands_pad_and_realign(d, kind):
    """The bf16 wrapper's step before the kernel, on the CPU: the head dim
    padded to a multiple of 8, bases 16-byte aligned and strides
    multiples of 8 elements, by a copy only where needed; the plain
    version on the prepared operands, sliced back to d, equals the plain
    version and JAX's varlen_reference on the given ones."""
    q, k, v, seg_q, seg_k = _case("unequal", 4, 2, d=d, seed=3)
    t = torch.from_numpy
    given = [_strided(t(x), d, kind) for x in (q, k, v)]
    prep = tensor_core_operands(*given)
    for a, b in zip(given, prep):
        assert b.shape[-1] == -(-d // 8) * 8 and b.stride(-1) == 1
        assert b.data_ptr() % 16 == 0
        assert all(s % 8 == 0 for s in b.stride()[:-1])
        assert torch.equal(b[..., :d], a) and not b[..., d:].any()
        # already as the kernel takes it: passed through, not copied
        assert (b is a) == (kind == "contiguous" and d % 8 == 0)
    scale = d ** -0.5
    for causal in (True, False):
        o, lse = TV.varlen_fwd_reference(*prep, t(seg_q), t(seg_k), causal,
                                         scale)
        o_ref, lse_ref = TV.varlen_fwd_reference(*given, t(seg_q),
                                                 t(seg_k), causal, scale)
        np.testing.assert_allclose(o[..., :d].numpy(), o_ref.numpy(),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), atol=ATOL,
                                   rtol=1e-6)
        jo, jl = _jax_reference(q, k, v, seg_q, seg_k, causal, scale)
        np.testing.assert_allclose(o[..., :d].numpy(), jo, atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(lse.numpy(), jl, atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("name,group", [
    ("void attn_fwd_sm90::fwd_tc_kernel<128, (anonymous namespace)::"
     "VarlenPolicy>(...)", "attention (varlen_attention.cu)"),
    ("void (anonymous namespace)::va_fwd_kernel<float, 128>(...)",
     "attention (varlen_attention.cu)"),
    ("void (anonymous namespace)::va_dq_kernel<__nv_bfloat16, 128>(...)",
     "attention (varlen_attention.cu)"),
    ("void attn_bwd_sm90::dkv_tc_kernel<128, (anonymous namespace)::"
     "VarlenPolicy, attn_bwd_sm90::BwdLayout, false>(...)",
     "attention (varlen_attention.cu)"),
    ("void attn_bwd_sm90::dq_tc_kernel<128, (anonymous namespace)::"
     "FmPolicy, attn_bwd_sm90::ContiguousBwdLayout, false>(...)",
     "attention (flashmask_attention.cu)"),
    ("void attn_fwd_sm90::fwd_tc_kernel<128, (anonymous namespace)::"
     "FlashPolicy>(...)", "attention (flash_attention.cu)"),
    ("void attn_fwd_sm90::fwd_tc_kernel<128, (anonymous namespace)::"
     "FmPolicy>(...)", "attention (flashmask_attention.cu)")])
def test_serving_profile_groups_the_attention_kernels(name, group):
    """tools/profile_torch_serving.py charges each attention kernel to its
    source: the bf16 varlen forward is the shared tile loop with the
    varlen policy, which the flash test must not catch first."""
    assert _script("tools/profile_torch_serving.py")._group(name) == group
