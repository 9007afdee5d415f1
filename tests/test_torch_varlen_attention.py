"""paddle_tpu_torch's varlen attention forward held to the JAX package's
on the CPU: `rev_pos` and `seg_ids_from_cu_seqlens` equal JAX's, and
`flash_attention_varlen` / `varlen_fwd_reference` agree with JAX's
`varlen_reference` and with the Pallas kernel `_vfwd_pallas` run in
interpret mode (o and lse), causal and not, same and unequal
cu_seqlens, GQA, and padding rows (o = 0, lse = -1e30). fp32 to 1e-5:
the same sums in another order."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops import varlen_attention as JV
from paddle_tpu_torch.ops import varlen_attention as TV

ATOL = 1e-5


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


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 2)],
                         ids=["g1", "g2", "g4"])
def test_matches_jax_reference(causal, layout, h, kvh):
    q, k, v, seg_q, seg_k = _case(layout, h, kvh)
    scale = 16 ** -0.5
    rep = h // kvh
    jo, jl = JV.varlen_reference(
        jnp.asarray(q).swapaxes(0, 1),
        jnp.repeat(jnp.asarray(k), rep, axis=1).swapaxes(0, 1),
        jnp.repeat(jnp.asarray(v), rep, axis=1).swapaxes(0, 1),
        jnp.asarray(np.where(seg_q < 0, -1, seg_q)),
        jnp.asarray(np.where(seg_k < 0, -2, seg_k)), causal, scale)
    t = torch.from_numpy
    o, lse = TV.varlen_fwd_reference(t(q), t(k), t(v), t(seg_q), t(seg_k),
                                     causal, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo).swapaxes(0, 1),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=1e-6)
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
