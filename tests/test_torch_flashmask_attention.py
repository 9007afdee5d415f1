"""paddle_tpu_torch's FlashMask attention held to the JAX package's.

On the CPU the port runs the plain versions of its three kernels. They
are compared with `flashmask_reference` (o and, through `jax.vjp`, dQ,
dK and dV) over every mask flavor the card checks, with the Pallas
forward in interpret mode (lse), and the autograd Function with
`jax.grad` through `flashmask_attention_bhsd(use_pallas=True,
interpret=True)`. The dropout mask is held bit for bit. The Hopper
kernels run only on the card: tests/test_torch_cuda.py holds them to
the plain versions there."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu_torch.ops.flashmask_attention as fm
from paddle_tpu.ops import flashmask_attention as J

# fp32 on both sides, dense against dense: sums in another order only
TOL = dict(atol=1e-5, rtol=1e-4)
# bf16 inputs and outputs: both sides round the same fp32 value, one bf16
# ulp (at most 2^-7 of the value) apart
BF16_TOL = dict(atol=2e-3, rtol=8e-3)
B, H, D = 2, 2, 16


def _docs(b, s, rng):
    """(B, 1, S, 1) ends of contiguous documents of random lengths."""
    out = np.empty((b, s), np.int64)
    for r in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s), 3, replace=False))
        edges = np.concatenate([[0], cuts, [s]])
        out[r] = np.repeat(edges[1:], np.diff(edges))
    return out[:, None, :, None]


def _band(b, h, s, rng):
    start = rng.integers(0, s, (b, h, s, 1))
    end = np.minimum(start + rng.integers(0, s // 2, (b, h, s, 1)), s)
    return np.concatenate([start, end], -1)


def _n4(b, h, s, rng):
    s0 = rng.integers(0, s // 4, (b, h, s, 1))
    e0 = s0 + rng.integers(0, s // 4, (b, h, s, 1))
    s1 = rng.integers(s // 2, s, (b, h, s, 1))
    e1 = np.minimum(s1 + rng.integers(0, s // 4, (b, h, s, 1)), s)
    return np.concatenate([s0, e0, s1, e1], -1)


def _masked_rows(b, s):
    """Columns [0, s/2) mask every row >= s/4: rows in [s/4, s/2) see
    nothing at all."""
    sri = np.full((b, 1, s, 1), s, np.int64)
    sri[:, :, : s // 2] = s // 4
    return sri


# flavor -> s, rng -> (sri or None, causal, window)
FLAVORS = {
    "causal_n1": lambda s, r: (r.integers(1, s + 1, (B, H, s, 1)), True,
                               None),
    "causal_n1_docs": lambda s, r: (_docs(B, s, r), True, None),
    "causal_n2_band": lambda s, r: (_band(B, H, s, r), True, None),
    "noncausal_n2": lambda s, r: (np.concatenate(
        [r.integers(s // 2, s + 1, (B, H, s, 1)),
         r.integers(0, s // 2, (B, H, s, 1))], -1), False, None),
    "noncausal_n4": lambda s, r: (_n4(B, H, s, r), False, None),
    "causal_n1_window": lambda s, r: (r.integers(1, s + 1, (B, H, s, 1)),
                                      True, (64, 0)),
    "window_no_sri": lambda s, r: (None, True, (64, 0)),
    "masked_rows": lambda s, r: (_masked_rows(B, s), True, None),
}


def _qkv(s, seed, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    q, do = (rng.standard_normal((B, H, s, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, H, sk, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


def _sri(a):
    return None if a is None else torch.from_numpy(a.astype(np.int32))


def _jax_ref(q, k, v, do, sri, causal, window, dropout=0.0, seed=None):
    """JAX's dense reference: (o, lse, (dq, dk, dv)) for cotangent do."""
    js = None if sri is None else jnp.asarray(sri, jnp.int32)

    def f(q_, k_, v_):
        return J.flashmask_reference(q_, k_, v_, js, causal, window,
                                     dropout=dropout, dropout_seed=seed)
    (o, lse), vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp((jnp.asarray(do), jnp.zeros_like(lse)))
    return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


def _plain(q, k, v, do, sri, causal, window, dropout=0.0, seed=None):
    """The port's plain versions, chained as the autograd Function
    chains the kernels: (o, lse, (dq, dk, dv))."""
    tq, tk, tv, tdo = _t(q, k, v, do)
    m = fm._Mask(causal, window, 1.0 / math.sqrt(q.shape[-1]), dropout,
                 seed)
    ts = _sri(sri)
    o, lse = fm.flashmask_fwd_reference(tq, tk, tv, ts, *m)
    delta = (tdo.float() * o.float()).sum(-1)
    dq = fm.flashmask_bwd_dq_reference(tq, tk, tv, ts, tdo, lse, delta, *m)
    dk, dv = fm.flashmask_bwd_dkv_reference(tq, tk, tv, ts, tdo, lse, delta,
                                            *m)
    return o, lse, (dq, dk, dv)


def _assert_all(got, want, tol):
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"),
                          [got[0], got[1], *got[2]],
                          [want[0], want[1], *want[2]]):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("s", [200, 256])
@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_plain_versions_match_reference(flavor, s):
    """o, lse and the three gradients of the plain kernels against the
    JAX reference and its VJP, fp32."""
    sri, causal, window = FLAVORS[flavor](s, np.random.default_rng(s))
    q, k, v, do = _qkv(s, seed=1)
    want = _jax_ref(q, k, v, do, sri, causal, window)
    _assert_all(_plain(q, k, v, do, sri, causal, window), want, TOL)
    # and the port's own dense reference
    o, lse = fm.flashmask_reference(*_t(q, k, v), _sri(sri), causal, window)
    np.testing.assert_allclose(o.numpy(), want[0], **TOL)
    np.testing.assert_allclose(lse.numpy(), want[1], **TOL)


def test_masked_rows_give_zeros():
    sri = _masked_rows(B, 200)
    q, k, v, do = _qkv(200, seed=2)
    o, lse, (dq, _, _) = _plain(q, k, v, do, sri, True, None)
    rows = slice(50, 100)
    assert torch.all(o[:, :, rows] == 0) and torch.all(dq[:, :, rows] == 0)
    assert torch.all(lse[:, :, rows] == fm.NEG_INF)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_plain_versions_match_reference(rate):
    sri, causal, window = FLAVORS["causal_n1"](200, np.random.default_rng(3))
    q, k, v, do = _qkv(200, seed=3)
    want = _jax_ref(q, k, v, do, sri, causal, window, rate, 1234567)
    got = _plain(q, k, v, do, sri, causal, window, rate, 1234567)
    _assert_all(got, want, TOL)
    # lse takes the undropped probabilities
    no_drop = _plain(q, k, v, do, sri, causal, window)
    np.testing.assert_allclose(got[1].numpy(), no_drop[1].numpy(), **TOL)
    assert not torch.allclose(got[0], no_drop[0], atol=1e-3)


def test_bf16_plain_versions_match_reference():
    sri, causal, window = FLAVORS["causal_n1_docs"](256,
                                                    np.random.default_rng(4))
    q, k, v, do = _qkv(256, seed=4)
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v, do)]
    want = _jax_ref(*bf, sri, causal, window)
    tq, tk, tv, tdo = (torch.from_numpy(a.astype(np.float32)).bfloat16()
                       for a in bf)
    m = fm._Mask(causal, window, 1.0 / math.sqrt(D), 0.0, None)
    ts = _sri(sri)
    o, lse = fm.flashmask_fwd_reference(tq, tk, tv, ts, *m)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    delta = (tdo.float() * o.float()).sum(-1)
    dq = fm.flashmask_bwd_dq_reference(tq, tk, tv, ts, tdo, lse, delta, *m)
    dk, dv = fm.flashmask_bwd_dkv_reference(tq, tk, tv, ts, tdo, lse, delta,
                                            *m)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    # the forward is held to one bf16 ulp; the gradients start from an o
    # rounded to bf16 on both sides, so to two
    np.testing.assert_allclose(o.float().numpy(), want[0].astype(np.float32),
                               **BF16_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want[2]):
        np.testing.assert_allclose(a.float().numpy(), b.astype(np.float32),
                                   atol=4e-3, rtol=1.6e-2, err_msg=name)


@pytest.mark.parametrize("bh,seed,rate", [
    (0, 0, 0.1), (3, 12345, 0.5), (7, -5, 0.9), (31, 2 ** 31 - 1, 0.25)])
def test_dropout_keep_mask_bit_equal_jax(bh, seed, rate):
    rows = np.concatenate([np.arange(96), 8000 + np.arange(32)])[:, None]
    cols = np.concatenate([np.arange(130), 6000 + np.arange(20)])[None, :]
    want = np.asarray(J.dropout_keep_mask(jnp.asarray(rows),
                                          jnp.asarray(cols), bh, seed, rate))
    got = fm.dropout_keep_mask(torch.from_numpy(rows), torch.from_numpy(cols),
                               bh, seed, rate)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 < want.mean() < 1.0


@pytest.mark.parametrize("flavor", ["causal_n1_docs", "noncausal_n4"])
def test_plain_forward_matches_pallas_interpret(flavor):
    """o and lse against the TPU forward kernel itself, in interpret
    mode (lse lane 0)."""
    sri, causal, window = FLAVORS[flavor](256, np.random.default_rng(5))
    q, k, v, do = _qkv(256, seed=5)
    scale = 1.0 / math.sqrt(D)
    # the TPU kernels take the mask at the q heads
    sri_h = jnp.broadcast_to(jnp.asarray(sri, jnp.int32), (B, H, 256,
                                                           sri.shape[-1]))
    o_j, lse_j = J._fwd_pallas(*(jnp.asarray(a) for a in (q, k, v)),
                               sri_h, causal, window,
                               scale, 128, 128, True)
    o, lse, _ = _plain(q, k, v, do, sri, causal, window)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0],
                               atol=1e-4)


def _torch_grads(q, k, v, w, sri, **kw):
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o = fm.flashmask_attention_bhsd(tq, tk, tv, _sri(sri), **kw)
    (o * torch.from_numpy(w)).sum().backward()
    return o.detach(), [t.grad for t in (tq, tk, tv)]


def test_autograd_matches_jax_grad_through_pallas():
    sri, causal, window = FLAVORS["causal_n1_docs"](256,
                                                    np.random.default_rng(6))
    q, k, v, w = _qkv(256, seed=6)
    sri_h = jnp.broadcast_to(jnp.asarray(sri, jnp.int32), (B, H, 256, 1))

    def loss_j(q_, k_, v_):
        o = J.flashmask_attention_bhsd(q_, k_, v_, sri_h,
                                       causal=causal, use_pallas=True,
                                       interpret=True, block_q=128,
                                       block_k=128)
        return jnp.sum(o * jnp.asarray(w))
    want = jax.grad(loss_j, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                 for a in (q, k, v)))
    before = (fm.launches_fwd, fm.launches_dq, fm.launches_dkv)
    _, grads = _torch_grads(q, k, v, w, sri, causal=causal)
    for name, g, g_j in zip("qkv", grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), atol=1e-4,
                                   err_msg=f"d{name}")
    # CPU tensors run the plain versions and launch nothing
    assert (fm.launches_fwd, fm.launches_dq, fm.launches_dkv) == before


@pytest.mark.parametrize("case", ["noncausal_n4_window", "dropout",
                                  "uneven_lengths"])
def test_autograd_matches_jax_grad_of_reference(case):
    rng = np.random.default_rng(7)
    kw, jkw, sk = {}, {}, None
    if case == "noncausal_n4_window":
        sri, causal = _n4(B, H, 200, rng), False
        kw = jkw = {"window": (40, 30)}
    elif case == "dropout":
        sri, causal = rng.integers(1, 201, (B, H, 200, 1)), True
        kw = {"dropout": 0.2, "dropout_seed": 99}
        jkw = {"dropout": 0.2, "dropout_seed": 99}
    else:       # sq != sk: the mask is top-left, as the reference's
        sk = 280
        sri, causal = rng.integers(1, 201, (B, 1, sk, 1)), True
    q, k, v, w = _qkv(200, seed=7, sk=sk)
    js = jnp.asarray(sri, jnp.int32)

    def loss_j(q_, k_, v_):
        o, _ = J.flashmask_reference(q_, k_, v_, js, causal, **jkw)
        return jnp.sum(o * jnp.asarray(w))
    want = jax.grad(loss_j, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                 for a in (q, k, v)))
    _, grads = _torch_grads(q, k, v, w, sri, causal=causal, **kw)
    for name, g, g_j in zip("qkv", grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), err_msg=name,
                                   **TOL)


def test_shared_mask_equals_per_head_mask():
    """(B, 1, S, n) serves every head as its broadcast (B, H, S, n)."""
    sri = _docs(B, 200, np.random.default_rng(8))
    q, k, v, do = _qkv(200, seed=8)
    one = _plain(q, k, v, do, sri, True, None)
    every = _plain(q, k, v, do, np.repeat(sri, H, axis=1), True, None)
    for a, b in zip([one[0], one[1], *one[2]],
                    [every[0], every[1], *every[2]]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_padded_head_dim_gives_the_same_forward():
    """The bf16 forward kernel's operands go through
    `tensor_core_operands` (D zero-padded to a multiple of 8): the plain
    forward on them, sliced, is the plain forward on the originals, on a
    per-head mask with dropout."""
    s, d = 200, 20
    rng = np.random.default_rng(9)
    sri = _sri(_band(B, H, s, rng))
    tq, tk, tv = (torch.from_numpy(rng.standard_normal((B, H, s, d))
                                   .astype(np.float32)) for _ in range(3))
    m = fm._Mask(True, (96, 0), 1.0 / math.sqrt(d), 0.25, 77)
    o, lse = fm.flashmask_fwd_reference(tq, tk, tv, sri, *m)
    pq, pk, pv = fm.tensor_core_operands(tq, tk, tv)
    assert pq.shape[-1] == 24
    po, plse = fm.flashmask_fwd_reference(pq, pk, pv, sri, *m)
    assert not po[..., d:].any()
    torch.testing.assert_close(po[..., :d], o, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(plse, lse, atol=1e-6, rtol=1e-6)
    want = _jax_ref(tq.numpy(), tk.numpy(), tv.numpy(), tq.numpy(),
                    sri.numpy(), True, (96, 0), dropout=0.25, seed=77)
    np.testing.assert_allclose(po[..., :d].numpy(), want[0], **TOL)


def _tile_counts_rule(sri, tile=64):
    """The skip rule of `chip_smoke.py`'s `_tile_counts` for an n=1
    causal mask, per (q tile, k tile): causal and not wholly masked,
    i.e. the tile's first row before the largest start of its
    columns."""
    start = sri[0, 0, :, 0].long()
    nt = -(-start.numel() // tile)
    pad = torch.full((nt * tile - start.numel(),), -(1 << 31))
    mx = torch.cat([start, pad]).reshape(nt, tile).amax(1)
    qt = torch.arange(nt)[:, None]
    return (torch.arange(nt)[None, :] <= qt) & ~(qt * tile >= mx[None])


@pytest.mark.parametrize("docs,s", [
    ((3000, 1500, 1200, 900, 700, 400, 300, 192), 8192),
    ((100, 37, 300, 63), 500)])
def test_tile_plan_on_packed_documents(docs, s):
    """The kernel's tile rule on packed documents keeps exactly the
    tiles of `_tile_counts`' rule (the packed training row: 1,904 of
    8,256 causal tiles a head), and those it keeps whole lie inside one
    document under the diagonal."""
    ends = np.cumsum(docs)[np.repeat(np.arange(len(docs)), docs)]
    sri = torch.from_numpy(ends.astype(np.int32))[None, None, :, None]
    plan = fm.tile_plan(sri, s, s, True)[0, 0]
    assert torch.equal(plan != fm.SKIP, _tile_counts_rule(sri))
    if s == 8192:
        assert int((plan != fm.SKIP).sum()) == 1904
    keep = fm._keep(s, s, sri, True, None, "cpu")[0, 0]
    for qt, kt in (plan == fm.FULL).nonzero().tolist():
        assert keep[qt * 64:(qt + 1) * 64, kt * 64:(kt + 1) * 64].all()


# (flavor, sq, sk): every flavor at two square shapes (one ragged), the
# non-causal ones also with sq != sk
_PLAN_CASES = [(f, sq, sk) for f in list(FLAVORS) + ["noncausal_window"]
               for sq, sk in ((256, 256), (300, 300), (200, 330))
               if sq == sk or f.startswith("noncausal")]


@pytest.mark.parametrize("flavor,sq,sk", _PLAN_CASES)
def test_tile_plan_is_sound(flavor, sq, sk):
    """Against the dense mask (held to JAX's by the tests above): no
    pair of a skipped tile is kept, and every pair of a full tile is."""
    rng = np.random.default_rng(sq + sk)
    if flavor == "noncausal_window":
        sri, causal, window = None, False, (40, 70)
    else:
        sri, causal, window = FLAVORS[flavor](sk, rng)
    t = _sri(sri)
    plan = fm.tile_plan(t, sq, sk, causal, window)
    keep = fm._keep(sq, sk, t, causal, fm._norm_window(window), "cpu")
    keep = keep[None, None] if keep.dim() == 2 else keep
    n_qt, n_kt = plan.shape[-2:]
    assert (n_qt, n_kt) == (-(-sq // 64), -(-sk // 64))
    for qt in range(n_qt):
        for kt in range(n_kt):
            blk = keep[..., qt * 64:(qt + 1) * 64, kt * 64:(kt + 1) * 64]
            p = plan[..., qt, kt]
            assert not ((p == fm.SKIP) & blk.flatten(2).any(-1)).any()
            assert ((p != fm.FULL) | blk.flatten(2).all(-1)).all()
            if blk.shape[-2:] != (64, 64):
                assert not (p == fm.FULL).any()
    assert (plan != fm.SKIP).any()


@pytest.mark.parametrize("causal,n", [(True, 4), (False, 1)])
def test_invalid_width_raises_as_jax(causal, n):
    q = torch.zeros((1, 1, 8, 16))
    sri = torch.full((1, 1, 8, n), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="invalid"):
        fm.flashmask_attention_bhsd(q, q, q, sri, causal=causal)
    with pytest.raises(ValueError, match="invalid"):
        J.flashmask_reference(jnp.zeros((1, 1, 8, 16)), jnp.zeros((1, 1, 8, 16)),
                              jnp.zeros((1, 1, 8, 16)), jnp.asarray(sri.numpy()),
                              causal)


def test_dropout_without_seed_raises_as_jax():
    q = torch.zeros((1, 1, 8, 16))
    with pytest.raises(ValueError, match="dropout_seed"):
        fm.flashmask_attention_bhsd(q, q, q, dropout=0.1)
    with pytest.raises(ValueError, match="dropout_seed"):
        J.flashmask_attention_bhsd(jnp.zeros((1, 1, 8, 16)),
                                   jnp.zeros((1, 1, 8, 16)),
                                   jnp.zeros((1, 1, 8, 16)), dropout=0.1)


def test_unsupported_device_raises():
    q = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no implementation for device"):
        fm.flashmask_attention_bhsd(q, q, q, causal=True)
