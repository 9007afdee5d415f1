"""The port's nn.functional attention entry points
(scaled_dot_product_attention, flash_attention, flash_attn_unpadded,
the two qkvpacked forms and flashmask_attention) held with grads to the
JAX package's CPU path (its XLA references) at 2e-5: through Tensors on
the same numpy inputs, GQA (4 query over 2 KV heads), causal, packed
documents and a FlashMask band. On the CPU the port runs the kernels'
plain versions and launches nothing."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch._core import state as tstate

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _cpu():
    prev = tstate._device
    tstate.set_device("cpu")
    yield
    tstate._device = prev


def _f(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _np(t):
    return np.asarray(t.numpy())


B_, S_, H_, KVH, D_ = 2, 16, 4, 2, 16


def _qkv(seed, s=S_, h=H_, kvh=KVH, b=B_):
    return (_f(seed, b, s, h, D_, scale=0.5), _f(seed + 1, b, s, kvh, D_,
                                                 scale=0.5),
            _f(seed + 2, b, s, kvh, D_, scale=0.5))


def _attn(pt, fn, arrays, ints=()):
    ts = [pt.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(pt, *ts, *[pt.to_tensor(i) for i in ints])
    out = out[0] if isinstance(out, tuple) else out
    w = pt.to_tensor(_f(99, *out.shape))
    (out * w).sum().backward()
    return [_np(out)] + [_np(t.grad) for t in ts]


CU = np.array([0, 5, 16, 26, 32], np.int32)
SRI = np.zeros((B_, KVH, S_, 1), np.int32)
for _b in range(B_):
    for _h in range(KVH):
        SRI[_b, _h, :, 0] = np.minimum(S_, np.arange(S_) + 4 + 2 * _h + _b)

ATTN_CASES = {
    "sdpa": (lambda pt, q, k, v: pt.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True), _qkv(0), ()),
    "sdpa_mask": (lambda pt, q, k, v, m: pt.nn.functional.
                  scaled_dot_product_attention(q, k, v, attn_mask=m),
                  _qkv(3), (np.tril(np.ones((S_, S_), bool)),)),
    "flash_attention": (lambda pt, q, k, v: pt.nn.functional.flash_attention(
        q, k, v, causal=True), _qkv(6), ()),
    "flash_attention_noncausal": (
        lambda pt, q, k, v: pt.nn.functional.flash_attention(q, k, v),
        _qkv(9, h=4, kvh=4), ()),
    "flash_attn_unpadded": (
        lambda pt, q, k, v, cu: pt.nn.functional.flash_attn_unpadded(
            q, k, v, cu, cu, 16, 16, causal=True),
        tuple(a.reshape(-1, *a.shape[2:]) for a in _qkv(12)), (CU,)),
    "flash_attn_varlen_qkvpacked": (
        lambda pt, qkv, cu: pt.nn.functional.flash_attn_varlen_qkvpacked(
            qkv, cu, cu, 16, 16, causal=True),
        (_f(15, B_ * S_, H_ // KVH + 2, KVH, D_, scale=0.5),), (CU,)),
    "flash_attn_qkvpacked": (
        lambda pt, qkv: pt.nn.functional.flash_attn_qkvpacked(
            qkv, causal=True),
        (_f(16, B_, S_, H_ // KVH + 2, KVH, D_, scale=0.5),), ()),
    "flashmask_attention": (
        lambda pt, q, k, v, sri: pt.nn.functional.flashmask_attention(
            q, k, v, sri, causal=True), _qkv(18), (SRI,)),
    "flashmask_window": (
        lambda pt, q, k, v: pt.nn.functional.flashmask_attention(
            q, k, v, causal=True, window_size=5), _qkv(21), ()),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_entry_point_matches_jax(case):
    fn, arrays, ints = ATTN_CASES[case]
    ref = _attn(jp, fn, arrays, ints)
    got = _attn(tp, fn, arrays, ints)
    for r, g in zip(ref, got):
        assert r.shape == g.shape
        np.testing.assert_allclose(g, r, **ATTN_TOL)


def test_attention_entry_points_launch_nothing_on_the_cpu():
    import paddle_tpu_torch.ops.flash_attention as fa
    import paddle_tpu_torch.ops.flashmask_attention as fm
    import paddle_tpu_torch.ops.varlen_attention as va
    before = [m.launches_fwd + m.launches_dq + m.launches_dkv
              for m in (fa, fm, va)]
    for case in ATTN_CASES:
        fn, arrays, ints = ATTN_CASES[case]
        _attn(tp, fn, arrays, ints)
    assert [m.launches_fwd + m.launches_dq + m.launches_dkv
            for m in (fa, fm, va)] == before


def test_attention_dropout_while_training_names_item_13():
    q, k, v = (tp.to_tensor(a) for a in _qkv(0))
    with pytest.raises(NotImplementedError, match="item 13"):
        tp.nn.functional.flash_attention(q, k, v, dropout=0.1)
    with pytest.raises(NotImplementedError, match="item 13"):
        tp.nn.functional.flash_attn_unpadded(
            *(tp.to_tensor(a.reshape(-1, *a.shape[2:])) for a in _qkv(0)),
            CU, CU, dropout=0.1)
