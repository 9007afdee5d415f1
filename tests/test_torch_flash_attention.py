"""paddle_tpu_torch's flash attention held to the JAX package's.

On the CPU the port runs the plain versions of its three kernels. They
are compared with `mha_reference`, with the Pallas kernels themselves in
interpret mode (`_fwd_pallas`, `_bwd_pallas`), and the autograd Function
with `jax.grad` through `flash_attention_bhsd(use_pallas=True,
interpret=True)`. S = 96 leaves one ragged 64-row tile in the Pallas
kernels. The Hopper kernels run only on the card: tests/test_torch_cuda.py
holds them to the plain versions there."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu_torch.ops.flash_attention as fa
from paddle_tpu.ops.flash_attention import (
    _bwd_pallas, _fwd_pallas, flash_attention_bhsd, mha_reference)

# fp32 on both sides. Dense reference against dense plain version: sums
# in another order only. Against the Pallas kernels (blocked online
# softmax, backward through P rebuilt from lse): 1e-4.
ATOL_DENSE = 1e-5
ATOL_KERNEL = 1e-4
BLOCK = 64

SHAPES = {"b2h2s96d16": (2, 2, 96, 16), "b1h4s64d32": (1, 4, 64, 32)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_plain_fwd_matches_mha_reference(shape, causal):
    q, k, v, _ = _inputs(shape)
    scale = 1.0 / math.sqrt(shape[-1])
    want_o, want_lse = mha_reference(*_j(q, k, v), causal=causal)
    o, lse = fa.flash_fwd_reference(*_t(q, k, v), causal, scale)
    np.testing.assert_allclose(o.numpy(), want_o, atol=ATOL_DENSE)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL_DENSE)
    # and the port's own mha_reference, causal aligned as JAX aligns it
    o2, lse2 = fa.mha_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(o2.numpy(), want_o, atol=ATOL_DENSE)
    np.testing.assert_allclose(lse2.numpy(), want_lse, atol=ATOL_DENSE)


def test_mha_reference_bias_and_bottom_right_causal():
    """The port's mha_reference keeps the JAX reference's additive bias
    and its bottom-right causal alignment when sq < sk."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 2, 24, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 40, 16)).astype(np.float32)
            for _ in range(2))
    bias = rng.standard_normal((1, 2, 24, 40)).astype(np.float32)
    want = mha_reference(*_j(q, k, v), bias=jnp.asarray(bias), causal=True)
    got = fa.mha_reference(*_t(q, k, v), bias=torch.from_numpy(bias),
                           causal=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL_DENSE)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_plain_versions_match_pallas_interpret(shape, causal):
    """Forward, dQ and dK/dV against the Pallas kernels run in interpret
    mode, fed the same o, lse and dO."""
    q, k, v, do = _inputs(shape, seed=2)
    scale = 1.0 / math.sqrt(shape[-1])
    o_j, lse_j = _fwd_pallas(*_j(q, k, v), causal, scale, BLOCK, BLOCK,
                             interpret=True)
    o, lse = fa.flash_fwd_reference(*_t(q, k, v), causal, scale)
    np.testing.assert_allclose(o.numpy(), o_j, atol=ATOL_KERNEL)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=ATOL_KERNEL)

    dq_j, dk_j, dv_j = _bwd_pallas(*_j(q, k, v), o_j, lse_j,
                                   jnp.asarray(do), causal, scale, BLOCK,
                                   BLOCK, interpret=True)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o_t, lse_t = _t(np.array(o_j), np.array(lse_j))
    delta = (tdo * o_t).sum(-1)
    dq = fa.flash_bwd_dq_reference(tq, tk, tv, tdo, lse_t, delta, causal,
                                   scale)
    dk, dv = fa.flash_bwd_dkv_reference(tq, tk, tv, tdo, lse_t, delta,
                                        causal, scale)
    for name, a, b in (("dq", dq, dq_j), ("dk", dk, dk_j), ("dv", dv, dv_j)):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL_KERNEL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_grad_through_pallas(causal):
    shape = SHAPES["b2h2s96d16"]
    q, k, v, w = _inputs(shape, seed=3)

    def loss_j(q, k, v):
        o = flash_attention_bhsd(q, k, v, causal=causal, block_q=BLOCK,
                                 block_k=BLOCK, use_pallas=True,
                                 interpret=True)
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(loss_j, argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    o = fa.flash_attention_bhsd(tq, tk, tv, causal=causal)
    (o * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), g, atol=ATOL_KERNEL,
                                   err_msg=f"d{name}")
    # CPU tensors run the plain versions and launch nothing
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == before


def test_bf16_returns_bf16():
    q, k, v, _ = _inputs((1, 2, 40, 16), seed=4)
    tq, tk, tv = (t.bfloat16().requires_grad_() for t in _t(q, k, v))
    o = fa.flash_attention_bhsd(tq, tk, tv, causal=True)
    assert o.dtype == torch.bfloat16
    o.float().sum().backward()
    assert tq.grad.dtype == tk.grad.dtype == torch.bfloat16
    want, _ = fa.mha_reference(*_t(q, k, v), causal=True)
    # bf16 inputs and output: within a few bf16 ulps of the fp32 result
    np.testing.assert_allclose(o.float().detach().numpy(), want.numpy(),
                               atol=3e-2, rtol=1.6e-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [20, 100])
def test_tensor_core_operands_pad_and_slice(d, causal):
    """The bf16 forward kernel takes head dims that are multiples of 8:
    the wrapper zero-pads D and slices the output. The plain forward on
    the padded operands, sliced, is the plain forward on the originals
    (fp32 sums over D in another blocking only), which holds JAX's
    mha_reference."""
    q, k, v, _ = _inputs((2, 2, 96, d), seed=d)
    tq, tk, tv = _t(q, k, v)
    pq, pk, pv = fa.tensor_core_operands(tq, tk, tv)
    dp = -(-d // 8) * 8
    for p, t in zip((pq, pk, pv), (tq, tk, tv)):
        assert p.shape == t.shape[:-1] + (dp,) and p.is_contiguous()
        assert torch.equal(p[..., :d], t) and not p[..., d:].any()
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_fwd_reference(tq, tk, tv, causal, scale)
    po, plse = fa.flash_fwd_reference(pq, pk, pv, causal, scale)
    assert not po[..., d:].any()
    torch.testing.assert_close(po[..., :d], o, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(plse, lse, atol=1e-6, rtol=1e-6)
    jo, jlse = mha_reference(*_j(q, k, v), causal=causal)
    np.testing.assert_allclose(po[..., :d].numpy(), np.asarray(jo),
                               atol=ATOL_DENSE)
    np.testing.assert_allclose(plse.numpy(), np.asarray(jlse),
                               atol=ATOL_DENSE)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [20, 100])
def test_tensor_core_operands_backward_pad_and_slice(d, causal):
    """The bf16 dQ and dK/dV kernels take q, k, v and dO padded as the
    forward's operands, and lse and delta as they are: zero dims add
    nothing to S or dP, so P and dS do not change, and dQ, dK and dV come
    back with zero padding columns, which the wrapper slices off. The
    plain backward on the padded operands, sliced, is the plain backward
    on the originals."""
    q, k, v, do = _inputs((2, 2, 96, d), seed=d + 1)
    tq, tk, tv, tdo = _t(q, k, v, do)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_fwd_reference(tq, tk, tv, causal, scale)
    delta = (tdo * o).sum(-1)
    padded = fa.tensor_core_operands(tq, tk, tv, tdo)
    want = (fa.flash_bwd_dq_reference(tq, tk, tv, tdo, lse, delta, causal,
                                      scale),
            *fa.flash_bwd_dkv_reference(tq, tk, tv, tdo, lse, delta, causal,
                                        scale))
    got = (fa.flash_bwd_dq_reference(*padded, lse, delta, causal, scale),
           *fa.flash_bwd_dkv_reference(*padded, lse, delta, causal, scale))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape[-1] == -(-d // 8) * 8 and not g[..., d:].any(), name
        torch.testing.assert_close(g[..., :d], w, atol=1e-6, rtol=1e-6,
                                   msg=name)


def test_tensor_core_operands_realign():
    """A contiguous bf16 view at a storage offset that is not 16-byte
    aligned is cloned to an aligned base with the same values; aligned
    operands with D % 8 == 0 pass through untouched."""
    q, _, _, _ = _inputs((1, 2, 40, 16), seed=5)
    flat = torch.from_numpy(q).bfloat16().reshape(-1)
    store = torch.cat([flat.new_zeros(1), flat])
    view = store[1:].view(1, 2, 40, 16)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    (moved,) = fa.tensor_core_operands(view)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, view)
    aligned = flat.view(1, 2, 40, 16).clone()
    (same,) = fa.tensor_core_operands(aligned)
    assert same is aligned
    want = fa.flash_fwd_reference(view, view, view, True, 0.25)
    got = fa.flash_fwd_reference(moved, moved, moved, True, 0.25)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_causal_needs_equal_lengths():
    q = torch.zeros((1, 1, 8, 16))
    k = torch.zeros((1, 1, 12, 16))
    with pytest.raises(ValueError, match="sq == sk"):
        fa.flash_attention_bhsd(q, k, k, causal=True)
    assert fa.flash_attention_bhsd(q, k, k).shape == q.shape


def test_unsupported_device_raises():
    q = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no implementation for device"):
        fa.flash_attention_bhsd(q, q, q, causal=True)
