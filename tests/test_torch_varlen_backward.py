"""paddle_tpu_torch's varlen training surface held to the JAX package's
on the CPU.

  * The plain versions of the varlen dQ and dK/dV kernels, and the
    port's `torch.autograd.grad` through `flash_attention_varlen` and
    `flash_attn_unpadded`, against `jax.vjp` of JAX's
    `flash_attention_varlen` on its reference path (fp32, to 2e-4) and
    on its Pallas kernels in interpret mode (to 2e-3, the tolerance of
    JAX's own tests/test_varlen_attention.py): equal and unequal q/k
    lengths, causal or not, same_offsets on and off, trailing pads,
    GQA groups 1 and 2.
  * `fused_linear_cross_entropy` against JAX's op: values and grads for
    each reduction, with ignore_index, a bias, and a vocabulary that is
    not a multiple of a small chunk.
  * `make_train_step(fused_ce=True)` and `remat="dots"` against JAX's
    step (losses, step-1 gradients, parameters after 2 steps); the
    PT_FUSED_CE variable; what the dots policy recomputes.
  * The Paddle-shaped `flash_attention` against JAX's, and the
    refusals of both dropout branches (ROADMAP item 13).

Inputs come from numpy seeds and go to both packages."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu_torch.ops.flash_attention as TF
import paddle_tpu_torch.ops.fused as TFU
from paddle_tpu.models import llama_spmd as M
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.ops import fused as JFU
from paddle_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from paddle_tpu.ops import varlen_attention as JV
from paddle_tpu_torch.models import llama_spmd as T
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.ops import varlen_attention as TV

# fp32 against JAX's reference path: the same sums in another order
REF_ATOL = 2e-4
# against the Pallas kernels in interpret mode, as JAX's own test holds
# them to its reference
PALLAS_ATOL = 2e-3
D = 32


def _seg(lens, total, pad):
    s = np.full((total,), pad, np.int32)
    s[:sum(lens)] = np.repeat(np.arange(len(lens)), lens)
    return s


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


# (q segment lengths, Tq, k segment lengths or None for the same ids,
# Tk): JAX's tests/test_varlen_attention.py packs [37, 100, 19] with
# equal offsets and [2, 7] / [6, 9] with unequal ones; here with
# trailing pads on both sides
LAYOUTS = {"same": ([37, 100, 19], 170, None, None),
           "unequal": ([2, 30, 7], 45, [6, 40, 9], 64)}


def _case(layout, h, kvh, seed):
    lq, tq, lk, tk = LAYOUTS[layout]
    seg_q = _seg(lq, tq, -1)
    seg_k = seg_q if lk is None else _seg(lk, tk, -2)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((tq, h, D)).astype(np.float32)
    k = rng.standard_normal((len(seg_k), kvh, D)).astype(np.float32)
    v = rng.standard_normal((len(seg_k), kvh, D)).astype(np.float32)
    do = rng.standard_normal((tq, h, D)).astype(np.float32)
    return q, k, v, do, seg_q, seg_k


def _jax_vjp(q, k, v, do, seg_q, seg_k, causal, same, pallas):
    jsq = jnp.asarray(seg_q)
    jsk = jsq if seg_k is seg_q else jnp.asarray(seg_k)

    def f(q, k, v):
        return JV.flash_attention_varlen(
            q, k, v, jsq, jsk, causal=causal, use_pallas=pallas,
            interpret=pallas, same_offsets=same)
    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, seg_q, seg_k, causal, same):
    """(o, dq, dk, dv) by torch.autograd.grad through
    flash_attention_varlen, and (dq, dk, dv) of the plain versions."""
    t = torch.from_numpy
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    sq = t(seg_q)
    sk = sq if seg_k is seg_q else t(seg_k)
    o = TV.flash_attention_varlen(qt, kt, vt, sq, sk, causal=causal,
                                  same_offsets=same)
    grads = torch.autograd.grad(o, (qt, kt, vt), t(do))
    scale = D ** -0.5
    o_ref, lse = TV.varlen_fwd_reference(t(q), t(k), t(v), sq, sk, causal,
                                         scale)
    delta = (t(do) * o_ref).sum(-1).T.contiguous()
    args = (t(q), t(k), t(v), t(do), lse, delta, sq, sk, causal, scale)
    plain = [TV.varlen_bwd_dq_reference(*args),
             *TV.varlen_bwd_dkv_reference(*args)]
    return ([o.detach().numpy()] + [g.numpy() for g in grads],
            [g.numpy() for g in plain])


SETUPS = [("same", True), ("same", False), ("unequal", False)]


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2)], ids=["g1", "g2"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("layout,same", SETUPS,
                         ids=["same-skip", "same-noskip", "unequal"])
def test_grads_match_jax_reference(layout, same, causal, h, kvh):
    q, k, v, do, seg_q, seg_k = _case(layout, h, kvh, seed=h + kvh)
    want = _jax_vjp(q, k, v, do, seg_q, seg_k, causal, same, False)
    got, plain = _port_grads(q, k, v, do, seg_q, seg_k, causal, same)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=REF_ATOL, rtol=0,
                                   err_msg=name)
    for name, a, b in zip(("dq", "dk", "dv"), plain, want[1:]):
        np.testing.assert_allclose(a, b, atol=REF_ATOL, rtol=0,
                                   err_msg=f"plain {name}")


@pytest.mark.parametrize("layout,same,causal,h,kvh", [
    ("same", True, True, 4, 2), ("same", False, False, 2, 2),
    ("unequal", False, True, 4, 2), ("unequal", False, False, 2, 1)])
def test_grads_match_pallas_kernels_interpret(layout, same, causal, h, kvh):
    """JAX's dQ and dK/dV kernels run in interpret mode (and its forward
    kernel), through jax.vjp of flash_attention_varlen."""
    q, k, v, do, seg_q, seg_k = _case(layout, h, kvh, seed=7)
    want = _jax_vjp(q, k, v, do, seg_q, seg_k, causal, same, True)
    got, plain = _port_grads(q, k, v, do, seg_q, seg_k, causal, same)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=PALLAS_ATOL, rtol=0,
                                   err_msg=name)
    for name, a, b in zip(("dq", "dk", "dv"), plain, want[1:]):
        np.testing.assert_allclose(a, b, atol=PALLAS_ATOL, rtol=0,
                                   err_msg=f"plain {name}")


def test_rows_and_keys_that_see_nothing_get_zero_gradients():
    """A query segment with no key (and the query pads) gets dQ = 0; a
    key segment no query has (and the key pads) gets dK = dV = 0,
    whatever dO the pad rows carry."""
    rng = np.random.default_rng(3)
    seg_q = np.array([0] * 5 + [1] * 4 + [2] * 6 + [-1] * 3, np.int32)
    seg_k = np.array([0] * 4 + [2] * 5 + [3] * 3 + [-1] * 2, np.int32)
    t = torch.from_numpy
    q = t(rng.standard_normal((18, 2, 8)).astype(np.float32))
    kv = [t(rng.standard_normal((14, 1, 8)).astype(np.float32))
          for _ in range(2)]
    do = t(rng.standard_normal((18, 2, 8)).astype(np.float32))
    for causal in (True, False):
        leaves = [x.clone().requires_grad_() for x in (q, *kv)]
        o = TV.flash_attention_varlen(*leaves, t(seg_q), t(seg_k),
                                      causal=causal)
        dq, dk, dv = torch.autograd.grad(o, leaves, do)
        dead_q = (seg_q < 0) | (seg_q == 1)
        dead_k = (seg_k < 0) | (seg_k == 3)
        assert bool((dq[dead_q] == 0).all())
        assert bool((dk[dead_k] == 0).all()) and bool((dv[dead_k] == 0).all())
        assert bool(dq[~dead_q].abs().sum() > 0)
        assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("equal", [True, False], ids=["equal", "unequal"])
def test_flash_attn_unpadded_matches_jax(equal, causal):
    """Output and gradients through the Paddle-shaped entry, cu_seqlens
    equal (the diagonal skip) or not, GQA group 2, trailing pads."""
    lq = [37, 100, 19]
    lk = lq if equal else [40, 100, 30]
    tq, tk = 170, 180
    rng = np.random.default_rng(11)
    q = rng.standard_normal((tq, 4, D)).astype(np.float32)
    k = rng.standard_normal((tk, 2, D)).astype(np.float32)
    v = rng.standard_normal((tk, 2, D)).astype(np.float32)
    do = rng.standard_normal((tq, 4, D)).astype(np.float32)
    cu_q, cu_k = _cu(lq), _cu(lk)

    def f(q, k, v):
        return JV.flash_attn_unpadded(q, k, v, jnp.asarray(cu_q),
                                      jnp.asarray(cu_k), causal=causal,
                                      use_pallas=False, interpret=False)[0]
    jo, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(jo)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, sm = TV.flash_attn_unpadded(*leaves, torch.from_numpy(cu_q),
                                     cu_k.tolist(), max_seqlen_q=100,
                                     max_seqlen_k=100, causal=causal,
                                     return_softmax=True)
    assert sm is None
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, a, b in zip(("o", "dq", "dk", "dv"),
                          [out.detach()] + list(grads), want):
        np.testing.assert_allclose(a.numpy(), b, atol=REF_ATOL, rtol=0,
                                   err_msg=name)


def test_flash_attn_unpadded_same_offsets_from_cu_seqlens(monkeypatch):
    """same_offsets as JAX sets it: the same object, else equal values."""
    seen = []
    real = TV.flash_attention_varlen

    def spy(*a, **kw):
        seen.append(kw["same_offsets"])
        return real(*a, **kw)
    monkeypatch.setattr(TV, "flash_attention_varlen", spy)
    q = torch.randn(20, 2, 8)
    cu = np.array([0, 7, 20], np.int32)
    TV.flash_attn_unpadded(q, q, q, cu, cu, causal=True)
    TV.flash_attn_unpadded(q, q, q, cu, cu.copy(), causal=True)
    TV.flash_attn_unpadded(q, q, q, cu, np.array([0, 8, 20], np.int32))
    assert seen == [True, True, False]


def test_dropout_while_training_raises_naming_item_13():
    q = torch.randn(20, 2, 8)
    cu = np.array([0, 7, 20], np.int32)
    with pytest.raises(NotImplementedError, match="item 13"):
        TV.flash_attn_unpadded(q, q, q, cu, cu, dropout=0.1)
    # not training: the kernel path, as in JAX
    out, _ = TV.flash_attn_unpadded(q, q, q, cu, cu, dropout=0.1,
                                    training=False)
    torch.testing.assert_close(out, TV.flash_attn_unpadded(q, q, q, cu,
                                                           cu)[0])
    x = torch.randn(1, 16, 2, 8)
    with pytest.raises(NotImplementedError, match="item 13"):
        TF.flash_attention(x, x, x, dropout=0.1)
    out, _ = TF.flash_attention(x, x, x, dropout=0.1, training=False)
    torch.testing.assert_close(out, TF.flash_attention(x, x, x)[0])


# ------------------------------------------------------ fused linear + CE
def _ce_inputs(n=24, hidden=16, vocab=37, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hidden)).astype(np.float32)
    w = (rng.standard_normal((hidden, vocab)) * 0.5).astype(np.float32)
    b = rng.standard_normal((vocab,)).astype(np.float32)
    labels = rng.integers(0, vocab, n)
    labels[[2, 9, 17]] = -100
    return x, w, b, labels


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_fused_linear_cross_entropy_matches_jax(reduction, bias):
    """Vocabulary 37 in chunks of 8 (the last one 5 wide), three rows
    labelled ignore_index."""
    x, w, b, labels = _ce_inputs()
    n_in = 3 if bias else 2
    ins = (x, w, b)[:n_in]
    rng = np.random.default_rng(5)
    ct = (rng.standard_normal(len(labels)).astype(np.float32)
          if reduction == "none" else np.float32(1.5))

    def f(*a):
        return JFU.fused_linear_cross_entropy(
            a[0], a[1], jnp.asarray(labels), bias=a[2] if bias else None,
            chunk_size=8, reduction=reduction)
    jo, vjp = jax.vjp(f, *map(jnp.asarray, ins))
    want = [np.asarray(jo)] + [np.asarray(g)
                               for g in vjp(jnp.asarray(ct))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    out = TFU.fused_linear_cross_entropy(
        leaves[0], leaves[1], torch.from_numpy(labels),
        bias=leaves[2] if bias else None, chunk_size=8, reduction=reduction)
    grads = torch.autograd.grad(out, leaves, torch.as_tensor(ct))
    for name, a, bb in zip(("loss", "dx", "dw", "db"),
                           [out.detach()] + list(grads), want):
        np.testing.assert_allclose(a.numpy(), bb, atol=2e-6, rtol=1e-5,
                                   err_msg=name)


def test_fused_linear_cross_entropy_equals_the_full_logits():
    """Chunked or not, the loss is the cross entropy of x @ w + b."""
    x, w, b, labels = (torch.from_numpy(a) for a in _ce_inputs(seed=2))
    want = torch.nn.functional.cross_entropy(x @ w + b, labels.long(),
                                             ignore_index=-100)
    for chunk in (5, 8, 37, 1000):
        got = TFU.fused_linear_cross_entropy(x, w, labels, bias=b,
                                             chunk_size=chunk)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


# ------------------------------------------------------ the train step
DIMS = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, ffn=64)
CFG = LlamaConfig.tiny(**DIMS)
LR = 3e-4
STEPS = 2


def _batch(packed):
    rng = np.random.default_rng(0)
    x = rng.integers(0, DIMS["vocab"], (4, 16))
    y = rng.integers(0, DIMS["vocab"], (4, 16))
    y[0, :5] = -1
    y[2, 9:] = -1
    if not packed:
        return x, y
    doc = np.stack([np.repeat(np.arange(len(lens)), lens) for lens in
                    ([5, 7, 4], [16], [3, 3, 10], [8, 8])])
    return x, y, doc


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params():
    return M.init_params(JaxConfig.tiny(**DIMS), seed=3)


# (remat, fused_ce, packed documents, n_micro): the fused head under
# full remat with packed documents, and under the dots policy (remat
# changes no number: the dots step with the full logits is held to the
# fused one below, and gradient accumulation to the one-shot step)
STEP_SETUPS = {"fused_packed": (True, True, True, None),
               "dots_fused": ("dots", True, False, None)}


@pytest.fixture(scope="module")
def step_runs():
    """Each setup's losses, step-1 gradients and parameters after the
    steps, on both sides."""
    cfg = JaxConfig.tiny(**DIMS)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    out = {}
    for name, (remat, fused, packed, n_micro) in STEP_SETUPS.items():
        batch = _batch(packed)
        grads = _np(jax.jit(jax.grad(
            lambda p, b: M.loss_fn(p, b, cfg, fused_ce=fused)))(
                _jax_params(), batch))
        params = _jax_params()
        opt = M.init_opt_state(params)
        step = M.make_train_step(cfg, mesh, n_micro=n_micro, remat=remat,
                                 fused_ce=fused, donate=False)
        losses = []
        for i in range(STEPS):
            params, opt, loss = step(params, opt, np.int32(i), batch)
            losses.append(float(loss))
        jax_side = (losses, grads, _np(params))
        tp = T.params_from_jax(_np(_jax_params()), "cpu")
        _, tg = T.loss_and_grads(tp, tuple(map(torch.from_numpy, batch)),
                                 CFG, remat=remat, fused_ce=fused)
        topt = T.init_opt_state(tp)
        tstep = T.make_train_step(CFG, n_micro=n_micro, remat=remat,
                                  fused_ce=fused, device="cpu")
        tl = [float(tstep(tp, topt, i, batch)[2]) for i in range(STEPS)]
        out[name] = (jax_side, (tl, tg, tp))
    return out


@pytest.mark.parametrize("name", sorted(STEP_SETUPS))
def test_step_matches_jax(step_runs, name):
    (jl, jg, jp), (tl, tg, tp) = step_runs[name]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for a, b in zip(T._leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=1e-4)
    for a, b in zip(T._leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), b, atol=2.5 * LR, rtol=0)
        assert float(np.linalg.norm(a.numpy() - b)) <= \
            1e-5 * float(np.linalg.norm(b)) + 1e-7


@pytest.mark.parametrize("remat", [True, "dots"], ids=["remat", "dots"])
def test_fused_ce_and_full_logits_give_the_same_step(remat):
    """fused_ce changes where the logits live, not the numbers."""
    batch = tuple(map(torch.from_numpy, _batch(False)))
    tp = T.params_from_jax(_np(_jax_params()), "cpu")
    full = T.loss_and_grads(tp, batch, CFG, remat=remat, fused_ce=False)
    fused = T.loss_and_grads(tp, batch, CFG, remat=remat, fused_ce=True)
    torch.testing.assert_close(fused[0], full[0], atol=1e-6, rtol=1e-6)
    for a, b in zip(T._leaves(fused[1]), T._leaves(full[1])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)


def test_fused_grad_accumulation_equals_one_shot_step():
    """n_micro=2 sums the fused head's NLL and valid counts as it sums
    the full logits' (test_torch_train.py), packed documents and all."""
    batch = tuple(map(torch.from_numpy, _batch(True)))
    tp = T.params_from_jax(_np(_jax_params()), "cpu")
    one = T.loss_and_grads(tp, batch, CFG, fused_ce=True)
    acc = T.loss_and_grads(tp, batch, CFG, n_micro=2, remat="dots",
                           fused_ce=True)
    torch.testing.assert_close(acc[0], one[0], atol=1e-6, rtol=1e-6)
    for a, b in zip(T._leaves(acc[1]), T._leaves(one[1])):
        torch.testing.assert_close(a, b.float(), atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("env,want", [(None, 0), ("0", 0), ("1", 1)])
def test_pt_fused_ce_selects_the_head(monkeypatch, env, want):
    """fused_ce=None (the default) reads PT_FUSED_CE, as the JAX step
    does; an explicit value wins over it."""
    if env is None:
        monkeypatch.delenv("PT_FUSED_CE", raising=False)
    else:
        monkeypatch.setenv("PT_FUSED_CE", env)
    calls = []
    real = T.fused_linear_cross_entropy

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(T, "fused_linear_cross_entropy", spy)
    params = T.params_from_jax(_np(_jax_params()), "cpu")
    opt = T.init_opt_state(params)
    T.make_train_step(CFG, device="cpu")(params, opt, 0, _batch(False))
    assert len(calls) == want
    T.make_train_step(CFG, fused_ce=False, device="cpu")(
        params, opt, 1, _batch(False))
    assert len(calls) == want


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_mm_count(remat):
    params = T.params_from_jax(_np(_jax_params()), "cpu")
    leaves = [p.requires_grad_() for p in T._leaves(params)]
    x, y = (torch.from_numpy(a) for a in _batch(False))
    loss = T.loss_fn(params, (x, y), CFG, remat=remat)
    mode = _CountMM()
    with mode:
        torch.autograd.grad(loss, leaves)
    return mode.n


def test_dots_policy_keeps_the_matmul_outputs():
    """Under remat="dots" the backward runs no more matmuls than without
    remat (the projections of a layer are saved, not recomputed), while
    full remat recomputes them (those whose outputs the backward needs:
    the checkpoint stops before the last)."""
    none, dots, full = (_backward_mm_count(r) for r in (False, "dots", True))
    assert dots == none
    assert full > none


def test_dots_runs_the_attention_forward_again(monkeypatch):
    """The attention kernels' outputs are not the dispatcher's to save,
    so under remat="dots" each layer's attention forward runs twice a
    step (forward and recompute), as under full remat."""
    calls = {"fwd": 0, "dq": 0}
    real_fwd, real_dq = TF.flash_fwd_reference, TF.flash_bwd_dq_reference

    def fwd(*a):
        calls["fwd"] += 1
        return real_fwd(*a)

    def dq(*a):
        calls["dq"] += 1
        return real_dq(*a)
    monkeypatch.setattr(TF, "flash_fwd_reference", fwd)
    monkeypatch.setattr(TF, "flash_bwd_dq_reference", dq)
    params = T.params_from_jax(_np(_jax_params()), "cpu")
    step = T.make_train_step(CFG, remat="dots", fused_ce=False, device="cpu")
    step(params, T.init_opt_state(params), 0, _batch(False))
    assert calls == {"fwd": 2 * DIMS["layers"], "dq": DIMS["layers"]}


# --------------------------------------------- Paddle-shaped flash_attention
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa"])
def test_paddle_flash_attention_matches_jax(kvh, causal):
    """(B, S, H, D) in, out and gradients as JAX's surface gives them
    (its reference path), GQA by repeat; return_softmax adds a None."""
    rng = np.random.default_rng(kvh)
    q = rng.standard_normal((2, 24, 4, D)).astype(np.float32)
    k = rng.standard_normal((2, 24, kvh, D)).astype(np.float32)
    v = rng.standard_normal((2, 24, kvh, D)).astype(np.float32)
    do = rng.standard_normal((2, 24, 4, D)).astype(np.float32)

    def f(q, k, v):
        return jax_flash_attention(q, k, v, causal=causal,
                                   use_pallas=False)[0]
    jo, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(jo)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    res = TF.flash_attention(*leaves, causal=causal, return_softmax=True)
    assert len(res) == 3 and res[1] is None and res[2] is None
    assert len(TF.flash_attention(*leaves, causal=causal)) == 2
    grads = torch.autograd.grad(res[0], leaves, torch.from_numpy(do))
    for name, a, b in zip(("o", "dq", "dk", "dv"),
                          [res[0].detach()] + list(grads), want):
        np.testing.assert_allclose(a.numpy(), b, atol=REF_ATOL, rtol=0,
                                   err_msg=name)


def test_paddle_flash_attention_keeps_the_causal_refusal():
    """Causal with S != S_k: the kernels align top-left and JAX's
    reference bottom-right (ROADMAP Queue 3), so the port refuses."""
    q = torch.randn(1, 8, 2, D)
    k = torch.randn(1, 12, 2, D)
    with pytest.raises(ValueError, match="sq == sk"):
        TF.flash_attention(q, k, k, causal=True)
