"""paddle_tpu_torch on the card: the Hopper ragged paged-attention kernel
and the three flash-attention kernels against their plain PyTorch
versions over the shapes they cover, the card engine against the CPU
engine, and a tiny-width train step on the card against the CPU.

Every test here needs a CUDA device and skips without one. This file
imports neither jax nor paddle_tpu, so on a machine without jax it runs
on its own:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
import paddle_tpu_torch.ops.flash_attention as fa
from paddle_tpu_torch.models import llama_spmd as T
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.llama_spmd import init_params
from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
from paddle_tpu_torch.ops.paged_attention import quantize_kv

pytestmark = pytest.mark.cuda

# variant -> (pool dtype, q dtype)
VARIANTS = {"float32": ("float32", "float32"),
            "bfloat16": ("bfloat16", "bfloat16"),
            "int8": ("int8", "bfloat16"),
            "int8_fp32q": ("int8", "float32")}
# By q's (and the output's) dtype, compared in fp32. fp32: sums in
# another order within a page. bf16: both sides round the same fp32
# value, and a rounding to the other side costs one ulp, at most
# 2^-7 = 7.8e-3 of the value; atol covers values near zero. int8 pages
# dequantize by the same fp32 products on both sides.
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-3, 8e-3)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _wave(dev, dtype, qh, kvh, d, page, seed=0):
    """Slot 0 prefills 9 rows at positions 20..28, slots 1-3 decode at
    ragged lengths, 4 inactive rows."""
    rng = np.random.default_rng(seed)
    pps = -(-70 // page)
    slots = 4
    num_pages = slots * pps + 1
    ptab = rng.permutation(num_pages - 1)[:slots * pps].reshape(
        slots, pps).astype(np.int32)
    slot = np.array([0] * 9 + [1, 2, 3] + [0] * 4, np.int32)
    pos = np.array(list(range(20, 29)) + [0, page, 69] + [-1] * 4, np.int32)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    pools, qname = VARIANTS[dtype]
    q = torch.randn((len(pos), qh, d), generator=g, device=dev).to(
        getattr(torch, qname))
    k = torch.randn((kvh, num_pages, page, d), generator=g, device=dev)
    v = torch.randn((kvh, num_pages, page, d), generator=g, device=dev)
    ks = vs = None
    if pools == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    else:
        k, v = k.to(q.dtype), v.to(q.dtype)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return q, k, v, ks, vs, t(ptab), t(slot), t(pos)


@pytest.mark.parametrize("dtype", list(VARIANTS))
@pytest.mark.parametrize("qh,kvh,d,page", [
    (32, 8, 128, 16), (8, 8, 64, 8), (32, 1, 16, 64), (16, 2, 256, 32),
    (64, 1, 256, 64), (12, 4, 96, 5)])
def test_kernel_matches_plain(card, dtype, qh, kvh, d, page):
    q, k, v, ks, vs, ptab, slot, pos = _wave(card, dtype, qh, kvh, d, page)
    before = rpa.launches
    ker = rpa.ragged_paged_attention(q, k, v, ptab, slot, pos,
                                     k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert rpa.launches == before + 1
    assert ker.dtype == q.dtype
    ref = rpa.ragged_paged_attention_reference(q, k, v, ptab, slot, pos,
                                               k_scale=ks, v_scale=vs)
    atol, rtol = TOL[VARIANTS[dtype][1]]
    active = pos >= 0
    torch.testing.assert_close(ker.float()[active], ref.float()[active],
                               atol=atol, rtol=rtol)
    assert bool((ker[~active] == 0).all())


def test_kernel_refuses_what_it_does_not_take(card):
    q, k, v, _, _, ptab, slot, pos = _wave(card, "float32", 8, 2, 32, 16)
    with pytest.raises(ValueError, match="int32"):
        rpa.ragged_paged_attention(q, k, v, ptab, slot.long(), pos)
    with pytest.raises(ValueError, match="dtype"):
        rpa.ragged_paged_attention(q, k.bfloat16(), v.bfloat16(), ptab,
                                   slot, pos)
    with pytest.raises(ValueError, match="contiguous"):
        rpa.ragged_paged_attention(q.transpose(0, 1).contiguous()
                                   .transpose(0, 1), k, v, ptab, slot, pos)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((2, 128, 256), device=card)
        pages = torch.zeros((1, 3, 64, 256), device=card)
        rpa.ragged_paged_attention(big, pages, pages,
                                   ptab[:, :3].contiguous(), slot[:2],
                                   pos[:2])


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_card_engine_matches_cpu_engine(card, cache_dtype):
    cfg = LlamaConfig.tiny(vocab=128, hidden=128, layers=2, heads=4,
                           kv_heads=2, ffn=256)
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = {k: ({kk: vv.to(card) for kk, vv in v.items()}
               if isinstance(v, dict) else v.to(card))
           for k, v in cpu.items()}
    outs = []
    for dev, params in ((card, gpu), ("cpu", cpu)):
        for pipelined in (False, True):
            eng = ServingEngine(params, cfg, max_seqs=3, max_seq_len=64,
                                page_size=8, cache_dtype=cache_dtype,
                                device=dev)
            for i, n in enumerate((5, 17, 30)):
                eng.submit(Request(i, list(range(1, n + 1)),
                                   max_new_tokens=12,
                                   **({"temperature": 0.9, "seed": i}
                                      if i == 1 else {})))
            rpa.launches = 0
            done = eng.run_pipelined() if pipelined else eng.run()
            want = cfg.num_hidden_layers * eng.device_steps \
                if dev is card else 0
            assert rpa.launches == want
            assert eng.pool.conserved(drained=True)
            outs.append({r.rid: r.output for r in done})
    assert outs[0] == outs[1] == outs[2] == outs[3]


# ------------------------------------------------------------ flash attention
FLASH_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# by dtype, as TOL above: the kernels and the plain versions compute in
# fp32 from the same operands and sum in another order; bf16 outputs
# round the same fp32 value, one ulp apart at most. lse is fp32 in both.
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-3, 8e-3)}
LSE_TOL = (1e-5, 1e-5)


def _counts():
    return fa.launches_fwd, fa.launches_dq, fa.launches_dkv


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [64, 200, 1024])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_kernels_match_plain(card, dtype, s, d, causal, rep):
    """K and V repeated from 4 / rep heads, as the train step repeats
    GQA heads before the kernels."""
    dt = FLASH_DTYPES[dtype]
    g = torch.Generator(device=card)
    g.manual_seed(s + d)
    b, h = 2, 4

    def rnd(heads):
        return torch.randn((b, heads, s, d), generator=g, device=card).to(dt)
    q, do = rnd(h), rnd(h)
    k, v = (rnd(h // rep).repeat_interleave(rep, dim=1) for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    before = _counts()
    o, lse = fa._launch_fwd(q, k, v, causal, scale)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, scale)
    delta = (do.float() * o_ref.float()).sum(-1)
    dq = fa._launch_dq(q, k, v, do, lse_ref, delta, causal, scale)
    dk, dv = fa._launch_dkv(q, k, v, do, lse_ref, delta, causal, scale)
    torch.cuda.synchronize()
    assert _counts() == tuple(c + 1 for c in before)
    dq_ref = fa.flash_bwd_dq_reference(q, k, v, do, lse_ref, delta, causal,
                                       scale)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(q, k, v, do, lse_ref, delta,
                                                causal, scale)
    atol, rtol = FLASH_TOL[dt]
    for name, a, r in (("o", o, o_ref), ("dq", dq, dq_ref),
                       ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert a.dtype == dt, name
        torch.testing.assert_close(a.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=name)
    torch.testing.assert_close(lse, lse_ref, atol=LSE_TOL[0],
                               rtol=LSE_TOL[1])


@pytest.mark.parametrize("rep", [1, 4])
def test_flash_autograd_on_card_matches_cpu(card, rep):
    """Through the autograd Function and the GQA repeat, fp32: the
    card's kernels against the CPU's plain versions."""
    rng = np.random.default_rng(rep)
    q, w = (rng.standard_normal((1, 4, 200, 64)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((1, 4 // rep, 200, 64)).astype(np.float32)
            for _ in range(2))
    out = {}
    for dev in (card, torch.device("cpu")):
        ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in (q, k, v)]
        kk, vv = (t.repeat_interleave(rep, dim=1) for t in ts[1:])
        o = fa.flash_attention_bhsd(ts[0], kk, vv, causal=True)
        (o * torch.from_numpy(w).to(dev)).sum().backward()
        out[dev.type] = [o.detach().cpu()] + [t.grad.cpu() for t in ts]
    for name, a, b in zip(("o", "dq", "dk", "dv"), out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4, msg=name)


def test_flash_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros((1, 2, 64, 32), device=card)
    before = _counts()
    with pytest.raises(ValueError, match="float32/bfloat16"):
        fa._launch_fwd(q.half(), q.half(), q.half(), True, 1.0)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((1, 2, 64, 160), device=card)
        fa._launch_fwd(big, big, big, True, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        qt = q.transpose(2, 3).contiguous().transpose(2, 3)
        fa._launch_fwd(qt, q, q, True, 1.0)
    with pytest.raises(ValueError, match="dtypes differ"):
        fa._launch_fwd(q, q.bfloat16(), q, True, 1.0)
    assert _counts() == before


def test_train_step_on_card_matches_cpu(card):
    """fp32, TF32 off, remat on: two steps of the tiny model on the card
    and on the CPU from the same weights and batch. The flash kernels
    launch only on the card: twice per layer and step forward (the
    recompute), once dQ and once dK/dV."""
    cfg = LlamaConfig.tiny(vocab=128, hidden=128, layers=2, heads=4,
                           kv_heads=2, ffn=256)
    lr, steps = 3e-4, 2
    rng = np.random.default_rng(0)
    x = rng.integers(0, 128, (2, 64))
    y = rng.integers(0, 128, (2, 64))
    y[1, :10] = -1
    cpu = init_params(cfg, seed=0, device="cpu")
    res = {}
    for dev in (card, torch.device("cpu")):
        params = T.params_from_jax(
            {k: ({kk: vv.numpy() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.numpy())
             for k, v in cpu.items()}, dev)
        opt = T.init_opt_state(params)
        batch = (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
        _, grads = T.loss_and_grads(params, batch, cfg)
        step = T.make_train_step(cfg, lr=lr, device=dev)
        fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
        losses = [float(step(params, opt, i, batch)[2]) for i in range(steps)]
        res[dev.type] = (losses, T._leaves(grads), T._leaves(params),
                         _counts())
    L = cfg.num_hidden_layers
    assert res["cuda"][3] == (2 * L * steps, L * steps, L * steps)
    assert res["cpu"][3] == (0, 0, 0)
    np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=1e-5)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-4)
    for a, b in zip(res["cuda"][2], res["cpu"][2]):
        torch.testing.assert_close(a.cpu(), b, atol=2.5 * lr * steps, rtol=0)
