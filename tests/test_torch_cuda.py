"""paddle_tpu_torch on the card: the Hopper ragged paged-attention kernel,
the three flash-attention kernels, the three FlashMask kernels, the
varlen forward, dQ and dK/dV, the paged decode and the paged verify
kernels against their plain PyTorch versions over the shapes and masks
they cover, the card engines (ragged, bucketed, and bucketed with
speculative decoding and chunked prefill) against the CPU engines, and
tiny-width train steps (plain and packed documents, the fused
linear+CE head and remat="dots") on the card against the CPU.

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
import paddle_tpu_torch.ops.flashmask_attention as fm
import paddle_tpu_torch.ops.paged_attention as pa
import paddle_tpu_torch.ops.varlen_attention as va
from paddle_tpu_torch.models import llama_spmd as T
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.llama_spmd import init_params
from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
from paddle_tpu_torch.ops.flash_attention import tensor_core_operands
from paddle_tpu_torch.ops.fused import fused_linear_cross_entropy
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
# by dtype, as TOL above. fp32: the CUDA-core kernels and the plain
# versions compute in fp32 from the same operands and sum in another
# order. bf16: the kernels multiply on the tensor cores, S and dP from the
# bf16 operands exactly, and P (forward, dV) and dS (dQ, dK) split into
# two bf16 terms, 16 bits of each (one term, the TPU kernel's cast of P
# to V's dtype, moved forward rows that see few keys by up to two ulps);
# so they differ from the fp32 plain versions by sums in another order
# and 2^-17 of P and dS before the outputs round to bf16: one ulp apart at
# most. lse is fp32 in both.
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-3, 8e-3)}
LSE_TOL = (1e-5, 1e-5)


def _counts():
    return fa.launches_fwd, fa.launches_dq, fa.launches_dkv


def _offset_view(t):
    """t's values in a contiguous view one element into its storage, so
    its base is not 16-byte aligned (the bf16 forward's copies need it:
    the wrapper realigns)."""
    store = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = store[1:].view(t.shape)
    view.copy_(t)
    return view


# (s, d, causal, rep, layout): the training grid with GQA repeats; the
# bf16 forward's edges (S of one row, one short of and one past a 64-row
# tile, a long one; head dims of each instantiation and D = 72 and 100,
# padded by the wrapper to 72 and 104); S_k longer than S_q without
# causal, short and at the training length; operands at an unaligned
# storage offset
FLASH_CASES = (
    [(s, d, c, rep, "contiguous") for s in (64, 200, 1024) for d in (64, 128)
     for c in (False, True) for rep in (1, 4)]
    + [(s, d, c, 1, "contiguous") for s in (1, 63, 65, 2048)
       for d in (32, 64, 72, 100, 128) for c in (False, True)]
    + [(s, d, False, 1, "sk_longer") for s in (63, 200)
       for d in (72, 100, 128)]
    + [(2048, d, False, 1, "sk_longer") for d in (72, 128)]
    + [(s, d, c, 1, "offset") for s in (65, 200) for d in (64, 100, 128)
       for c in (False, True)])


@pytest.mark.parametrize("s,d,causal,rep,layout", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flash_kernels_match_plain(card, dtype, s, d, causal, rep, layout):
    """K and V repeated from 4 / rep heads, as the train step repeats
    GQA heads before the kernels."""
    dt = FLASH_DTYPES[dtype]
    g = torch.Generator(device=card)
    g.manual_seed(s + d)
    b, h = 2, 4
    sk = s + 77 if layout == "sk_longer" else s

    def rnd(heads, rows=s):
        return torch.randn((b, heads, rows, d), generator=g,
                           device=card).to(dt)
    q, do = rnd(h), rnd(h)
    k, v = (rnd(h // rep, sk).repeat_interleave(rep, dim=1)
            for _ in range(2))
    if layout == "offset":
        q, k, v, do = (_offset_view(t) for t in (q, k, v, do))
        assert q.data_ptr() % 16 != 0
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


# bf16 without the GQA repeat: its backward sums the `rep` heads' dK and dV
# after each was rounded to bf16, so one-ulp differences of single heads
# (the kernels' O differs from the plain O by an ulp in places, and delta
# with it) add up to several ulps of the sum, past FLASH_TOL by
# construction; each head's dK and dV are held at FLASH_TOL under GQA
# repeats in test_flash_kernels_match_plain.
@pytest.mark.parametrize("rep,dtype", [(1, "fp32"), (4, "fp32"),
                                       (1, "bf16")])
def test_flash_autograd_on_card_matches_cpu(card, rep, dtype):
    """Through the autograd Function and the GQA repeat: the card's
    kernels against the CPU's plain versions, at FLASH_TOL."""
    dt = FLASH_DTYPES[dtype]
    rng = np.random.default_rng(rep)
    q, w = (rng.standard_normal((1, 4, 200, 64)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((1, 4 // rep, 200, 64)).astype(np.float32)
            for _ in range(2))
    out = {}
    for dev in (card, torch.device("cpu")):
        ts = [torch.from_numpy(a).to(dev, dt).requires_grad_()
              for a in (q, k, v)]
        kk, vv = (t.repeat_interleave(rep, dim=1) for t in ts[1:])
        o = fa.flash_attention_bhsd(ts[0], kk, vv, causal=True)
        (o * torch.from_numpy(w).to(dev, dt)).sum().backward()
        out[dev.type] = [o.detach().cpu()] + [t.grad.cpu() for t in ts]
    atol, rtol = FLASH_TOL[dt]
    for name, a, b in zip(("o", "dq", "dk", "dv"), out["cuda"], out["cpu"]):
        assert a.dtype == dt, name
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol, msg=name)


@pytest.mark.parametrize("s,d,causal", [(2048, 128, True), (200, 100, False)])
def test_flash_bf16_backward_repeats_bit_for_bit(card, s, d, causal):
    """No atomics and a fixed order of sums: two launches of each bf16
    backward kernel on the same operands give the same bits."""
    g = torch.Generator(device=card)
    g.manual_seed(s + d)
    q, k, v, do = (torch.randn((2, 4, s, d), generator=g,
                               device=card).bfloat16() for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o, lse = fa._launch_fwd(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal, scale)
    runs = [[fa._launch_dq(*args), *fa._launch_dkv(*args)] for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), name


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


# ------------------------------------------------------------ FlashMask
def _fm_counts():
    return fm.launches_fwd, fm.launches_dq, fm.launches_dkv


def _fm_mask(flavor, b, h, s, rng):
    """(sri as a numpy array or None, causal, window) of one flavor."""
    def band(lo, hi):
        start = rng.integers(lo, hi, (b, h, s, 1))
        return start, np.minimum(start + rng.integers(0, s // 4 + 1,
                                                      (b, h, s, 1)), s)
    if flavor == "causal_n1_docs":
        ends = np.empty((b, s), np.int64)
        for r in range(b):
            cuts = np.sort(rng.choice(np.arange(1, s), 5, replace=False))
            edges = np.concatenate([[0], cuts, [s]])
            ends[r] = np.repeat(edges[1:], np.diff(edges))
        return ends[:, None, :, None], True, None
    if flavor == "causal_n2_band":
        return np.concatenate(band(0, s), -1), True, None
    if flavor == "noncausal_n2":
        return np.concatenate([rng.integers(s // 2, s + 1, (b, h, s, 1)),
                               rng.integers(0, s // 2, (b, h, s, 1))],
                              -1), False, None
    if flavor == "noncausal_n4":
        return np.concatenate([*band(0, s // 4), *band(s // 2, s)],
                              -1), False, None
    if flavor == "causal_n1_window":
        return rng.integers(1, s + 1, (b, h, s, 1)), True, (s // 4, 0)
    if flavor == "window_no_sri":
        return None, True, (s // 4, 0)
    if flavor == "noncausal_window_no_sri":
        return None, False, (s // 5, s // 7)
    assert flavor == "masked_rows"     # rows [s/4, s/2) see nothing
    sri = np.full((b, 1, s, 1), s, np.int64)
    sri[:, :, : s // 2] = s // 4
    return sri, True, None


FM_FLAVORS = ("causal_n1_docs", "causal_n2_band", "noncausal_n2",
              "noncausal_n4", "causal_n1_window", "window_no_sri",
              "noncausal_window_no_sri", "masked_rows")


def _fm_check(card, dt, s, d, flavor, dropout=0.0, seed=None,
              layout="contiguous"):
    """S_q = s; S_k = s, or s + 77 with layout "sk_longer" (the mask
    over S_k columns, causal aligned top-left). Each kernel's computed
    tiles are tile_plan's: dQ reads its rows, dK/dV its columns."""
    b, h = 2, 4
    sk = s + 77 if layout == "sk_longer" else s
    rng = np.random.default_rng(s + d)
    sri, causal, window = _fm_mask(flavor, b, h, sk, rng)
    g = torch.Generator(device=card)
    g.manual_seed(s + d)
    q, k, v, do = (torch.randn((b, h, n, d), generator=g,
                               device=card).to(dt) for n in (s, sk, sk, s))
    if layout == "offset":
        q, k, v, do = (_offset_view(t) for t in (q, k, v, do))
    sri = None if sri is None else torch.from_numpy(
        sri.astype(np.int32)).to(card)
    m = fm._Mask(causal, window, 1.0 / math.sqrt(d), dropout, seed)
    before = _fm_counts()
    o, lse, computed = fm._launch_fwd(q, k, v, sri, m, count_tiles=True)
    plan = fm.tile_plan(sri, s, sk, causal, window)
    want = int((plan != fm.SKIP).sum()) * (
        b * h // (plan.shape[0] * plan.shape[1]))
    o_ref, lse_ref = fm.flashmask_fwd_reference(q, k, v, sri, *m)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, sri, do, lse_ref, delta)
    dq, computed_dq = fm._launch_dq(*args, m, count_tiles=True)
    dk, dv, computed_dkv = fm._launch_dkv(*args, m, count_tiles=True)
    torch.cuda.synchronize()
    assert (computed, computed_dq, computed_dkv) == (want, want, want)
    assert _fm_counts() == tuple(c + 1 for c in before)
    dq_ref = fm.flashmask_bwd_dq_reference(*args, *m)
    dk_ref, dv_ref = fm.flashmask_bwd_dkv_reference(*args, *m)
    atol, rtol = FLASH_TOL[dt]
    for name, a, r in (("o", o, o_ref), ("dq", dq, dq_ref),
                       ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert a.dtype == dt, name
        torch.testing.assert_close(a.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=name)
    torch.testing.assert_close(lse, lse_ref, atol=LSE_TOL[0],
                               rtol=LSE_TOL[1])


# (s, d, layout): the first grid, then the bf16 forward's edges (one
# short of and one past a 64-row tile, a long row; D = 32, 72 and 100,
# the last padded by the wrapper), operands at an unaligned offset, and
# S_k longer than S_q
FM_CASES = ([(s, d, "contiguous") for s in (64, 200, 1024) for d in (64, 128)]
            + [(s, d, "contiguous") for s in (63, 65, 2048)
               for d in (32, 72, 100, 128)]
            + [(s, d, "offset") for s, d in ((65, 64), (200, 100))]
            + [(s, d, "sk_longer") for s, d in ((63, 64), (200, 100))])


@pytest.mark.parametrize("flavor", FM_FLAVORS)
@pytest.mark.parametrize("s,d,layout", FM_CASES)
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flashmask_kernels_match_plain(card, dtype, s, d, layout, flavor):
    """Every mask flavor (per-head (B, H, S, n) and shared (B, 1, S, n)
    sri, rows that keep nothing in masked_rows); the forward's computed
    tiles are tile_plan's."""
    _fm_check(card, FLASH_DTYPES[dtype], s, d, flavor, layout=layout)


@pytest.mark.parametrize("s,d", [(200, 64), (1024, 100), (65, 128)])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flashmask_dropout_kernels_match_plain(card, dtype, s, d):
    """The hash regenerated in all three kernels is the plain version's
    mask: rate 0.1, seed 1234567."""
    _fm_check(card, FLASH_DTYPES[dtype], s, d, "causal_n1_docs",
              dropout=0.1, seed=1234567)


@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_flashmask_autograd_on_card_matches_cpu(card, dtype):
    """Through the autograd Function with a (B, 1, S, 1) document mask
    shared by every head: the card's kernels (in bf16 dQ and dK/dV read
    tile aggregates computed once for both) against the CPU's plain
    versions, at FLASH_TOL."""
    dt = FLASH_DTYPES[dtype]
    rng = np.random.default_rng(0)
    sri = _fm_mask("causal_n1_docs", 1, 1, 300, rng)[0].astype(np.int32)
    q, k, v, w = (rng.standard_normal((1, 4, 300, 64)).astype(np.float32)
                  for _ in range(4))
    out = {}
    for dev in (card, torch.device("cpu")):
        ts = [torch.from_numpy(a).to(dev, dt).requires_grad_()
              for a in (q, k, v)]
        o = fm.flashmask_attention_bhsd(*ts, torch.from_numpy(sri).to(dev),
                                        causal=True)
        (o * torch.from_numpy(w).to(dev, dt)).sum().backward()
        out[dev.type] = [o.detach().cpu()] + [t.grad.cpu() for t in ts]
    atol, rtol = FLASH_TOL[dt]
    for name, a, b in zip(("o", "dq", "dk", "dv"), out["cuda"], out["cpu"]):
        assert a.dtype == dt, name
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol, msg=name)


@pytest.mark.parametrize("flavor,s,d", [("causal_n1_docs", 2048, 128),
                                        ("noncausal_n4", 200, 100)])
def test_flashmask_bf16_backward_repeats_bit_for_bit(card, flavor, s, d):
    """No atomics and a fixed order of sums: two launches of each bf16
    FlashMask backward kernel on the same operands give the same
    bits."""
    b, h = 2, 4
    rng = np.random.default_rng(s + d)
    sri, causal, window = _fm_mask(flavor, b, h, s, rng)
    sri = torch.from_numpy(sri.astype(np.int32)).to(card)
    g = torch.Generator(device=card)
    g.manual_seed(s + d)
    q, k, v, do = (torch.randn((b, h, s, d), generator=g,
                               device=card).bfloat16() for _ in range(4))
    m = fm._Mask(causal, window, 1.0 / math.sqrt(d), 0.0, None)
    o, lse = fm._launch_fwd(q, k, v, sri, m)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, sri, do, lse, delta, m)
    runs = [[fm._launch_dq(*args), *fm._launch_dkv(*args)] for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), name


def test_flashmask_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros((1, 2, 64, 32), device=card)
    sri = torch.full((1, 1, 64, 1), 64, dtype=torch.int32, device=card)
    m = fm._Mask(True, None, 1.0, 0.0, None)
    before = _fm_counts()
    with pytest.raises(ValueError, match="int32"):
        fm._launch_fwd(q, q, q, sri.long(), m)
    with pytest.raises(ValueError, match="must be"):
        fm._launch_fwd(q, q, q, torch.zeros((1, 3, 64, 1), dtype=torch.int32,
                                            device=card), m)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((1, 2, 64, 160), device=card)
        fm._launch_fwd(big, big, big, sri, m)
    with pytest.raises(ValueError, match="invalid"):
        fm._launch_fwd(q, q, q, sri.repeat(1, 1, 1, 4).contiguous(), m)
    assert _fm_counts() == before


def test_packed_train_step_on_card_matches_cpu(card):
    """fp32, TF32 off, remat on: two steps of the tiny model on packed
    documents, card against CPU. Only the FlashMask kernels launch on
    the card (twice per layer and step forward, once dQ, once dK/dV);
    nothing launches on the CPU."""
    cfg = LlamaConfig.tiny(vocab=128, hidden=128, layers=2, heads=4,
                           kv_heads=2, ffn=256)
    lr, steps = 3e-4, 2
    rng = np.random.default_rng(0)
    x = rng.integers(0, 128, (2, 64))
    y = rng.integers(0, 128, (2, 64))
    doc = np.stack([np.repeat(np.arange(3), [20, 30, 14]),
                    np.zeros(64, np.int64)])
    y[0, [19, 49, 63]] = -1
    cpu = init_params(cfg, seed=0, device="cpu")
    res = {}
    for dev in (card, torch.device("cpu")):
        params = T.params_from_jax(
            {k: ({kk: vv.numpy() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.numpy())
             for k, v in cpu.items()}, dev)
        opt = T.init_opt_state(params)
        batch = tuple(torch.from_numpy(a).to(dev) for a in (x, y, doc))
        _, grads = T.loss_and_grads(params, batch, cfg)
        step = T.make_train_step(cfg, lr=lr, device=dev)
        fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
        fm.launches_fwd = fm.launches_dq = fm.launches_dkv = 0
        losses = [float(step(params, opt, i, batch)[2]) for i in range(steps)]
        res[dev.type] = (losses, T._leaves(grads), T._leaves(params),
                         _fm_counts() + _counts())
    L = cfg.num_hidden_layers
    assert res["cuda"][3] == (2 * L * steps, L * steps, L * steps, 0, 0, 0)
    assert res["cpu"][3] == (0,) * 6
    np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=1e-5)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-4)
    for a, b in zip(res["cuda"][2], res["cpu"][2]):
        torch.testing.assert_close(a.cpu(), b, atol=2.5 * lr * steps, rtol=0)


# ------------------------------------------------------- bucketed serving
def _segments(lens, total):
    seg = np.full((total,), -1, np.int32)
    seg[:sum(lens)] = np.repeat(np.arange(len(lens)), lens)
    return seg


# (q segment lengths, Tq, k segment lengths or None for the same ids, Tk)
VARLEN_LAYOUTS = {"same": ([70, 1, 130, 64], 300, None, None),
                  "unequal": ([40, 90, 33], 200, [60, 90, 150], 320),
                  "one_tile": ([5, 9], 20, None, None)}


# The forward's layouts: VARLEN_LAYOUTS, and the bf16 tensor-core
# kernel's edges: Tq of 1, one short of and one past a 64-row tile, and
# 2048 (segments ending and pads starting inside a tile, tiles wholly
# inside one segment); unequal offsets with pad rows inside a tile and a
# key segment no query has.
VARLEN_FWD_LAYOUTS = {**VARLEN_LAYOUTS,
                      "t1": ([1], 1, None, None),
                      "t63": ([20, 43], 63, None, None),
                      "t65": ([30, 33], 65, None, None),
                      "t2048": ([700, 1, 600, 500], 2048, None, None),
                      "unequal_t65": ([10, 40], 65, [30, 45, 20], 130)}
# (layout, h, kvh, d): the GQA grid over VARLEN_LAYOUTS; the edges at the
# head dims of each instantiation and at 40, 72 and 100 (the wrapper pads
# a bf16 D = 100 to 104)
VARLEN_FWD_CASES = (
    [(lay, h, kvh, d) for lay in sorted(VARLEN_LAYOUTS)
     for h, kvh, d in ((4, 4, 64), (8, 2, 128), (4, 1, 40))]
    + [(lay, 4, 2, d) for lay in ("t1", "t63", "t65", "t2048", "unequal_t65")
       for d in (32, 40, 72, 100, 128)])


@pytest.mark.parametrize("layout,h,kvh,d", VARLEN_FWD_CASES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_varlen_kernel_matches_plain(card, dtype, h, kvh, d, causal, layout):
    """o and lse against the plain version, padding rows exactly 0, and
    the tiles the forward computed against `tile_plan`'s."""
    lq, tq, lk, tk = VARLEN_FWD_LAYOUTS[layout]
    dt = FLASH_DTYPES[dtype]
    seg_q = torch.from_numpy(_segments(lq, tq)).to(card)
    seg_k = seg_q if lk is None else torch.from_numpy(
        _segments(lk, tk)).to(card)
    g = torch.Generator(device=card)
    g.manual_seed(d)
    q = torch.randn((tq, h, d), generator=g, device=card).to(dt)
    k = torch.randn((len(seg_k), kvh, d), generator=g, device=card).to(dt)
    v = torch.randn((len(seg_k), kvh, d), generator=g, device=card).to(dt)
    before = va.launches_fwd
    o = va.flash_attention_varlen(q, k, v, seg_q, seg_k, causal=causal)
    torch.cuda.synchronize()
    assert va.launches_fwd == before + 1 and o.dtype == dt
    sq, sk = va._sentinels(seg_q, seg_k)
    o2, lse, tiles = va._launch_fwd(q, k, v, sq, sk, causal, d ** -0.5,
                                    lk is None, count_tiles=True)
    o_ref, lse_ref = va.varlen_fwd_reference(q, k, v, seg_q, seg_k, causal,
                                             d ** -0.5)
    atol, rtol = FLASH_TOL[dt]
    assert o.shape == o_ref.shape
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(o2, o)
    torch.testing.assert_close(lse, lse_ref, atol=LSE_TOL[0],
                               rtol=LSE_TOL[1])
    assert bool((o[seg_q < 0] == 0).all())
    plan = va.tile_plan(seg_q, seg_k, causal, lk is None)
    assert tiles == int((plan != va.SKIP).sum()) * h


@pytest.mark.parametrize("extra", [0, 3], ids=["aligned", "odd_rows"])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_varlen_kernel_reads_strided_operands(card, dtype, extra):
    """q, k, v as column slices of one fused projection (row strides
    larger than heads x D) give the same answer as contiguous copies.
    With `extra` columns before q a row holds 259 values: the bf16
    kernel's 16-byte copies cannot read such rows, so its wrapper copies
    the operands first; the aligned bf16 slices are read in place."""
    seg = torch.from_numpy(_segments([50, 80], 150)).to(card)
    x = torch.randn((150, extra + 4 * 32 + 2 * 2 * 32), device=card).to(
        FLASH_DTYPES[dtype])
    q = x[:, extra:extra + 128].view(150, 4, 32)
    k = x[:, extra + 128:extra + 192].view(150, 2, 32)
    v = x[:, extra + 192:].view(150, 2, 32)
    assert not q.is_contiguous()
    copied = tensor_core_operands(q, k, v)
    assert all((a is b) == (extra == 0) for a, b in zip((q, k, v), copied))
    a = va.flash_attention_varlen(q, k, v, seg, seg, causal=True)
    b = va.flash_attention_varlen(q.contiguous(), k.contiguous(),
                                  v.contiguous(), seg, seg, causal=True)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("layout", sorted(VARLEN_FWD_LAYOUTS))
def test_varlen_positions_equal_rev_pos(card, layout):
    """The kernels' segment distances, computed on the card by
    va_positions, equal the plain `rev_pos` of both id vectors."""
    lq, tq, lk, tk = VARLEN_FWD_LAYOUTS[layout]
    seg_q = torch.from_numpy(_segments(lq, tq)).to(card)
    seg_k = seg_q if lk is None else torch.from_numpy(
        _segments(lk, tk)).to(card)
    sq, sk = va._sentinels(seg_q, seg_k)
    pos_q, pos_k = torch.empty_like(sq), torch.empty_like(sk)
    rc = va._lib().va_positions(sq.data_ptr(), sk.data_ptr(), len(sq),
                                len(sk), pos_q.data_ptr(), pos_k.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(pos_q, va.rev_pos(sq))
    assert torch.equal(pos_k, va.rev_pos(sk))


@pytest.mark.parametrize("t,d,causal", [(2048, 128, True), (300, 100, False)])
def test_varlen_bf16_forward_repeats_bit_for_bit(card, t, d, causal):
    """No atomics and a fixed order of sums: two launches of the bf16
    forward on the same operands give the same bits, o and lse."""
    lens = [700, 1, 600, 500] if t == 2048 else [70, 1, 130, 64]
    seg = torch.from_numpy(_segments(lens, t)).to(card)
    g = torch.Generator(device=card)
    g.manual_seed(t + d)
    q = torch.randn((t, 8, d), generator=g, device=card).bfloat16()
    k, v = (torch.randn((t, 2, d), generator=g, device=card).bfloat16()
            for _ in range(2))
    sq, sk = va._sentinels(seg, seg)
    runs = [va._launch_fwd(q, k, v, sq, sk, causal, d ** -0.5, True)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0].view(torch.int16),
                       runs[1][0].view(torch.int16))
    assert torch.equal(runs[0][1].view(torch.int32),
                       runs[1][1].view(torch.int32))


def test_varlen_kernel_skips_tiles_outside_the_segments(card):
    """Two prompts of 64 in a 256 bucket, causal, same offsets: of the
    10 causal 64 x 64 tiles a head has, only the two diagonal tiles of
    the prompts touch a segment."""
    seg = torch.from_numpy(_segments([64, 64], 256)).to(card)
    q = torch.randn((256, 2, 64), device=card)
    kv = torch.randn((256, 1, 64), device=card)
    sq, sk = va._sentinels(seg, seg)
    *_, tiles = va._launch_fwd(q, kv, kv, sq, sk, True, 0.125, True,
                               count_tiles=True)
    assert tiles == 2 * 2


def test_varlen_kernel_refuses_what_it_does_not_take(card):
    seg = torch.zeros((64,), dtype=torch.int32, device=card)
    q = torch.randn((64, 4, 32), device=card)
    kv = torch.randn((64, 2, 32), device=card)
    with pytest.raises(ValueError, match="dtype"):
        va.flash_attention_varlen(q, kv.bfloat16(), kv.bfloat16(), seg, seg)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.randn((64, 2, 160), device=card)
        va.flash_attention_varlen(big, big, big, seg, seg)
    with pytest.raises(ValueError, match="multiple"):
        va.flash_attention_varlen(q, torch.randn((64, 3, 32), device=card),
                                  torch.randn((64, 3, 32), device=card),
                                  seg, seg)
    with pytest.raises(ValueError, match="operand on"):
        va.flash_attention_varlen(q, kv, kv, seg, seg.cpu())
    # an operand that needs a gradient runs both backward kernels, which
    # agree with their plain versions
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, kv, kv))
    before = _va_counts()
    o = va.flash_attention_varlen(qg, kg, vg, seg, seg, causal=True)
    do = torch.randn_like(o)
    grads = torch.autograd.grad(o, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert _va_counts() == tuple(c + 1 for c in before)
    sq, sk = va._sentinels(seg, seg)
    o_ref, lse = va.varlen_fwd_reference(q, kv, kv, seg, seg, True,
                                         32 ** -0.5)
    delta = (do * o_ref).sum(-1).T.contiguous()
    args = (q, kv, kv, do, lse, delta, sq, sk, True, 32 ** -0.5)
    want = [va.varlen_bwd_dq_reference(*args),
            *va.varlen_bwd_dkv_reference(*args)]
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4, msg=name)


def _va_counts():
    return va.launches_fwd, va.launches_dq, va.launches_dkv


def _varlen_bwd_operands(card, dt, lq, tq, lk, tk, h, kvh, d, causal,
                         seed):
    """(q, k, v, dO, seg_q, seg_k, lse, delta) of one layout, lse from the
    plain forward and delta = rowsum(dO * O) over its output."""
    seg_q = torch.from_numpy(_segments(lq, tq)).to(card)
    seg_k = seg_q if lk is None else torch.from_numpy(
        _segments(lk, tk)).to(card)
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    q, do = (torch.randn((tq, h, d), generator=g, device=card).to(dt)
             for _ in range(2))
    k, v = (torch.randn((len(seg_k), kvh, d), generator=g,
                        device=card).to(dt) for _ in range(2))
    o, lse = va.varlen_fwd_reference(q, k, v, seg_q, seg_k, causal,
                                     d ** -0.5)
    delta = (do.float() * o.float()).sum(-1).T.contiguous()
    return q, k, v, do, seg_q, seg_k, lse, delta


def _host_tiles(seg_q, seg_k, diag):
    """64 x 64 tiles a head computes under the kernels' skip rule."""
    def ranges(seg):
        out = []
        for a in range(0, len(seg), 64):
            x = seg[a:a + 64]
            x = x[x >= 0]
            out.append((x.min(), x.max()) if len(x) else None)
        return out
    n = 0
    for qt, a in enumerate(ranges(seg_q)):
        for kt, b in enumerate(ranges(seg_k)):
            if a and b and not (diag and kt > qt):
                n += int(b[0] <= a[1] and b[1] >= a[0])
    return n


@pytest.mark.parametrize("layout", sorted(VARLEN_LAYOUTS))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("h,kvh,d", [(4, 4, 64), (8, 2, 128), (4, 1, 40),
                                     (4, 2, 100)])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_varlen_backward_kernels_match_plain(card, dtype, h, kvh, d, causal,
                                             layout):
    """va_bwd_dq and va_bwd_dkv (dK/dV summed over each KV head's query
    group) against their plain versions, and the tiles each computed
    against the skip rule; dtypes as the operands'. The bf16 wrappers pad
    D = 100 to 104 for the tensor-core loops and slice the gradients
    back."""
    lq, tq, lk, tk = VARLEN_LAYOUTS[layout]
    dt = FLASH_DTYPES[dtype]
    q, k, v, do, seg_q, seg_k, lse, delta = _varlen_bwd_operands(
        card, dt, lq, tq, lk, tk, h, kvh, d, causal, seed=d + h)
    same = lk is None
    sq, sk = va._sentinels(seg_q, seg_k)
    args = (q, k, v, do, lse, delta, sq, sk, causal, d ** -0.5)
    before = _va_counts()
    dq, n_dq = va._launch_bwd_dq(*args, same, count_tiles=True)
    dk, dv, n_dkv = va._launch_bwd_dkv(*args, same, count_tiles=True)
    torch.cuda.synchronize()
    assert _va_counts() == (before[0], before[1] + 1, before[2] + 1)
    want = [va.varlen_bwd_dq_reference(*args),
            *va.varlen_bwd_dkv_reference(*args)]
    atol, rtol = FLASH_TOL[dt]
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert a.dtype == dt and a.shape == r.shape, name
        torch.testing.assert_close(a.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=name)
    tiles = _host_tiles(sq.cpu().numpy(), sk.cpu().numpy(), causal and same)
    assert n_dq == n_dkv == tiles * h
    assert bool((dq[sq < 0] == 0).all())
    assert bool((dk[sk < 0] == 0).all()) and bool((dv[sk < 0] == 0).all())


@pytest.mark.parametrize("extra", [0, 3], ids=["aligned", "odd_rows"])
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
def test_varlen_backward_reads_strided_operands(card, dtype, extra):
    """q, k, v as column slices of one fused projection, and dO as a
    column slice of a wider tensor, give the backward kernels' answer on
    contiguous copies, bit for bit. With `extra` columns first a row
    holds 259 values, which the bf16 loops' 16-byte copies cannot read,
    so their wrappers copy; the aligned bf16 slices are read in place."""
    dt = FLASH_DTYPES[dtype]
    seg = torch.from_numpy(_segments([50, 80], 150)).to(card)
    g = torch.Generator(device=card)
    g.manual_seed(extra)
    x = torch.randn((150, extra + 4 * 32 + 2 * 2 * 32), generator=g,
                    device=card).to(dt)
    y = torch.randn((150, extra + 4 * 32 + 8), generator=g,
                    device=card).to(dt)
    q = x[:, extra:extra + 128].view(150, 4, 32)
    k = x[:, extra + 128:extra + 192].view(150, 2, 32)
    v = x[:, extra + 192:].view(150, 2, 32)
    do = y[:, extra:extra + 128].view(150, 4, 32)
    assert not q.is_contiguous() and not do.is_contiguous()
    copied = tensor_core_operands(q, k, v, do)
    assert all((a is b) == (extra == 0) for a, b in zip((q, k, v, do),
                                                         copied))
    _, lse = va.varlen_fwd_reference(q, k, v, seg, seg, True, 32 ** -0.5)
    delta = torch.randn((4, 150), generator=g, device=card)
    sq, sk = va._sentinels(seg, seg)
    runs = []
    for ops in ((q, k, v, do), tuple(t.contiguous() for t in (q, k, v, do))):
        args = (*ops, lse, delta, sq, sk, True, 32 ** -0.5, True)
        runs.append([va._launch_bwd_dq(*args), *va._launch_bwd_dkv(*args)])
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("t,d,causal", [(2048, 128, True), (300, 100, False)])
def test_varlen_bf16_backward_repeats_bit_for_bit(card, t, d, causal):
    """No atomics and a fixed order of sums (dK/dV of a GQA group summed
    in one block): two launches of the bf16 dQ and dK/dV on the same
    operands give the same bits."""
    lens = [700, 1, 600, 500] if t == 2048 else [70, 1, 130, 64]
    q, k, v, do, seg, _, lse, delta = _varlen_bwd_operands(
        card, torch.bfloat16, lens, t, None, None, 8, 2, d, causal,
        seed=t + d)
    sq, sk = va._sentinels(seg, seg)
    args = (q, k, v, do, lse, delta, sq, sk, causal, d ** -0.5, True)
    runs = [[va._launch_bwd_dq(*args), *va._launch_bwd_dkv(*args)]
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), name


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_varlen_autograd_on_card_matches_cpu(card, rep, causal):
    """fp32 through flash_attn_unpadded and its autograd Function, GQA
    group `rep`, unequal cu_seqlens with trailing pads: the card's
    kernels against the CPU's plain versions; one launch of each kernel
    on the card, none on the CPU."""
    rng = np.random.default_rng(rep)
    q, w = (rng.standard_normal((300, 4, 64)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((330, 4 // rep, 64)).astype(np.float32)
            for _ in range(2))
    cu_q, cu_k = [0, 70, 200, 260], [0, 90, 200, 300]
    out = {}
    for dev in (card, torch.device("cpu")):
        ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in (q, k, v)]
        before = _va_counts()
        o, _ = va.flash_attn_unpadded(*ts, cu_q, cu_k, causal=causal)
        (o * torch.from_numpy(w).to(dev)).sum().backward()
        launched = tuple(a - b for a, b in zip(_va_counts(), before))
        assert launched == ((1, 1, 1) if dev.type == "cuda" else (0, 0, 0))
        out[dev.type] = [o.detach().cpu()] + [t.grad.cpu() for t in ts]
    for name, a, b in zip(("o", "dq", "dk", "dv"), out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4, msg=name)


def test_varlen_backward_kernels_refuse_what_they_do_not_take(card):
    seg = torch.zeros((64,), dtype=torch.int32, device=card)
    q = torch.randn((64, 4, 32), device=card)
    kv = torch.randn((64, 2, 32), device=card)
    lse = torch.zeros((4, 64), device=card)
    ok = (q, kv, kv, q, lse, lse, seg, seg, True, 0.2, True)
    before = _va_counts()
    with pytest.raises(ValueError, match="dO"):
        va._launch_bwd_dq(q, kv, kv, q.bfloat16(), *ok[4:])
    with pytest.raises(ValueError, match="dO"):
        va._launch_bwd_dkv(q, kv, kv, q[:32], *ok[4:])
    with pytest.raises(ValueError, match="lse"):
        va._launch_bwd_dq(*ok[:4], lse.T, *ok[5:])
    with pytest.raises(ValueError, match="delta"):
        va._launch_bwd_dkv(*ok[:5], lse.double(), *ok[6:])
    with pytest.raises(ValueError, match="head_dim must be contiguous"):
        va._launch_bwd_dq(*ok[:3], q.transpose(1, 2).contiguous()
                          .transpose(1, 2), *ok[4:])
    # dK/dV stages the ranges of every q tile: 8,125 of them do not fit
    long_q = torch.zeros((520000, 1, 128), device=card)
    long_kv = torch.zeros((64, 1, 128), device=card)
    long_lse = torch.zeros((1, 520000), device=card)
    with pytest.raises(ValueError, match="va_bwd_dkv: the ranges of 8125 "
                       "query tiles need"):
        va._launch_bwd_dkv(long_q, long_kv, long_kv, long_q, long_lse,
                           long_lse, torch.zeros((520000,), dtype=torch.int32,
                                                 device=card),
                           seg, True, 0.2, False)
    assert _va_counts() == before
    va._launch_bwd_dq(*ok)
    va._launch_bwd_dkv(*ok)
    assert _va_counts() == (before[0], before[1] + 1, before[2] + 1)


@pytest.mark.parametrize("remat,fused_ce", [(True, True), ("dots", False),
                                            ("dots", True)])
def test_fused_ce_and_dots_train_step_on_card_matches_cpu(card, remat,
                                                          fused_ce):
    """fp32, TF32 off: two steps with the fused linear+CE head and/or
    remat="dots" on packed documents, card against CPU, a vocabulary of
    3 chunks of 64 and a short one. Under dots the FlashMask forward
    still runs twice per layer and step (forward and recompute)."""
    cfg = LlamaConfig.tiny(vocab=200, hidden=128, layers=2, heads=4,
                           kv_heads=2, ffn=256)
    lr, steps = 3e-4, 2
    rng = np.random.default_rng(0)
    x = rng.integers(0, 200, (2, 64))
    y = rng.integers(0, 200, (2, 64))
    doc = np.stack([np.repeat(np.arange(3), [20, 30, 14]),
                    np.zeros(64, np.int64)])
    y[0, [19, 49, 63]] = -1
    cpu = init_params(cfg, seed=0, device="cpu")
    res = {}
    for dev in (card, torch.device("cpu")):
        params = T.params_from_jax(
            {k: ({kk: vv.numpy() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.numpy())
             for k, v in cpu.items()}, dev)
        opt = T.init_opt_state(params)
        batch = tuple(torch.from_numpy(a).to(dev) for a in (x, y, doc))
        _, grads = T.loss_and_grads(params, batch, cfg, remat=remat,
                                    fused_ce=fused_ce)
        step = T.make_train_step(cfg, lr=lr, remat=remat, fused_ce=fused_ce,
                                 device=dev)
        fm.launches_fwd = fm.launches_dq = fm.launches_dkv = 0
        losses = [float(step(params, opt, i, batch)[2]) for i in range(steps)]
        res[dev.type] = (losses, T._leaves(grads), T._leaves(params),
                         _fm_counts())
    L = cfg.num_hidden_layers
    assert res["cuda"][3] == (2 * L * steps, L * steps, L * steps)
    assert res["cpu"][3] == (0, 0, 0)
    np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=1e-5)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-4)
    for a, b in zip(res["cuda"][2], res["cpu"][2]):
        torch.testing.assert_close(a.cpu(), b, atol=2.5 * lr * steps, rtol=0)


def test_fused_ce_bf16_on_card_matches_fp32_products(card):
    """bf16 weights on the card: the head's products run on the tensor
    cores with fp32 output, and the loss and gradients agree with the
    same op on fp32 upcasts of the same bf16 values (chunks of 64 over a
    vocabulary of 200)."""
    g = torch.Generator(device=card)
    g.manual_seed(0)
    x = torch.randn((256, 128), generator=g, device=card).bfloat16()
    w = (torch.randn((128, 200), generator=g, device=card) * 0.1).bfloat16()
    lab = torch.randint(0, 200, (256,), generator=g, device=card)
    lab[:7] = -100
    res = []
    for xx, ww in ((x, w), (x.float(), w.float())):
        xx, ww = xx.clone().requires_grad_(), ww.clone().requires_grad_()
        loss = fused_linear_cross_entropy(xx, ww, lab, chunk_size=64)
        res.append([loss] + list(torch.autograd.grad(loss, (xx, ww))))
    torch.testing.assert_close(res[0][0], res[1][0], atol=1e-5, rtol=1e-5)
    # the backward's products take d_logits in bf16: one bf16 rounding
    for a, b in zip(res[0][1:], res[1][1:]):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b, atol=2e-4, rtol=2e-2)


@pytest.mark.parametrize("dtype", list(VARIANTS))
@pytest.mark.parametrize("qh,kvh,d,page", [
    (32, 8, 128, 16), (8, 8, 64, 8), (32, 1, 16, 64), (16, 2, 256, 32),
    (12, 4, 96, 5)])
def test_paged_decode_kernel_matches_plain(card, dtype, qh, kvh, d, page):
    rng = np.random.default_rng(0)
    lens = [0, 1, page, page + 1, 70, 300]
    pps = -(-300 // page)
    num_pages = len(lens) * pps + 1
    ptab = rng.permutation(num_pages - 1)[:len(lens) * pps].reshape(
        len(lens), pps).astype(np.int32)
    g = torch.Generator(device=card)
    g.manual_seed(d)
    pools, qname = VARIANTS[dtype]
    q = torch.randn((len(lens), qh, d), generator=g, device=card).to(
        getattr(torch, qname))
    k = torch.randn((kvh, num_pages, page, d), generator=g, device=card)
    v = torch.randn((kvh, num_pages, page, d), generator=g, device=card)
    ks = vs = None
    if pools == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    else:
        k, v = k.to(q.dtype), v.to(q.dtype)
    ptab = torch.from_numpy(ptab).to(card)
    lengths = torch.tensor(lens, dtype=torch.int32, device=card)
    before = (pa.launches_decode, pa.launches_decode_int8)
    ker = pa.paged_attention(q, k, v, ptab, lengths, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    quant = pools == "int8"
    assert (pa.launches_decode, pa.launches_decode_int8) == \
        (before[0] + (not quant), before[1] + quant)
    ref = pa.paged_decode_reference(q, k, v, ptab, lengths, k_scale=ks,
                                    v_scale=vs)
    atol, rtol = TOL[qname]
    torch.testing.assert_close(ker.float(), ref.float(), atol=atol,
                               rtol=rtol)
    assert bool((ker[0] == 0).all())


def test_paged_decode_kernel_refuses_what_it_does_not_take(card):
    q = torch.randn((2, 4, 32), device=card)
    pages = torch.randn((2, 5, 8, 32), device=card)
    ptab = torch.zeros((2, 3), dtype=torch.int32, device=card)
    lens = torch.tensor([3, 9], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q, pages, pages, ptab, lens.long())
    with pytest.raises(ValueError, match="dtype"):
        pa.paged_attention(q, pages.bfloat16(), pages.bfloat16(), ptab, lens)
    with pytest.raises(ValueError, match="multiple of 16"):
        odd = torch.randn((2, 5, 8, 40), device=card)
        pa.paged_attention(torch.randn((2, 4, 40), device=card), odd, odd,
                           ptab, lens)
    with pytest.raises(ValueError, match="int8 pages need"):
        pa.paged_attention(q, pages.to(torch.int8), pages.to(torch.int8),
                           ptab, lens)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                           pages, pages, ptab, lens)
    with pytest.raises(ValueError, match="shared memory"):
        wide = torch.randn((1, 2, 16, 256), device=card)
        pa.paged_attention(torch.randn((2, 64, 256), device=card), wide,
                           wide, ptab, lens)


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_card_bucketed_engine_matches_cpu_engine(card, cache_dtype):
    """fp32, TF32 off: the bucketed engine (three admissions in one
    packed wave, later ones alone) on the card against the CPU, greedy
    and seeded; the card launches va_fwd per layer and wave, fa_fwd per
    layer and lone prefill, pa_decode per layer and step, nothing
    ragged; the CPU launches nothing."""
    from paddle_tpu_torch.models import llama_serving as S
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
                                ragged=False, device=dev)
            for i, n in enumerate((5, 17, 30, 9)):
                eng.submit(Request(i, list(range(1, n + 1)),
                                   max_new_tokens=6 + 3 * i,
                                   **({"temperature": 0.9, "seed": i}
                                      if i == 1 else {})))
            va.launches_fwd = fa.launches_fwd = rpa.launches = 0
            pa.launches_decode = pa.launches_decode_int8 = 0
            waves = []
            orig = S.prefill_varlen

            def counted(*a, **kw):
                waves.append(1)
                return orig(*a, **kw)
            S.prefill_varlen = counted
            try:
                done = eng.run_pipelined() if pipelined else eng.run()
            finally:
                S.prefill_varlen = orig
            L = cfg.num_hidden_layers
            on_card = dev is card
            decode = pa.launches_decode_int8 if cache_dtype else \
                pa.launches_decode
            assert decode == (L * eng.device_steps if on_card else 0)
            assert va.launches_fwd == (L * len(waves) if on_card else 0)
            assert fa.launches_fwd == (L * (4 - 3 * len(waves))
                                       if on_card else 0)
            assert rpa.launches == 0 and len(waves) == 1
            assert eng.pool.conserved(drained=True)
            outs.append({r.rid: r.output for r in done})
    assert outs[0] == outs[1] == outs[2] == outs[3]


# (QH, KVH, G): the JAX tests' awkward rows (6, 10 and 9 per KV head), and
# 8B widths at the chunked-prefill widths G = 16 (one 64-row tile) and 64
# (four tiles)
VERIFY_SHAPES = [(4, 2, 3), (4, 2, 5), (6, 2, 3), (32, 8, 16), (32, 8, 64)]


def _verify_operands(card, dtype, qh, kvh, g, d, page, seed=0):
    """Slots of base lengths 0, 1, page - 1, 300 and 2000 - G (G tokens
    each on top, within the owned pages), pages in random order."""
    rng = np.random.default_rng(seed)
    bases = [0, 1, page - 1, 300, 2000 - g]
    pps = -(-2000 // page)
    num_pages = len(bases) * pps + 1
    ptab = rng.permutation(num_pages - 1)[:len(bases) * pps].reshape(
        len(bases), pps).astype(np.int32)
    gen = torch.Generator(device=card)
    gen.manual_seed(d + g)
    pools, qname = VARIANTS[dtype]
    q = torch.randn((len(bases), qh, g, d), generator=gen, device=card).to(
        getattr(torch, qname))
    k = torch.randn((kvh, num_pages, page, d), generator=gen, device=card)
    v = torch.randn((kvh, num_pages, page, d), generator=gen, device=card)
    ks = vs = None
    if pools == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    else:
        k, v = k.to(q.dtype), v.to(q.dtype)
    return (q, k, v, ks, vs, torch.from_numpy(ptab).to(card),
            torch.tensor(bases, dtype=torch.int32, device=card))


@pytest.mark.parametrize("dtype", list(VARIANTS))
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("qh,kvh,g", VERIFY_SHAPES)
def test_paged_verify_kernel_matches_plain(card, dtype, qh, kvh, g, d, page):
    q, k, v, ks, vs, ptab, base = _verify_operands(card, dtype, qh, kvh, g,
                                                   d, page)
    before = (pa.launches_verify, pa.launches_verify_int8)
    ker = pa.paged_verify_attention(q, k, v, ptab, base, k_scale=ks,
                                    v_scale=vs)
    torch.cuda.synchronize()
    quant = VARIANTS[dtype][0] == "int8"
    assert (pa.launches_verify, pa.launches_verify_int8) == \
        (before[0] + (not quant), before[1] + quant)
    ref = pa.paged_verify_reference(q, k, v, ptab, base, k_scale=ks,
                                    v_scale=vs)
    atol, rtol = TOL[VARIANTS[dtype][1]]
    torch.testing.assert_close(ker.float(), ref.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", list(VARIANTS))
def test_paged_verify_g1_equals_paged_decode(card, dtype):
    """G = 1 at base is pa_decode at base + 1, both kernels."""
    q, k, v, ks, vs, ptab, base = _verify_operands(card, dtype, 32, 8, 1,
                                                   128, 16)
    ver = pa.paged_verify_attention(q, k, v, ptab, base, k_scale=ks,
                                    v_scale=vs)
    dec = pa.paged_attention(q[:, :, 0].contiguous(), k, v, ptab, base + 1,
                             k_scale=ks, v_scale=vs)
    atol, rtol = TOL[VARIANTS[dtype][1]]
    torch.testing.assert_close(ver[:, :, 0].float(), dec.float(), atol=atol,
                               rtol=rtol)


def test_paged_verify_kernel_refuses_what_it_does_not_take(card):
    q = torch.randn((2, 4, 3, 32), device=card)
    pages = torch.randn((2, 5, 8, 32), device=card)
    ptab = torch.zeros((2, 3), dtype=torch.int32, device=card)
    base = torch.tensor([3, 9], dtype=torch.int32, device=card)
    before = (pa.launches_verify, pa.launches_verify_int8)
    with pytest.raises(ValueError, match="on cpu"):          # no fallback
        pa.paged_verify_attention(q, pages, pages, ptab.cpu(), base)
    with pytest.raises(ValueError, match=r"\(B, QH, G, D\)"):
        pa.paged_verify_attention(q[:, :, 0], pages, pages, ptab, base)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_verify_attention(q, pages, pages, ptab, base.long())
    with pytest.raises(ValueError, match="dtype"):
        pa.paged_verify_attention(q, pages.bfloat16(), pages.bfloat16(),
                                  ptab, base)
    with pytest.raises(ValueError, match="int8 pages need"):
        pa.paged_verify_attention(q, pages.to(torch.int8),
                                  pages.to(torch.int8), ptab, base)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_verify_attention(q.transpose(2, 3).contiguous()
                                  .transpose(2, 3), pages, pages, ptab, base)
    assert (pa.launches_verify, pa.launches_verify_int8) == before


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
@pytest.mark.parametrize("chunked", [False, True], ids=["spec", "chunked"])
def test_card_spec_engine_matches_cpu_engine(card, cache_dtype, chunked):
    """fp32, TF32 off, depth 2: the bucketed spec engine (spec_decode=4,
    greedy and seeded requests on ngram-repetitive prompts, with
    chunked prefill or without) on the card against the CPU; the card
    launches pa_verify per layer and step and no decode kernel, the CPU
    nothing."""
    cfg = LlamaConfig.tiny(vocab=128, hidden=128, layers=2, heads=4,
                           kv_heads=2, ffn=256)
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = {k: ({kk: vv.to(card) for kk, vv in v.items()}
               if isinstance(v, dict) else v.to(card))
           for k, v in cpu.items()}
    outs = []
    for dev, params in ((card, gpu), ("cpu", cpu)):
        eng = ServingEngine(params, cfg, max_seqs=3, max_seq_len=64,
                            page_size=8, cache_dtype=cache_dtype,
                            ragged=False, spec_decode=4,
                            chunked_prefill=chunked, device=dev)
        for i, motif in enumerate(([1, 5, 9], [2, 4], [7, 7, 3], [6, 1])):
            eng.submit(Request(i, motif * (3 + i), max_new_tokens=8 + 3 * i,
                               **({"temperature": 0.9, "seed": i}
                                  if i == 1 else {})))
        va.launches_fwd = fa.launches_fwd = rpa.launches = 0
        pa.launches_decode = pa.launches_decode_int8 = 0
        pa.launches_verify = pa.launches_verify_int8 = 0
        done = eng.run()
        L = cfg.num_hidden_layers
        on_card = dev is card
        verify = pa.launches_verify_int8 if cache_dtype else \
            pa.launches_verify
        assert verify == (L * eng.device_steps if on_card else 0)
        assert pa.launches_decode == pa.launches_decode_int8 == 0
        assert pa.launches_verify + pa.launches_verify_int8 == verify
        assert rpa.launches == 0
        if chunked:
            assert va.launches_fwd == fa.launches_fwd == 0
        assert eng.spec_drafted > 0
        assert eng.pool.conserved(drained=True)
        outs.append({r.rid: r.output for r in done})
    assert outs[0] == outs[1]
