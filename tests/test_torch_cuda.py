"""paddle_tpu_torch on the card: the Hopper ragged paged-attention kernel
(both designs, on engine-shaped waves, and its work plan against the
plain twin), the three flash-attention kernels, the three FlashMask kernels, the
varlen forward, dQ and dK/dV, the paged decode and the paged verify
kernels (both routes; on the tensor cores across several splits a
slot, their counts against the split rule's plain twin) against their
plain PyTorch versions over the shapes and masks they cover, the card
engines (ragged, bucketed, and bucketed with speculative decoding and
chunked prefill; bf16 ones on the paged kernels' tensor cores) against
the CPU engines, and
tiny-width train steps (plain and packed documents, the fused
linear+CE head and remat="dots") on the card against the CPU, and on
two gloo ranks sharing the card (tp 2, pp 2 with 1F1B) against the
single-rank card step, with each collective staged through the host
against the same collective on CPU tensors; and the Paddle-shaped
surface: the Layer-tree Llama's AdamW steps and the nn.functional
attention entry points through Tensors on the card against the CPU; and
the parallel layer surface: the Trainer on one rank on the card against
the CPU, and the tensor-parallel layers and the Trainer on tp 2 (two
gloo ranks sharing the card) against one rank.

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
from paddle_tpu_torch.models.serving_capture import bf16_step
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
def test_kernel_matches_plain(card, record_property, dtype, qh, kvh, d,
                              page):
    q, k, v, ks, vs, ptab, slot, pos = _wave(card, dtype, qh, kvh, d, page)
    route = rpa.route(q.dtype, k.dtype, d, qh // kvh)
    record_property("route", route)
    before = rpa.launches, rpa.plan_launches
    ker = rpa.ragged_paged_attention(q, k, v, ptab, slot, pos,
                                     k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    # one attention launch; a plan launch only on the tensor-core route
    assert (rpa.launches, rpa.plan_launches) == (
        before[0] + 1, before[1] + (route == rpa.TENSOR_CORES))
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


# Engine-shaped waves for the tensor-core kernel, as the ragged engine lays
# out a buffer: decode rows first, then each chunk. (slot, first position,
# tokens) per run: runs of 37 (starting mid-page, crossing a 64-column
# tile) and 200 tokens, a run of 70 whose last tile is partial at every
# group, slot 0 split into two runs that are not adjacent, inactive rows
# between runs and at the end.
ENGINE_RUNS = [(1, 1999, 1), (2, 99, 1), (3, 0, 1), (4, 700, 1),
               (5, 50, 37), None, (6, 0, 200), (0, 300, 10), None, None,
               (7, 64, 70), (0, 310, 20), None]


def _engine_wave(dev, variant, qh, kvh, d, page=16, seed=0):
    """(q, k, v, ks, vs, ptab, slot, pos) for ENGINE_RUNS (None: an
    inactive row), max_seq_len 2048."""
    rng = np.random.default_rng(seed)
    slot, pos = [], []
    for run in ENGINE_RUNS:
        s, p0, n = run if run is not None else (0, -1, 1)
        slot += [s] * n
        pos += [p0 + i if p0 >= 0 else -1 for i in range(n)]
    pps = 2048 // page
    slots = 8
    num_pages = slots * pps + 1
    ptab = rng.permutation(num_pages - 1)[:slots * pps].reshape(
        slots, pps).astype(np.int32)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    pools, qname = VARIANTS[variant]
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

    def t(a):
        return torch.tensor(a, dtype=torch.int32, device=dev)
    return q, k, v, ks, vs, t(ptab), t(slot), t(pos)


# (QH, KVH, D): 8B widths; group 3 (21 tokens a tile, one row unused);
# group 1 (64 tokens a tile); group 64 (one token a tile); D 64 and 40
TC_SHAPES = [(32, 8, 128), (12, 4, 128), (8, 8, 64), (64, 1, 64),
             (16, 4, 40)]


@pytest.mark.parametrize("qh,kvh,d", TC_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_tc_kernel_on_engine_waves(card, dtype, qh, kvh, d):
    """bf16 q over bf16 and int8 pages: the tensor-core route, held to
    the plain version at TOL on every active row, inactive rows exactly
    zero, and the k tiles it computed equal to the plan's."""
    q, k, v, ks, vs, ptab, slot, pos = _engine_wave(card, dtype, qh, kvh, d)
    assert rpa.route(q.dtype, k.dtype, d, qh // kvh) == rpa.TENSOR_CORES
    ker, tiles = rpa._launch(q, k, v, ptab, slot, pos, d ** -0.5, ks, vs,
                             count_tiles=True)
    ref = rpa.ragged_paged_attention_reference(q, k, v, ptab, slot, pos,
                                               k_scale=ks, v_scale=vs)
    active = pos >= 0
    atol, rtol = TOL["bfloat16"]
    torch.testing.assert_close(ker.float()[active], ref.float()[active],
                               atol=atol, rtol=rtol)
    assert bool((ker[~active] == 0).all())
    plan = rpa.ragged_tile_plan(slot.cpu(), pos.cpu(), qh // kvh,
                                cap=ptab.shape[1] * k.shape[2])
    assert tiles == kvh * int(plan[:, 2].sum())


def _decode_plan(plan, t):
    """(tiles (n_tiles, 4) int64, inactive rows (n_inactive,) int64) of a
    device plan of t rows (`rpa.plan_size`: the header (n_tiles,
    n_inactive), t tiles of 4 ints, t inactive rows)."""
    p = plan.cpu().long()
    n, z = int(p[0]), int(p[1])
    return p[2:2 + 4 * n].reshape(n, 4), p[2 + 4 * t:2 + 4 * t + z]


@pytest.mark.parametrize("group", [1, 3, 4, 64])
def test_tc_plan_equals_its_plain_twin(card, group):
    """The plan kernel's tiles and inactive rows equal
    `ragged_tile_plan`'s and the inactive rows of the buffer, on the
    engine wave and on a long random buffer (more rows than one pass of
    the plan block)."""
    _, _, _, _, _, ptab, slot, pos = _engine_wave(card, "bfloat16", 8, 8, 16)
    rng = np.random.default_rng(group)
    n = 3000
    rslot = rng.integers(0, 4, n).repeat(2)[:n]
    rpos = np.where(rng.random(n) < 0.2, -1, rng.integers(0, 2048, n))
    cap = ptab.shape[1] * 16
    for s, p in ((slot, pos), (torch.tensor(rslot, dtype=torch.int32,
                                            device=card),
                               torch.tensor(rpos, dtype=torch.int32,
                                            device=card))):
        tiles, idle = _decode_plan(rpa.ragged_plan(s, p, group, cap),
                                   len(p))
        assert torch.equal(tiles, rpa.ragged_tile_plan(s.cpu(), p.cpu(),
                                                       group, cap))
        assert torch.equal(idle, (p.cpu() < 0).nonzero().flatten())


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_tc_kernel_with_and_without_the_step_plan(card, dtype):
    """A call given the step's plan and one that builds its own give the
    same bits; two calls repeat bit for bit (no atomics in the sums)."""
    q, k, v, ks, vs, ptab, slot, pos = _engine_wave(card, dtype, 32, 8, 128)
    plan = rpa.step_plan(q, k, ptab, slot, pos)
    assert plan is not None
    outs = [rpa.ragged_paged_attention(q, k, v, ptab, slot, pos, k_scale=ks,
                                       v_scale=vs, plan=p)
            for p in (plan, None, plan)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_tc_route_rule(card):
    """bf16 at head_dim 256, fp32 q and a GQA group over 64 take the
    CUDA-core route by rule: no plan, no tile count, the plain version's
    answer."""
    for qh, kvh, d, dtype in ((16, 2, 256, "bfloat16"), (8, 2, 64, "float32"),
                              (8, 2, 64, "int8_fp32q"), (128, 1, 32,
                                                         "bfloat16")):
        q, k, v, ks, vs, ptab, slot, pos = _wave(card, dtype, qh, kvh, d, 16)
        assert rpa.route(q.dtype, k.dtype, d, qh // kvh) == rpa.CUDA_CORES
        assert rpa.step_plan(q, k, ptab, slot, pos) is None
        before = rpa.plan_launches
        ker, tiles = rpa._launch(q, k, v, ptab, slot, pos, d ** -0.5, ks,
                                 vs, count_tiles=True)
        assert tiles is None and rpa.plan_launches == before
        ref = rpa.ragged_paged_attention_reference(q, k, v, ptab, slot, pos,
                                                   k_scale=ks, v_scale=vs)
        atol, rtol = TOL[VARIANTS[dtype][1]]
        active = pos >= 0
        torch.testing.assert_close(ker.float()[active], ref.float()[active],
                                   atol=atol, rtol=rtol)


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_card_tc_engine_matches_cpu_engine(card, cache_dtype):
    """bf16 weights at group 4 (the tensor-core route) on the card against
    the CPU engine from the same weights: the same tokens, one plan per
    device step, one attention launch per layer and step."""
    cfg = LlamaConfig.tiny(vocab=128, hidden=256, layers=2, heads=8,
                           kv_heads=2, ffn=256)
    cpu = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    gpu = {k: ({kk: vv.to(card) for kk, vv in v.items()}
               if isinstance(v, dict) else v.to(card))
           for k, v in cpu.items()}
    outs = []
    for dev, params in ((card, gpu), ("cpu", cpu)):
        eng = ServingEngine(params, cfg, max_seqs=3, max_seq_len=128,
                            page_size=8, cache_dtype=cache_dtype, device=dev)
        for i, n in enumerate((5, 40, 70)):
            eng.submit(Request(i, list(range(1, n + 1)), max_new_tokens=12))
        rpa.launches = rpa.plan_launches = 0
        done = eng.run()
        on_card = dev is card
        assert rpa.launches == (cfg.num_hidden_layers * eng.device_steps
                                if on_card else 0)
        assert rpa.plan_launches == (eng.device_steps if on_card else 0)
        assert eng.pool.conserved(drained=True)
        outs.append({r.rid: r.output for r in done})
    assert outs[0] == outs[1]


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
# storage offset; the wide heads (D = 136 and 200 padded by the wrapper
# only to 136 and 200, running at 192 and 256, and 192 and 256 themselves,
# with a GQA repeat); and one query row against a longer key axis without
# causal ("decode": S_q = 1, S_k = s), GPT-2's cached step
FLASH_CASES = (
    [(s, d, c, rep, "contiguous") for s in (64, 200, 1024) for d in (64, 128)
     for c in (False, True) for rep in (1, 4)]
    + [(s, d, c, 1, "contiguous") for s in (1, 63, 65, 2048)
       for d in (32, 64, 72, 100, 128) for c in (False, True)]
    + [(s, d, False, 1, "sk_longer") for s in (63, 200)
       for d in (72, 100, 128)]
    + [(2048, d, False, 1, "sk_longer") for d in (72, 128)]
    + [(s, d, c, 1, "offset") for s in (65, 200) for d in (64, 100, 128)
       for c in (False, True)]
    + [(s, d, c, 1, "contiguous") for s in (1, 65, 200)
       for d in (136, 192, 200, 256) for c in (False, True)]
    + [(200, d, True, 4, "contiguous") for d in (192, 256)]
    + [(200, 256, False, 1, "offset"), (63, 192, False, 1, "sk_longer")]
    + [(s, d, False, 1, "decode") for s in (64, 1500)
       for d in (64, 128, 192, 256)])


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
    sq = 1 if layout == "decode" else s

    def rnd(heads, rows=s):
        return torch.randn((b, heads, rows, d), generator=g,
                           device=card).to(dt)
    q, do = rnd(h, sq), rnd(h, sq)
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
    with pytest.raises(ValueError, match="head_dim 264 .*Queue 3"):
        big = torch.zeros((1, 2, 64, 264), device=card)
        fa._launch_fwd(big, big, big, True, 1.0)
    with pytest.raises(ValueError, match="head_dim 264"):
        fa._launch_fwd(big.bfloat16(), big.bfloat16(), big.bfloat16(), True,
                       1.0)
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
# the last padded by the wrapper), operands at an unaligned offset, S_k
# longer than S_q, and the wide heads (192 and 256; 200 padded to 200 and
# run at 256)
FM_CASES = ([(s, d, "contiguous") for s in (64, 200, 1024) for d in (64, 128)]
            + [(s, d, "contiguous") for s in (63, 65, 2048)
               for d in (32, 72, 100, 128)]
            + [(s, d, "offset") for s, d in ((65, 64), (200, 100))]
            + [(s, d, "sk_longer") for s, d in ((63, 64), (200, 100))]
            + [(s, d, "contiguous") for s in (65, 200) for d in (192, 256)]
            + [(200, 200, "sk_longer")])


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
    with pytest.raises(ValueError, match="head_dim 264 .*Queue 3"):
        big = torch.zeros((1, 2, 64, 264), device=card)
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
# a bf16 D = 100 to 104); the wide heads (192, 256 and 200, run at 256)
VARLEN_FWD_CASES = (
    [(lay, h, kvh, d) for lay in sorted(VARLEN_LAYOUTS)
     for h, kvh, d in ((4, 4, 64), (8, 2, 128), (4, 1, 40))]
    + [(lay, 4, 2, d) for lay in ("t1", "t63", "t65", "t2048", "unequal_t65")
       for d in (32, 40, 72, 100, 128)]
    + [(lay, 4, 2, d) for lay in ("t65", "unequal", "unequal_t65")
       for d in (192, 200, 256)])


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
    with pytest.raises(ValueError, match="head_dim 264 .*Queue 3"):
        big = torch.randn((64, 2, 264), device=card)
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
                                     (4, 2, 100), (4, 2, 192), (4, 1, 256)])
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
def test_paged_decode_kernel_matches_plain(card, record_property, dtype, qh,
                                           kvh, d, page):
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
    record_property("route", pa.route(q.dtype, k.dtype, d, qh // kvh))
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
def test_paged_verify_kernel_matches_plain(card, record_property, dtype, qh,
                                           kvh, g, d, page):
    q, k, v, ks, vs, ptab, base = _verify_operands(card, dtype, qh, kvh, g,
                                                   d, page)
    record_property("route", pa.route(q.dtype, k.dtype, d, qh // kvh))
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


# ------------------------------------- the paged kernels' tensor-core route
def _paged_operands(card, dtype, lens, qh, kvh, d, page, g=None, cap=2048,
                    seed=0):
    """Slots of `lens` columns (decode lengths, or verify base lengths
    with g tokens on top), room for `cap` a slot, pages in random order;
    q (B, QH, D) for decode, (B, QH, G, D) for verify."""
    rng = np.random.default_rng(seed)
    pps = -(-cap // page)
    num_pages = len(lens) * pps + 1
    ptab = rng.permutation(num_pages - 1)[:len(lens) * pps].reshape(
        len(lens), pps).astype(np.int32)
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    pools, qname = VARIANTS[dtype]
    shape = (len(lens), qh, d) if g is None else (len(lens), qh, g, d)
    q = torch.randn(shape, generator=gen, device=card).to(
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
            torch.tensor(lens, dtype=torch.int32, device=card))


def _paged_call(q, k, v, ks, vs, ptab, lens, count_tiles=False):
    """The wrapper's launch of decode ((B, QH, D) q) or verify."""
    fn = pa._launch if q.dim() == 3 else pa._launch_verify
    return fn(q, k, v, ptab, lens, q.shape[-1] ** -0.5, ks, vs,
              count_tiles=count_tiles)


def _paged_plain(q, k, v, ks, vs, ptab, lens):
    fn = pa.paged_decode_reference if q.dim() == 3 else \
        pa.paged_verify_reference
    return fn(q, k, v, ptab, lens, k_scale=ks, v_scale=vs)


# (lengths or bases, G, QH, KVH, D, page): slots the rule cuts into 3 and
# more splits of S = pa.SPLIT_COLS columns, lengths at split boundaries
# +- 1, verify chunks that straddle one, groups 1, 3, 4 and 64, D 32, 64,
# 96 and 128, pages of 5, 8 and 16
_S = pa.SPLIT_COLS
PAGED_SPLIT_CASES = {
    "decode_bounds": ([_S - 1, _S, _S + 1, 2 * _S - 1, 2 * _S + 1,
                       3 * _S - 1, 3 * _S, 3 * _S + 1, 0, 2048],
                      None, 32, 8, 128, 16),
    "decode_g1_d64": ([3 * _S + 7, 1500, 3, 0], None, 8, 8, 64, 8),
    "decode_g3_d96": ([3 * _S + 1, 300, 0], None, 12, 4, 96, 5),
    "decode_g64_d32": ([1200, _S + 1], None, 64, 1, 32, 16),
    "verify_straddle": ([_S - 3, _S - 2, _S - 1, _S, 2 * _S - 2,
                         3 * _S - 1, 1800], 4, 32, 8, 128, 16),
    "verify_g20_two_tiles": ([_S - 10, 3 * _S - 10], 20, 32, 8, 64, 8),
    "verify_g3": ([3 * _S - 3, 60], 7, 12, 4, 96, 5)}


@pytest.mark.parametrize("case", sorted(PAGED_SPLIT_CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_paged_tc_kernel_across_splits(card, dtype, case):
    """bf16 q over bf16 and int8 pages on slots cut into several splits:
    the plain version at TOL, a length-0 slot exactly 0, one attention
    launch and one merge, and the k tiles and working blocks the kernel
    counted equal to `paged_split_plan`'s."""
    lens, g, qh, kvh, d, page = PAGED_SPLIT_CASES[case]
    q, k, v, ks, vs, ptab, lengths = _paged_operands(card, dtype, lens, qh,
                                                     kvh, d, page, g)
    assert pa.route(q.dtype, k.dtype, d, qh // kvh) == pa.TENSOR_CORES
    before = pa.launches_merge
    ker, counts = _paged_call(q, k, v, ks, vs, ptab, lengths,
                              count_tiles=True)
    ref = _paged_plain(q, k, v, ks, vs, ptab, lengths)
    atol, rtol = TOL["bfloat16"]
    torch.testing.assert_close(ker.float(), ref.float(), atol=atol,
                               rtol=rtol)
    assert bool((ker[lengths == 0] == 0).all())
    assert pa.launches_merge == before + 1
    first = lens if g is None else [n + 1 for n in lens]
    plan = pa.paged_split_plan(first, qh // kvh, g or 1, kvh, pa.SPLIT_COLS,
                               pa._sm_count(q.device),
                               ptab.shape[1] * page, d)
    assert plan["max_splits"] > 2
    assert max(len(parts) for row in plan["tiles"] for _, parts in row) >= 3
    assert (counts["k_tiles"], counts["splits"]) == \
        (kvh * plan["k_tiles"], kvh * plan["splits"])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("verify", [False, True], ids=["decode", "verify"])
def test_paged_tc_kernel_repeats_bit_for_bit(card, dtype, verify):
    """The merge takes the splits in order and nothing sums by atomics:
    two calls give the same bits."""
    q, k, v, ks, vs, ptab, lengths = _paged_operands(
        card, dtype, [2000, 700, 100, 1300], 32, 8, 128, 16,
        4 if verify else None)
    outs = [_paged_call(q, k, v, ks, vs, ptab, lengths) for _ in range(3)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("verify", [False, True], ids=["decode", "verify"])
def test_paged_tc_kernel_reads_no_stale_workspace(card, verify):
    """Two calls of the same shapes and other lengths (a slot whose
    split count falls, one that empties) each give the plain version's
    answer: no partial of the first call is merged into the second."""
    q, k, v, ks, vs, ptab, lengths = _paged_operands(
        card, "bfloat16", [1900, 900, 40, 1200], 32, 8, 128, 16,
        4 if verify else None)
    atol, rtol = TOL["bfloat16"]
    for lens in ([1900, 900, 40, 1200], [300, 0 if not verify else 10, 1999
                                         if not verify else 1990, 64]):
        lengths = torch.tensor(lens, dtype=torch.int32, device=card)
        ker = _paged_call(q, k, v, ks, vs, ptab, lengths)
        torch.testing.assert_close(
            ker.float(), _paged_plain(q, k, v, ks, vs, ptab, lengths).float(),
            atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("verify", [False, True], ids=["decode", "verify"])
def test_paged_tc_workspace_is_bounded_at_long_caps(card, dtype, verify):
    """Long slots: decode rows in slots of 131072 columns (S = SPLIT_COLS
    would take 342 splits) and G = 64 chunks (four row tiles) in slots of
    32768. The rule widens the split so that the partials stay within
    MAX_SPLIT_WORKSPACE, the wrapper allocates the output and that
    workspace, rows x splits x (D + 2) fp32, and nothing more (the
    allocator's peak), and the answer is the plain version's, with the k
    tiles and working blocks of `paged_split_plan`."""
    if verify:
        cap, g, qh, kvh = 32768, 64, 8, 2
        lens = [30000, 12000, 700, 5]
    else:
        cap, g, qh, kvh = 131072, None, 32, 8
        lens = [131000, 70000, 384, 0]
    d = 128
    q, k, v, ks, vs, ptab, lengths = _paged_operands(
        card, dtype, lens, qh, kvh, d, 16, g, cap=cap)
    _paged_call(q, k, v, ks, vs, ptab, lengths)             # warm-up
    torch.cuda.synchronize(card)
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    ker, counts = _paged_call(q, k, v, ks, vs, ptab, lengths,
                              count_tiles=True)
    peak = torch.cuda.max_memory_allocated(card) - base
    n_tok = g or 1
    assert counts["split_cols"] > pa.SPLIT_COLS and counts["max_splits"] > 1
    assert counts["workspace_bytes"] == \
        len(lens) * qh * n_tok * counts["max_splits"] * (d + 2) * 4
    assert counts["workspace_bytes"] <= pa.MAX_SPLIT_WORKSPACE
    assert peak <= ker.numel() * 2 + counts["workspace_bytes"] + 2 ** 20
    first = lens if g is None else [n + 1 for n in lens]
    plan = pa.paged_split_plan(first, qh // kvh, n_tok, kvh, pa.SPLIT_COLS,
                               pa._sm_count(q.device), cap, d)
    assert plan["split_cols"] == counts["split_cols"]
    assert (counts["k_tiles"], counts["splits"]) == \
        (kvh * plan["k_tiles"], kvh * plan["splits"])
    atol, rtol = TOL["bfloat16"]
    torch.testing.assert_close(
        ker.float(), _paged_plain(q, k, v, ks, vs, ptab, lengths).float(),
        atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype,qh,kvh,d", [
    ("bfloat16", 16, 2, 256), ("float32", 32, 8, 128),
    ("int8_fp32q", 32, 8, 128), ("float32", 8, 8, 64)])
@pytest.mark.parametrize("verify", [False, True], ids=["decode", "verify"])
def test_paged_cuda_core_route_by_rule(card, dtype, qh, kvh, d, verify):
    """bf16 at head_dim 256 and every fp32 q take the CUDA-core kernels
    by rule: no tile count, no merge, the plain version's answer."""
    q, k, v, ks, vs, ptab, lengths = _paged_operands(
        card, dtype, [1500, 300, 0 if not verify else 7], qh, kvh, d, 32,
        4 if verify else None)
    assert pa.route(q.dtype, k.dtype, d, qh // kvh) == pa.CUDA_CORES
    before = pa.launches_merge
    ker, counts = _paged_call(q, k, v, ks, vs, ptab, lengths,
                              count_tiles=True)
    assert counts is None and pa.launches_merge == before
    atol, rtol = TOL[VARIANTS[dtype][1]]
    torch.testing.assert_close(
        ker.float(), _paged_plain(q, k, v, ks, vs, ptab, lengths).float(),
        atol=atol, rtol=rtol)


# prompts over S = pa.SPLIT_COLS tokens in slots of 1024: the split rule
# cuts the long slots (B x KVH = 6 blocks a split, far under 2 x SMs)
PAGED_ENGINE_PROMPTS = (5, _S + 20, _S + 100)
# The model's logits are bf16 and the CPU engine's top-2 margins include
# exact ties. Two tokens whose logits are equal in bf16 have logprobs
# that differ only by the two engines' log-softmax normalizers, which
# the other logits' small differences move far less than one bf16 step;
# a token one bf16 step apart differs by 2^-10 or more at |logit| >=
# 1/8.
BF16_LOGIT_TIE = 2 ** -11


def _teacher_forced(card_out, cpu_out, prompts, rerun):
    """Hold each card stream to the CPU's ({rid: (tokens, logprobs)})
    by teacher forcing: where the card picks another token, the two
    tokens' logprobs must tie (within BF16_LOGIT_TIE), and the card
    restarts from the CPU's token, `rerun(rid, prompt, n)` giving its
    next n (tokens, logprobs) after the prompt and the CPU's tokens so
    far, until the stream ends. Returns the number of restarts."""
    restarts = 0
    for rid, (tok_cpu, lp_cpu) in cpu_out.items():
        tok, lp = card_out[rid]
        start = 0
        while start < len(tok_cpu):
            assert len(tok) == len(tok_cpu) - start
            j = next((i for i, (a, b) in enumerate(zip(tok, tok_cpu[start:]))
                      if a != b), None)
            if j is None:
                break
            assert abs(lp[j] - lp_cpu[start + j]) <= BF16_LOGIT_TIE, \
                (rid, start + j, lp[j], lp_cpu[start + j])
            start += j + 1
            if start < len(tok_cpu):
                restarts += 1
                tok, lp = rerun(rid, prompts[rid] + tok_cpu[:start],
                                len(tok_cpu) - start)
    return restarts


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
@pytest.mark.parametrize("engine", ["bucketed", "spec", "chunked"])
def test_card_paged_tc_engines_match_cpu_engine(card, engine, cache_dtype):
    """bf16 weights at group 4 (the paged kernels' tensor-core route) on
    the bucketed engine, and on its speculative one with and without
    chunked prefill, with prompts over one split in slots of 1024, so
    that the split rule cuts slots: one decode or verify launch per layer
    and step and one merge with each, and the CPU engine's tokens from
    the same weights. bf16 pools give the same tokens. With int8 pools a
    one-ulp difference of an attention output can move a K or V value to
    another int8 code and a logit by one bf16 step, so the card is held
    to every token of each CPU stream by teacher forcing: where it picks
    another token, the two tokens' logprobs must tie (within
    BF16_LOGIT_TIE), and the card restarts from the CPU's token (the
    prompt and the CPU's tokens so far as its prompt) until the stream
    ends."""
    cfg = LlamaConfig.tiny(vocab=128, hidden=256, layers=2, heads=8,
                           kv_heads=2, ffn=256)
    cpu = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    gpu = {k: ({kk: vv.to(card) for kk, vv in v.items()}
               if isinstance(v, dict) else v.to(card))
           for k, v in cpu.items()}
    spec = engine != "bucketed"
    kw = {"spec_decode": 4, "chunked_prefill": engine == "chunked"} \
        if spec else {}

    def make(dev, params):
        return ServingEngine(params, cfg, max_seqs=3, max_seq_len=1024,
                             page_size=8, cache_dtype=cache_dtype,
                             ragged=False, device=dev, **kw)
    prompts = {}
    for i, n in enumerate(PAGED_ENGINE_PROMPTS):
        motif = [1 + i, 5, 9 + i]
        prompts[i] = (motif * n)[:n] if spec else \
            [1 + (7 * j + i) % 120 for j in range(n)]
    outs = []
    for dev, params in ((card, gpu), ("cpu", cpu)):
        eng = make(dev, params)
        for i, prompt in prompts.items():
            eng.submit(Request(i, prompt, max_new_tokens=12, logprobs=True))
        va.launches_fwd = fa.launches_fwd = rpa.launches = 0
        pa.launches_decode = pa.launches_decode_int8 = 0
        pa.launches_verify = pa.launches_verify_int8 = 0
        pa.launches_merge = 0
        done = eng.run()
        on_card = dev is card
        L = cfg.num_hidden_layers
        paged = {"decode": pa.launches_decode + pa.launches_decode_int8,
                 "verify": pa.launches_verify + pa.launches_verify_int8}
        kind = "verify" if spec else "decode"
        int8 = pa.launches_verify_int8 + pa.launches_decode_int8
        assert paged[kind] == (L * eng.device_steps if on_card else 0)
        assert paged["decode" if spec else "verify"] == 0
        assert int8 == (paged[kind] if cache_dtype else 0)
        assert pa.launches_merge == paged[kind]
        assert rpa.launches == 0
        if spec:
            assert eng.spec_drafted > 0
        assert eng.pool.conserved(drained=True)
        outs.append({r.rid: (r.output, r.logprobs) for r in done})
    if cache_dtype is None:
        assert {r: o[0] for r, o in outs[0].items()} == \
            {r: o[0] for r, o in outs[1].items()}
        return

    def rerun(rid, prompt, n):
        eng = make(card, gpu)
        eng.submit(Request(rid, prompt, max_new_tokens=n, logprobs=True))
        (r,) = eng.run()
        return r.output, r.logprobs
    restarts = _teacher_forced(outs[0], outs[1], prompts, rerun)
    print(f"paged tc engines {engine} {cache_dtype}: {restarts} tie "
          "restarts")


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


# ------------------------------------------- prefix cache, tier, handoff
@pytest.mark.parametrize("quantize", [False, True], ids=["verbatim", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_spill_snapshot_survives_the_page_being_handed_out(card, dtype,
                                                           quantize):
    """A spilled page's snapshot is taken on the engine's stream before
    the hook returns: the stream is held busy, the page is spilled, and
    the page is overwritten (as the allocator's next owner would) while
    the copy thread still waits for the snapshot; the tier must land the
    page as it was."""
    from paddle_tpu_torch.serving import kvcache as kvc
    cfg = LlamaConfig.tiny(vocab=64, hidden=64, layers=2, heads=4,
                           kv_heads=2, ffn=64)
    params = init_params(cfg, seed=0, device=card)
    eng = ServingEngine(params, cfg, max_seqs=2, max_seq_len=64, page_size=8,
                        prefix_cache=True, host_tier_bytes=1 << 20,
                        tier_quantize=quantize,
                        cache_dtype="int8" if dtype == "int8" else None,
                        dtype=getattr(torch, dtype) if dtype != "int8"
                        else None, device=card)
    page = 3
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    before = {}
    for name in ("k_pool", "v_pool", "k_scale", "v_scale"):
        t = getattr(eng, name)
        if t is None:
            continue
        if t.dtype == torch.int8:
            t[:, :, page] = torch.randint(-127, 128, t[:, :, page].shape,
                                          generator=gen, device=card,
                                          dtype=torch.int8)
        else:
            t[:, :, page] = torch.rand(t[:, :, page].shape, generator=gen,
                                       device=card).to(t.dtype) + 0.5
        before[name] = t[:, :, page].cpu().clone()
    torch.cuda._sleep(200_000_000)          # the stream stays busy
    block = tuple(range(8))
    eng._spill_page(page, kvc._SEED, block, 1)
    for name in before:                     # the page's next owner writes
        getattr(eng, name)[:, :, page] = 0
    assert eng.host_tier.flush(timeout=60)
    (p,) = eng.host_tier.match(list(block) + [9], 0)
    if dtype == "int8":
        want = {"k": before["k_pool"], "v": before["v_pool"],
                "ks": before["k_scale"], "vs": before["v_scale"]}
    elif quantize:
        # quantized on the card, as the card's int8 pool quantizes (bit
        # for bit the host quantizer's:
        # test_quantize_kv_on_card_is_bit_equal_to_cpu)
        (kq, ks), (vq, vs) = (quantize_kv(before[n].to(card))
                              for n in ("k_pool", "v_pool"))
        want = {"k": kq.cpu(), "v": vq.cpu(), "ks": ks.cpu(), "vs": vs.cpu()}
    else:
        want = {"k": before["k_pool"], "v": before["v_pool"], "ks": None,
                "vs": None}
    for name, w in want.items():
        assert (p[name] is None) == (w is None), name
        if w is not None:
            assert p[name].device.type == "cpu"
            assert torch.equal(p[name], w), name
    assert eng.host_tier.stats()["copy_errors"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n,g", [(300, 512), (1500, 2048)])
def test_paged_verify_suffix_prefill_shape_matches_plain(card, dtype, n, g):
    """The bucketed suffix prefill's verify call: one slot active over a
    cached 1024-token prefix with a chunk of G = 512 or 2048 rows, the
    other slots inactive at live and free lengths (their rows computed
    too, past the slot's cap at the cap); every row against the plain
    version, the active rows apart."""
    bases = [1024, 0, 100, 400, 0, 1000, 1500, 0]
    q, k, v, ks, vs, ptab, base = _paged_operands(
        card, dtype, bases, 8, 2, 128, 16, g=g, cap=1024 + 2048, seed=g)
    got = _paged_call(q, k, v, ks, vs, ptab, base)
    want = torch.cat([_paged_plain(q[i:i + 1], k, v, ks, vs, ptab[i:i + 1],
                                   base[i:i + 1]) for i in range(len(bases))])
    atol, rtol = TOL[VARIANTS[dtype][1]]
    torch.testing.assert_close(got[0, :, :n].float(), want[0, :, :n].float(),
                               atol=atol, rtol=rtol)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


PREFIX_HEADER = [1 + (5 * j) % 120 for j in range(32)]     # 4 pages of 8


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
@pytest.mark.parametrize("engine", ["ragged", "bucketed", "chunked"])
def test_card_prefix_engines_match_cpu_engine(card, engine, cache_dtype):
    """bf16 weights at group 4 (the tensor-core routes) with the prefix
    cache and the host tier (verbatim pages): shared-header prompts, then
    a first turn evicted by a burst and restored from the tier; the card
    engine against the CPU engine from the same weights, with the same
    cached tokens and prefill tokens. Tokens are held by the teacher
    forcing of test_card_paged_tc_engines_match_cpu_engine, bf16 pools
    too: this model's bf16 logits tie exactly on some of these prompts
    (a burst prompt's first token, one run). A restart runs on the same
    card engine, its cache and tier warm, so the rest of the stream goes
    through the prefix path too (a cached prefix each time); the number
    of restarts is printed. The bucketed engine launches one pa_verify
    per layer and suffix prefill."""
    cfg = LlamaConfig.tiny(vocab=128, hidden=256, layers=2, heads=8,
                           kv_heads=2, ffn=256)
    L = cfg.num_hidden_layers
    cpu = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    gpu = {k: ({kk: vv.to(card) for kk, vv in v.items()}
               if isinstance(v, dict) else v.to(card))
           for k, v in cpu.items()}
    kw = {"ragged": engine == "ragged"}
    if engine == "chunked":
        kw.update(spec_decode=4, chunked_prefill=True)

    def make(dev, params):
        return ServingEngine(params, cfg, max_seqs=2, max_seq_len=128,
                             page_size=8, num_pages=20, prefix_cache=True,
                             host_tier_bytes=1 << 24, tier_quantize=False,
                             cache_dtype=cache_dtype, device=dev, **kw)
    prompts = {"s0": PREFIX_HEADER + [7, 8, 9],
               "s1": PREFIX_HEADER + [10] * 11,
               "s2": PREFIX_HEADER + [3, 2],
               "t1": [2 + (3 * j) % 100 for j in range(41)]}
    prompts.update({f"b{i}": [120 - i] + [1 + (11 * j + i) % 110
                                           for j in range(47)]
                    for i in range(4)})
    outs, ledgers, engines = [], [], []
    for dev, params in ((card, gpu), ("cpu", cpu)):
        eng = make(dev, params)
        engines.append(eng)
        suffix = []
        fn = eng._prefill_suffix_into

        def counted(*a, _fn=fn, **k):
            before = pa.launches_verify + pa.launches_verify_int8
            _fn(*a, **k)
            suffix.append(pa.launches_verify + pa.launches_verify_int8
                          - before)
        eng._prefill_suffix_into = counted
        steps = []
        for group in (["s0"], ["s1", "s2"], ["t1"], ["b0"], ["b1"], ["b2"],
                      ["b3"], ["t2"]):
            for rid in group:
                if rid == "t2":
                    t1 = next(r for r in eng.finished if r.rid == "t1")
                    prompts["t2"] = prompts["t1"] + t1.output + [4, 5]
                eng.submit(Request(rid, prompts[rid], max_new_tokens=8,
                                   logprobs=True))
            eng.run()
            eng.host_tier.flush(timeout=60)
            steps.append(eng.prefill_tokens)
        if dev is card and engine == "bucketed":
            assert suffix and all(n == L for n in suffix)
        assert eng.pool.conserved(drained=True)
        st = eng.host_tier.stats()
        assert st["hits"] >= 1 and st["copy_errors"] == 0
        outs.append({r.rid: (r.output, r.logprobs) for r in eng.finished})
        ledgers.append((steps, {r.rid: r.cached_tokens
                                for r in eng.finished}))
    # cached and prefill tokens follow lengths, not token values
    assert ledgers[0] == ledgers[1]
    assert ledgers[0][1]["s1"] == ledgers[0][1]["s2"] == 32
    assert ledgers[0][1]["t2"] == 48
    warm = engines[0]

    def rerun(rid, prompt, n):
        r = Request(rid, prompt, max_new_tokens=n, logprobs=True)
        warm.submit(r)
        warm.run()
        assert r.done and r.cached_tokens > 0
        return r.output, r.logprobs
    restarts = _teacher_forced(outs[0], outs[1], prompts, rerun)
    assert warm.pool.conserved(drained=True)
    print(f"prefix engines {engine} {cache_dtype}: {restarts} tie "
          "restarts")


def test_quantize_kv_on_card_is_bit_equal_to_cpu(card):
    """The int8 pool's per-token scales: absmax / 127 on the card is the
    CPU's (and the reference's) true division, not a multiply by 1/127.
    The inputs are chosen where the two differ in fp32."""
    rng = np.random.default_rng(0)
    amax = rng.uniform(1e-3, 1e3, 20000).astype(np.float32)
    true_div = amax / np.float32(127.0)
    by_recip = amax * (np.float32(1.0) / np.float32(127.0))
    amax = amax[true_div != by_recip][:512]
    assert len(amax) >= 256, "too few fp32 values where the roundings part"
    x = rng.uniform(-1.0, 1.0, (len(amax), 16)).astype(np.float32)
    x *= amax[:, None] / np.abs(x).max(axis=1, keepdims=True)
    x = torch.from_numpy(x)
    q_cpu, s_cpu = quantize_kv(x)
    q_card, s_card = quantize_kv(x.to(card))
    assert torch.equal(s_card.cpu().view(torch.int32),
                       s_cpu.view(torch.int32))
    assert torch.equal(q_card.cpu(), q_cpu)
    assert torch.equal(s_cpu[:, 0],
                       torch.from_numpy(np.abs(x.numpy()).max(axis=1)
                                        / np.float32(127.0)))


# ------------------------------------------------------------ parallel
# Two gloo ranks sharing the one card (their collectives staged through
# the host), spawned once for the module with a deadline; what they run
# is tests/_torch_ranks.py (neither jax nor paddle_tpu).
PAR_DIMS = dict(vocab=128, hidden=128, layers=4, heads=4, kv_heads=2,
                ffn=256)
PAR_LAYOUTS = {"tp2": ({"tp": 2}, {"batch_spec": ()}),
               "pp2_1f1b": ({"pp": 2}, {"batch_spec": (),
                                        "schedule": "1f1b"})}
PAR_LR = 3e-4


def _par_spawn(fn, data):
    import _torch_ranks as R
    from paddle_tpu_torch.distributed.launch import spawn
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks compute on the card")
    return spawn(getattr(R, fn), 2, "gloo", "cuda", 300, args=(data,))


# the tp serving test: the paged tc engine test's model (group 4 on each
# rank: 4 query heads over 1 KV head) and prompts over one split
TP_DIMS = dict(vocab=128, hidden=256, layers=2, heads=8, kv_heads=2, ffn=256)


@pytest.fixture(scope="module")
def card_tp_ranks():
    prompts = {i: [1 + (7 * j + i) % 120 for j in range(n)]
               for i, n in enumerate(PAGED_ENGINE_PROMPTS)}
    return _par_spawn("card_tp_serve", {
        "dims": TP_DIMS, "prompts": prompts, "new_tokens": 12,
        "engine": dict(max_seqs=3, max_seq_len=1024, page_size=8,
                       ragged=False)})


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_tp_engine_on_two_ranks_sharing_the_card_matches_one_rank(
        card_tp_ranks, pool):
    """Bucketed tp 2 serving on two gloo ranks sharing the card (each
    rank its shard of the weights, given on the CPU, and of the pool; the
    paged decode kernel on its tensor-core route at 4 query heads over 1
    KV head) against the single-rank card engine from the same bf16
    weights, greedy: each rank launches pa_decode once a layer and step,
    its pool holds its KV head and is conserved, the ranks give the same
    tokens, and the tp engine, run again teacher-forced along each
    single-rank stream (`serving_capture.StepLogits`), emits it and is
    held to it at every token. Where the forced tp engine's own pick is
    another token, the two tokens tie: each engine's pick leads the
    other's token by at most one bf16 step of the top logit in that
    engine's own logits (each tp rank rounds its partial products of
    `wo` and `w_down` to bf16 before the sum over the ranks, where one
    rank rounds the whole product once: every logit, and the log-softmax
    normalizer with them, moves by up to a bf16 step, so the logprob
    rule of BF16_LOGIT_TIE, which compares two engines' normalizers,
    does not apply)."""
    L = TP_DIMS["layers"]
    for r, res in enumerate(card_tp_ranks):
        got = res[pool]
        n = got["launches"]
        assert n["decode" if pool == "bf16" else "int8"] == L * n["steps"]
        assert n["int8" if pool == "bf16" else "decode"] == 0
        assert n["heads"] == TP_DIMS["kv_heads"] // 2 and n["conserved"]
        assert got["forced_ok"]
        for rid, tok, lead_tp, lead_one, top in got["parts"]:
            step = bf16_step(top)
            assert 0 <= lead_tp <= step and 0 <= lead_one <= step, (
                r, rid, tok, lead_tp, lead_one, top)
        print(f"tp engine {pool} rank {r}: {len(got['parts'])} forced "
              "rows tie")
    assert card_tp_ranks[0][pool] == card_tp_ranks[1][pool]


@pytest.fixture(scope="module")
def card_collective_ranks():
    rng = np.random.default_rng(2)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    n = 2
    data = {"x": f(n * 2 * n, 3), "w": f(n * 2 * n, 3), "x0": f(2 * n, 3),
            "w0": f(2 * n, 3), "x3": f(n * 2, 2 * n, 3),
            "w3": f(n * 2 * n, 2, 3)}
    return _par_spawn("card_collectives", data)


@pytest.fixture(scope="module")
def card_train_ranks():
    rng = np.random.default_rng(0)
    x = rng.integers(0, PAR_DIMS["vocab"], (2, 64))
    y = rng.integers(0, PAR_DIMS["vocab"], (2, 64))
    y[1, :10] = -1
    return _par_spawn("card_train", {"dims": PAR_DIMS, "batch": (x, y),
                                     "layouts": PAR_LAYOUTS, "lr": PAR_LR})


STAGED = ("all_reduce_sum", "all_reduce_max", "all_reduce_avg", "all_gather",
          "all_gather_list", "all_gather_cat", "reduce_scatter",
          "reduce_scatter_list", "broadcast", "alltoall_single",
          "alltoall_list", "ppermute_ring", "ppermute_one", "recv",
          "copy_to_group_grad", "reduce_from_group", "reduce_from_group_grad",
          "all_to_all", "all_to_all_grad", "ppermute", "ppermute_grad")


@pytest.mark.parametrize("name", STAGED)
def test_staged_gloo_collective_on_card_equals_cpu(card_collective_ranks,
                                                   name):
    """Each collective on CUDA tensors of two gloo ranks sharing the
    card (staged through pinned host buffers) gives the bits the same
    collective gives on CPU tensors, and its results stay on the card."""
    for r, res in enumerate(card_collective_ranks):
        on_card = res["cuda:0"]
        np.testing.assert_array_equal(on_card[name], res["cpu"][name],
                                      err_msg=f"rank {r}")
        assert on_card["devices"] == ["cuda:0"], on_card["devices"]
        assert on_card["backend"] == "gloo"
        assert on_card["counters"] == res["cpu"]["counters"] | {
            "seconds": on_card["counters"]["seconds"]}


@pytest.mark.parametrize("layout", list(PAR_LAYOUTS))
def test_parallel_step_on_two_ranks_sharing_the_card_matches_one_rank(
        card_train_ranks, layout):
    """fp32, TF32 off, remat on: two steps of tp 2 or pp 2 (1F1B) on two
    ranks sharing the card against the single-rank card step from the
    same weights: losses, step-1 gradients and parameters (gathered from
    the shards). Each rank launches the flash kernels for its own layers
    and heads: every layer (tp) or half of them for each of 2
    microbatches (pp), forward twice."""
    L, steps = PAR_DIMS["layers"], 2
    for r, res in enumerate(card_train_ranks):
        one, got = res["single"], res[layout]
        assert got["device"] == "cuda:0"
        assert got["launches"] == (2 * L * steps, L * steps, L * steps)
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
        for tree, tol in (("grads", dict(atol=1e-5, rtol=1e-4)),
                          ("params", dict(atol=2.5 * PAR_LR * steps,
                                          rtol=0))):
            for k in one[tree]:
                a, b = one[tree][k], got[tree][k]
                for kk in (a if isinstance(a, dict) else {None: a}):
                    np.testing.assert_allclose(
                        b[kk] if kk else b, a[kk] if kk else a,
                        err_msg=f"rank {r} {tree} {k} {kk}", **tol)


# ------------------------------------------------ the Paddle-shaped surface
@pytest.fixture
def paddle_on(card):
    """The Paddle-shaped surface, its device state restored after."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch._core import state
    prev = state._device
    yield paddle
    state._device = prev
    torch.backends.cuda.matmul.allow_tf32 = False


def _layer_llama_run(paddle, device, sd, ids, labels, steps=3):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    paddle.set_device(device)
    model = LlamaForCausalLM(LlamaConfig.tiny())
    model.set_state_dict(sd)
    opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
    losses = []
    for _ in range(steps):
        loss, _ = model(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, {k: v.numpy() for k, v in model.state_dict().items()}


def test_layer_llama_adamw_on_card_matches_cpu(paddle_on):
    """tests/test_models_llm.py's 3 AdamW steps of the Layer-tree Llama on
    the card (the flash kernels, fp32, TF32 off) against the same steps
    on the CPU (their plain versions): losses within 1e-5 relative,
    parameters within 2.5 lr a step elementwise (AdamW's first steps on
    near-zero gradients) and 1e-5 in relative norm; the flash kernels
    launch once a layer a step each."""
    paddle = paddle_on
    torch.backends.cuda.matmul.allow_tf32 = False
    paddle.set_device("gpu")
    paddle.seed(0)
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    sd = {k: v.numpy() for k, v in
          LlamaForCausalLM(LlamaConfig.tiny()).state_dict().items()}
    rs = np.random.RandomState(0)
    ids, labels = rs.randint(0, 256, (2, 16)), rs.randint(0, 256, (2, 16))
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    gpu = _layer_llama_run(paddle, "gpu:0", sd, ids, labels)
    after = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    assert [a - b for a, b in zip(after, before)] == [6, 6, 6]
    cpu = _layer_llama_run(paddle, "cpu", sd, ids, labels)
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == after
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-5)
    assert gpu[0][-1] < gpu[0][0]
    for k, ref in cpu[1].items():
        got = gpu[1][k]
        assert np.abs(got - ref).max() <= 2.5 * 1e-3 * 3, k
        assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref), k


@pytest.mark.parametrize("family", ["qwen2", "gpt2", "moe", "deepseek"])
def test_family_forward_on_card_matches_cpu(paddle_on, family):
    """A decoder family's tiny config (DeepSeek's MLA at head dim 24:
    16 + 8) from the same weights on the card and on the CPU, fp32, TF32
    off: loss and logits within 1e-5 relative plus 1e-5, the backward's
    gradients within 1e-4, and the flash kernels once a layer each way;
    then GPT-2's and Qwen2's greedy tokens identical."""
    from paddle_tpu_torch import models as M
    from paddle_tpu_torch.models import generation as G
    paddle = paddle_on
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, cls = {"qwen2": (M.Qwen2Config.tiny(), M.Qwen2ForCausalLM),
                "gpt2": (M.GPT2Config.tiny(), M.GPT2LMHeadModel),
                "moe": (M.MoEConfig.tiny_moe(), M.MoEForCausalLM),
                "deepseek": (M.DeepSeekConfig.tiny_mla(),
                             M.DeepSeekForCausalLM)}[family]
    paddle.set_device("gpu")
    paddle.seed(0)
    sd = {k: v.numpy() for k, v in cls(cfg).state_dict().items()}
    rs = np.random.RandomState(1)
    ids = rs.randint(0, cfg.vocab_size, (2, 24))
    out = {}
    for dev in ("gpu:0", "cpu"):
        paddle.set_device(dev)
        model = cls(cfg)
        model.set_state_dict(sd)
        before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
        loss, logits = model(paddle.to_tensor(ids),
                             labels=paddle.to_tensor(ids))
        loss.backward()
        grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
        launched = [a - b for a, b in zip(
            (fa.launches_fwd, fa.launches_dq, fa.launches_dkv), before)]
        gen = None
        if family in ("qwen2", "gpt2"):
            generate = getattr(model, "generate", None) or \
                (lambda *a, **k: G.generate(model, *a, **k))
            gen = generate(paddle.to_tensor(ids[:, :8]), max_new_tokens=6,
                           temperature=0.0).numpy()
        out[dev] = (float(loss), logits.numpy(), grads, launched, gen)
    n = cfg.num_hidden_layers
    assert out["gpu:0"][3] == [n, n, n] and out["cpu"][3] == [0, 0, 0]
    np.testing.assert_allclose(out["gpu:0"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out["gpu:0"][1], out["cpu"][1], rtol=1e-5,
                               atol=1e-5)
    for k, ref in out["cpu"][2].items():
        np.testing.assert_allclose(out["gpu:0"][2][k], ref, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    if out["cpu"][4] is not None:
        np.testing.assert_array_equal(out["gpu:0"][4], out["cpu"][4])


def _surface_attention(paddle, device, case, arrays, ints):
    paddle.set_device(device)
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    F = paddle.nn.functional
    extra = [paddle.to_tensor(i) for i in ints]
    out = {
        "sdpa": lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True),
        "flash_attention": lambda q, k, v: F.flash_attention(
            q, k, v, causal=True)[0],
        "flash_attn_unpadded": lambda q, k, v, cu: F.flash_attn_unpadded(
            q, k, v, cu, cu, 64, 64, causal=True)[0],
        "flash_attn_varlen_qkvpacked": lambda qkv, cu:
            F.flash_attn_varlen_qkvpacked(qkv, cu, cu, 64, 64,
                                          causal=True)[0],
        "flashmask_attention": lambda q, k, v, sri: F.flashmask_attention(
            q, k, v, sri, causal=True),
    }[case](*ts, *extra)
    w = paddle.to_tensor(np.random.RandomState(9).randn(
        *out.shape).astype(arrays[0].dtype))
    (out * w).sum().backward()
    return [out.numpy()] + [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case", ["sdpa", "flash_attention",
                                  "flash_attn_unpadded",
                                  "flash_attn_varlen_qkvpacked",
                                  "flashmask_attention"])
def test_surface_attention_on_card_matches_plain(paddle_on, case):
    """The five nn.functional.attention entry points through Tensors on
    the card (the flash, varlen and FlashMask kernels) against the same
    calls on CPU Tensors (their plain versions), forward and grads, fp32
    to 1e-4."""
    paddle = paddle_on
    rs = np.random.RandomState(1)
    b, s, h, kvh, d = 2, 64, 4, 2, 32
    qkv = [(rs.randn(b, s, n, d) * 0.5).astype(np.float32)
           for n in (h, kvh, kvh)]
    cu = np.array([0, 20, 64, 100, 128], np.int32)
    sri = np.minimum(s, np.arange(s)[None, None, :, None] + 8 +
                     np.zeros((b, kvh, 1, 1), np.int64)).astype(np.int32)
    arrays, ints = {
        "sdpa": (qkv, ()), "flash_attention": (qkv, ()),
        "flash_attn_unpadded": ([a.reshape(b * s, -1, d) for a in qkv],
                                (cu,)),
        "flash_attn_varlen_qkvpacked": (
            [(rs.randn(b * s, h // kvh + 2, kvh, d) * 0.5).astype(
                np.float32)], (cu,)),
        "flashmask_attention": (qkv, (sri,)),
    }[case]
    got = _surface_attention(paddle, "gpu:0", case, arrays, ints)
    ref = _surface_attention(paddle, "cpu", case, arrays, ints)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)


# ------------------------------------------- the parallel layer surface
def _trainer_run(paddle, device, sd, batch, steps=3):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.parallel import Trainer
    paddle.set_device(device)
    model = LlamaForCausalLM(LlamaConfig.tiny())
    model.set_state_dict(sd)
    opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
    tr = Trainer(model, opt, lambda m, b: m(b[0], labels=b[1])[0],
                 grad_clip_norm=1.0)
    losses = [float(tr.step(batch)) for _ in range(steps)]
    assert all(t.device.type == ("cuda" if device != "cpu" else "cpu")
               for t in tr.params.values())
    return losses, {k: v.numpy() for k, v in model.state_dict().items()}


def test_trainer_on_one_rank_on_card_matches_cpu(paddle_on):
    """3 Trainer steps (AdamW, clip 1.0) of the tiny Layer-tree Llama on
    the card (the flash kernels, fp32, TF32 off) against the same steps
    on the CPU: losses within 1e-5 relative, parameters within 2.5 lr a
    step and 1e-5 in relative norm; the parameters stay on the card and
    the flash kernels launch once a layer a step each."""
    paddle = paddle_on
    torch.backends.cuda.matmul.allow_tf32 = False
    paddle.set_device("gpu")
    paddle.seed(0)
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    sd = {k: v.numpy() for k, v in
          LlamaForCausalLM(LlamaConfig.tiny()).state_dict().items()}
    rs = np.random.RandomState(0)
    batch = (rs.randint(0, 256, (2, 16)), rs.randint(0, 256, (2, 16)))
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    gpu = _trainer_run(paddle, "gpu:0", sd, batch)
    after = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    assert [a - b for a, b in zip(after, before)] == [6, 6, 6]
    cpu = _trainer_run(paddle, "cpu", sd, batch)
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-5)
    for k, ref in cpu[1].items():
        got = gpu[1][k]
        assert np.abs(got - ref).max() <= 2.5 * 1e-3 * 3, k
        assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref), k


LP_LAYERS = {
    "column": ("ColumnParallelLinear", (64, 128), {}),
    "column_split": ("ColumnParallelLinear", (64, 128),
                     {"gather_output": False}),
    "row": ("RowParallelLinear", (128, 64), {}),
    "vocab_embedding": ("VocabParallelEmbedding", (256, 64), {}),
    "parallel_ce": ("ParallelCrossEntropy", (), {}),
}


@pytest.fixture(scope="module")
def card_layer_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks compute on the card")
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import parallel as PAR
    from paddle_tpu_torch._core import state
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    prev = state._device
    paddle.set_device("cpu")
    paddle.seed(0)
    rng = np.random.default_rng(4)
    tp = {}
    for name, (kind, args, kw) in LP_LAYERS.items():
        layer = getattr(PAR, kind)(*args, **kw)
        sd = {k: v.numpy() for k, v in layer.state_dict().items()}
        if kind == "VocabParallelEmbedding":
            x, w = rng.integers(0, 256, (2, 8)), rng.standard_normal(
                (2, 8, 64))
        elif kind == "ParallelCrossEntropy":
            x, w = rng.standard_normal((2, 8, 256)), rng.standard_normal(
                (2, 8))
        else:
            x, w = rng.standard_normal((2, 8, args[0])), \
                rng.standard_normal((2, 8, args[1]))
        case = {"kind": kind, "args": args, "kw": kw, "sd": sd,
                "x": x.astype(np.float32) if x.dtype.kind == "f" else x,
                "w": w.astype(np.float32),
                "split_out": kw.get("gather_output") is False}
        if kind == "ParallelCrossEntropy":
            case["label"] = rng.integers(0, 256, (2, 8))
        tp[name] = case
    sd = {k: v.numpy() for k, v in
          LlamaForCausalLM(LlamaConfig.tiny()).state_dict().items()}
    state._device = prev
    rs = np.random.RandomState(1)
    batch = (rs.randint(0, 256, (2, 32)), rs.randint(0, 256, (2, 32)))
    return _par_spawn("card_layer_parallel", {
        "tp": tp, "dims": {}, "sd": sd, "batch": batch, "steps": 2,
        "lr": 1e-3}), tp


@pytest.mark.parametrize("name", list(LP_LAYERS))
def test_tp_layer_on_two_ranks_sharing_the_card_matches_one_rank(
        card_layer_ranks, name):
    """Each tp layer split over two gloo ranks on the card (fp32, TF32
    off): its whole output and the gathered gradients of sum(out * w)
    (the input's too) against the same layer whole on one rank of the
    card, within 1e-5."""
    ranks, cases = card_layer_ranks
    import _torch_ranks as R
    from paddle_tpu_torch.parallel.mesh import RankMesh
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch._core import state
    import paddle_tpu_torch.distributed.env as env
    prev, prev_mesh = state._device, env.get_global_mesh()
    paddle.set_device("gpu")
    try:
        want = R._tp_layer_case(dict(cases[name]),
                                RankMesh(np.zeros((1,), int), ("tp",), 0))
    finally:
        state._device = prev
        env.set_global_mesh(prev_mesh)
    for r, res in enumerate(ranks):
        got = res[name]
        np.testing.assert_allclose(got["out"], want["out"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {r}")
        for k, v in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], v, rtol=1e-5,
                                       atol=1e-5, err_msg=f"rank {r} {k}")
        if "x_grad" in want:
            np.testing.assert_allclose(got["x_grad"], want["x_grad"],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} x_grad")


def test_trainer_tp2_on_two_ranks_sharing_the_card_matches_one_rank(
        card_layer_ranks):
    """The tiny Layer-tree Llama's Trainer (AdamW, clip 1.0) on tp 2 over
    two gloo ranks sharing the card against the single-rank Trainer on
    the card from the same weights: losses within 1e-5 relative,
    parameters within 2.5 lr a step; each rank runs the flash kernels
    on its own heads once a layer a step."""
    ranks, _ = card_layer_ranks
    L, steps = LlamaConfig.tiny().num_hidden_layers, 2
    for r, res in enumerate(ranks):
        one, got = res["single"], res["tp"]
        assert got["device"].startswith("cuda")
        assert got["launches"] == one["launches"] == (L * steps,) * 3
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
        for k, v in one["params"].items():
            assert np.abs(got["params"][k] - v).max() <= 2.5e-3 * steps, k
