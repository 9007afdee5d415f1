"""paddle_tpu_torch's ragged paged attention held to the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version; it is
compared with the JAX reference (and once with the Pallas kernel in
interpret mode) on the mixed wave of tests/test_ragged_step.py: a
prefill run, decodes, inactive rows, GQA, fp32 and int8 pools. The
Hopper kernel itself runs only on the card: tests/test_torch_cuda.py
holds it to the plain version there. The tensor-core kernel's work
plan (`ragged_tile_plan`, the plain twin of the card's plan kernel) is
held to its rule on engine-shaped and random buffers, and its int8
scale folding, emulated here, to the JAX reference: on ragged rows, and
split and merged as the paged decode and verify kernels do it, on their
shapes."""
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
from paddle_tpu_torch.ops.paged_attention import quantize_kv
from paddle_tpu.kernels import ragged_paged_attention as jax_rpa
from paddle_tpu.kernels import ragged_paged_attention_reference as jax_ref

# fp32 on both sides; the sums run in another order (XLA's scan with
# optimization barriers vs torch's einsum)
ATOL = RTOL = 1e-5


def _problem(seed=0, quant=False, qh=4, kvh=2, d=16, page=8, pps=4,
             num_pages=12, slots=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((10, qh, d)).astype(np.float32)
    shape = (kvh, num_pages, page, d)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.01, 0.1, shape[:3] + (1,)).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, shape[:3] + (1,)).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    ptab = rng.permutation(num_pages)[:slots * pps].reshape(
        slots, pps).astype(np.int32)
    # a 5-token prefill run on slot 0, two decodes, three inactive rows
    tok_slot = np.array([0, 0, 0, 0, 0, 1, 2, 0, 0, 0], np.int32)
    tok_pos = np.array([0, 1, 2, 3, 4, 15, 9, -1, -1, -1], np.int32)
    return q, k, v, ptab, tok_slot, tok_pos, ks, vs


def _jax(args, fn=jax_rpa, **kw):
    q, k, v, ptab, slot, pos, ks, vs = args
    if ks is not None:
        kw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(ptab), jnp.asarray(slot),
                         jnp.asarray(pos), **kw))


def _torch(args, fn=rpa.ragged_paged_attention):
    q, k, v, ptab, slot, pos, ks, vs = args

    def t(a):
        return None if a is None else torch.from_numpy(a)
    out = fn(t(q), t(k), t(v), t(ptab), t(slot), t(pos),
             k_scale=t(ks), v_scale=t(vs))
    assert out.dtype == torch.float32 and out.shape == q.shape
    return out.numpy()


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("qh,kvh", [(4, 2), (8, 2), (4, 4)],
                         ids=["gqa2", "gqa4", "mha"])
def test_plain_matches_jax_reference(quant, qh, kvh):
    args = _problem(quant=quant, qh=qh, kvh=kvh)
    want = _jax(args, fn=jax_ref)
    got = _torch(args, fn=rpa.ragged_paged_attention_reference)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # inactive slack rows are exactly zero, active rows are not
    assert np.array_equal(got[7:], np.zeros_like(got[7:]))
    assert np.abs(got[:7]).min(axis=(1, 2)).max() > 0


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_cpu_dispatch_matches_pallas_interpret(quant):
    """The wrapper on a CPU tensor against the Pallas kernel itself,
    run in interpret mode."""
    args = _problem(seed=1, quant=quant)
    want = _jax(args, use_pallas=True, interpret=True)
    np.testing.assert_allclose(_torch(args), want, atol=ATOL, rtol=RTOL)


def test_cpu_tensor_does_not_move_the_launch_counter():
    before = rpa.launches
    _torch(_problem())
    assert rpa.launches == before


def test_causality_prefill_rows_ignore_future():
    """Row at position p sees exactly columns <= p: clobbering column 4
    of slot 0 changes the row at position 4 and no earlier row."""
    q, k, v, ptab, slot, pos, ks, vs = _problem()
    base = _torch((q, k, v, ptab, slot, pos, ks, vs))
    k2, v2 = k.copy(), v.copy()
    pg = int(ptab[0, 0])
    k2[:, pg, 4] = 99.0
    v2[:, pg, 4] = -99.0
    out = _torch((q, k2, v2, ptab, slot, pos, ks, vs))
    assert np.array_equal(base[:4], out[:4])
    assert not np.array_equal(base[4], out[4])


def test_bf16_plain_matches_fp32_within_bf16():
    """bf16 q and pages: computed in fp32, returned in bf16."""
    q, k, v, ptab, slot, pos, _, _ = _problem(seed=2)
    t = torch.from_numpy
    out = rpa.ragged_paged_attention(
        t(q).bfloat16(), t(k).bfloat16(), t(v).bfloat16(), t(ptab), t(slot),
        t(pos))
    assert out.dtype == torch.bfloat16
    want = _jax((q, k, v, ptab, slot, pos, None, None), use_pallas=False)
    # bf16 inputs and output: about two bf16 ulps at these magnitudes
    np.testing.assert_allclose(out.float().numpy(), want, atol=3e-2,
                               rtol=1.6e-2)


def test_unsupported_device_raises():
    q = torch.empty((2, 4, 16), device="meta")
    k = torch.empty((2, 3, 8, 16), device="meta")
    idx = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no implementation for device"):
        rpa.ragged_paged_attention(q, k, k, torch.zeros(
            (1, 3), dtype=torch.int32, device="meta"), idx, idx)


def test_scales_must_come_together():
    q, k, v, ptab, slot, pos, ks, _ = _problem(quant=True)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="together"):
        rpa.ragged_paged_attention(t(q), t(k), t(v), t(ptab), t(slot),
                                   t(pos), k_scale=t(ks))


# ------------------------------------------- the tensor-core kernel's plan
ROOT = Path(__file__).resolve().parent.parent


def _script(rel):
    """A script of the repo (chip_smoke.py, a tool) as a module; their
    top levels import only the standard library."""
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(runs):
    """tok_slot, tok_pos (int32 tensors) of a buffer laid out as `runs`:
    (slot, first position, tokens) each, None for an inactive row."""
    slot, pos = [], []
    for run in runs:
        s, p0, n = run if run is not None else (0, -1, 1)
        slot += [s] * n
        pos += [p0 + i if p0 >= 0 else -1 for i in range(n)]
    return (torch.tensor(slot, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32))


def _random_runs(seed):
    """Runs of 1-150 tokens of 5 slots (a slot may recur, so it splits),
    starting anywhere in the cache, with inactive rows between some."""
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(int(rng.integers(5, 15))):
        runs.append((int(rng.integers(0, 5)), int(rng.integers(0, 1900)),
                     int(rng.integers(1, 151))))
        runs += [None] * int(rng.integers(0, 3))
    return runs


# As the ragged engine lays out a buffer (decode rows first, then each
# chunk), and the awkward layouts: a run starting mid-page and crossing
# 64-column tiles, a slot split into two runs that are not adjacent,
# inactive rows between runs.
PLAN_LAYOUTS = {
    "engine": [(3, 40, 1), (1, 1999, 1), (4, 7, 1), (0, 100, 100),
               (2, 0, 37), None, None],
    "split_slot": [(0, 300, 10), None, (1, 0, 20), (0, 310, 20),
                   (2, 13, 70), None],
    "adjacent_slots": [(0, 5, 3), (1, 5, 3), (0, 8, 3), (5, 60, 130)],
    **{f"random{i}": _random_runs(i) for i in range(4)}}


def _tiles(layout, group, cap=None):
    slot, pos = _rows(PLAN_LAYOUTS[layout])
    return slot, pos, rpa.ragged_tile_plan(slot, pos, group, cap)


@pytest.mark.parametrize("layout", sorted(PLAN_LAYOUTS))
@pytest.mark.parametrize("group", [1, 3, 4, 64])
def test_tile_plan_covers_each_active_row_once(layout, group):
    """The tiles hold every active row exactly once and no inactive one:
    each KV head's blocks answer every row of the buffer once."""
    slot, pos, tiles = _tiles(layout, group)
    seen = torch.zeros(len(pos), dtype=torch.int64)
    for row0, n, _, _ in tiles.tolist():
        seen[row0:row0 + n] += 1
    assert torch.equal(seen, (pos >= 0).long())


@pytest.mark.parametrize("layout", sorted(PLAN_LAYOUTS))
@pytest.mark.parametrize("group", [1, 3, 4, 64])
def test_tile_plan_stays_inside_one_run(layout, group):
    """No tile crosses a slot change or an inactive row, none holds more
    than 64 // group tokens (its rows x heads fill one 64-row tile), and
    tiles start at a run's first row and every 64 // group rows after."""
    slot, pos, tiles = _tiles(layout, group)
    per_tile = 64 // group
    s, p = slot.tolist(), pos.tolist()
    for row0, n, _, _ in tiles.tolist():
        assert 1 <= n <= per_tile
        rows = range(row0, row0 + n)
        assert all(p[r] >= 0 and s[r] == s[row0] for r in rows)
        start = row0
        while start > 0 and p[start - 1] >= 0 and s[start - 1] == s[row0]:
            start -= 1
        assert (row0 - start) % per_tile == 0
        # a tile ends at its run's end or at 64 // group rows
        end = row0 + n
        assert n == per_tile or end == len(p) or p[end] < 0 or \
            s[end] != s[row0]


@pytest.mark.parametrize("cap", [None, 512])
@pytest.mark.parametrize("layout", sorted(PLAN_LAYOUTS))
@pytest.mark.parametrize("group", [1, 3, 4, 64])
def test_tile_plan_kt_end(layout, group, cap):
    """lim is the largest min(pos + 1, cap) of a tile's rows and kt_end
    the 64-column k tiles that covers: what each row's own limit needs
    and no more."""
    _, pos, tiles = _tiles(layout, group, cap)
    for row0, n, kt_end, lim in tiles.tolist():
        want = max(min(pos[r].item() + 1, cap or 1 << 30)
                   for r in range(row0, row0 + n))
        assert lim == want
        assert kt_end == -(-want // 64)


def test_tile_plan_of_the_chip_smoke_wave():
    """chip_smoke.py's mixed wave at group 4: 16 tiles of the 256-row
    prefill chunk (168 k tiles) and one a decode row (116): 284 k tiles a
    KV head, the count the card's kernel phase holds the kernel to."""
    _, slot, pos = _script("chip_smoke.py")._mixed_wave_rows()
    tiles = rpa.ragged_tile_plan(torch.from_numpy(slot),
                                 torch.from_numpy(pos), 4, 2048)
    assert len(tiles) == 23
    assert int(tiles[:16, 2].sum()) == 168
    assert int(tiles[16:, 2].sum()) == 116
    assert int(tiles[:, 2].sum()) == 284


def test_tile_plan_of_the_chip_smoke_prefix_wave():
    """chip_smoke.py's prefix-hit wave (prefix_kernel (b)) at group 4:
    the 256-row run at positions 1024-1279 over its cached prefix is 16
    tiles (296 k tiles: its rows see 1025-1280 columns), the 3 decode
    rows one tile each (50): 346 k tiles a KV head."""
    lens, slot, pos = _script("chip_smoke.py")._prefix_wave_rows()
    assert (lens[0], int(pos[0]), int(pos[255])) == (1280, 1024, 1279)
    tiles = rpa.ragged_tile_plan(torch.from_numpy(slot),
                                 torch.from_numpy(pos), 4, 2048)
    assert len(tiles) == 19
    assert int(tiles[:16, 2].sum()) == 296
    assert int(tiles[16:, 2].sum()) == 50


@pytest.mark.parametrize("q_dtype,kv_dtype,d,group,want", [
    (torch.bfloat16, torch.bfloat16, 128, 4, rpa.TENSOR_CORES),
    (torch.bfloat16, torch.int8, 128, 4, rpa.TENSOR_CORES),
    (torch.bfloat16, torch.bfloat16, 16, 64, rpa.TENSOR_CORES),
    (torch.bfloat16, torch.bfloat16, 96, 3, rpa.TENSOR_CORES),
    (torch.bfloat16, torch.bfloat16, 256, 4, rpa.CUDA_CORES),
    (torch.bfloat16, torch.bfloat16, 100, 4, rpa.CUDA_CORES),
    (torch.bfloat16, torch.bfloat16, 64, 128, rpa.CUDA_CORES),
    (torch.float32, torch.float32, 128, 4, rpa.CUDA_CORES),
    (torch.float32, torch.int8, 128, 4, rpa.CUDA_CORES)])
def test_route_rule(q_dtype, kv_dtype, d, group, want):
    """bf16 q over bf16 or int8 pages with D % 8 == 0, D <= 128 and a
    group up to 64 takes the tensor cores; fp32 q and every other shape
    the CUDA cores."""
    assert rpa.route(q_dtype, kv_dtype, d, group) == want


def test_cpu_tensors_build_no_plan():
    """The plan is the card's: a CPU call takes the plain version, and
    `step_plan` (what unified_step builds once a step) gives None."""
    q, k, v, ptab, slot, pos, _, _ = _problem()
    t = torch.from_numpy
    before = rpa.plan_launches
    assert rpa.step_plan(t(q).bfloat16(), t(k).bfloat16(), t(ptab),
                         t(slot), t(pos)) is None
    assert rpa.plan_launches == before


LOG2E = 1.4426950408889634


def _folded_int8(q, k8, v8, ks, vs, ptab, slot, pos, scale,
                 split_cols=None):
    """The tensor-core kernel's int8 arithmetic in fp32: per 64-column k
    tile, S = (q . k_int) x k_scale x scale in the log2 domain, an online
    softmax, l summing the unscaled P, and P x v_scale multiplying the
    int8 values of V. With `split_cols` (the paged kernels' split), each
    split of that many columns keeps its own state, and the states are
    merged in order: O = sum 2^(m_s - M) O_s / sum 2^(m_s - M) l_s."""
    t, qh, d = q.shape
    kvh, _, page, _ = k8.shape
    group = qh // kvh
    out = torch.zeros((t, qh, d))
    for i in range(t):
        n = int(pos[i]) + 1
        if n <= 0:
            continue
        cols = torch.arange(n)
        pages, off = ptab[int(slot[i])][cols // page].long(), cols % page
        width = split_cols or n
        for h in range(kvh):
            kk, vv = k8[h, pages, off].float(), v8[h, pages, off].float()
            ksc, vsc = ks[h, pages, off, 0], vs[h, pages, off, 0]
            qq = q[i, h * group:(h + 1) * group].float()
            states = []
            for s0 in range(0, n, width):
                m = torch.full((group,), -float("inf"))
                l = torch.zeros(group)
                acc = torch.zeros(group, d)
                for c0 in range(s0, min(s0 + width, n), 64):
                    c = slice(c0, min(c0 + 64, s0 + width))
                    s = (qq @ kk[c].T) * ksc[c] * (scale * LOG2E)
                    mx = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp2(m - mx)
                    p = torch.exp2(s - mx[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + (p * vsc[c]) @ vv[c]
                    m = mx
                states.append((m, l, acc))
            top = torch.stack([m for m, _, _ in states]).amax(0)
            num, den = torch.zeros(group, d), torch.zeros(group)
            for m, l, acc in states:
                f = torch.exp2(m - top)
                num, den = num + f[:, None] * acc, den + f * l
            out[i, h * group:(h + 1) * group] = num / den[:, None]
    return out


def test_int8_scale_folding_matches_jax_reference():
    """Folding the int8 scales as the tensor-core kernel does (K's after
    Q K^T, V's into P before PV, l from the unscaled P) is the JAX
    reference's dequantize-then-multiply, to the fp32 tolerance: rows
    over one to three 64-column k tiles of a paged slot."""
    rng = np.random.default_rng(7)
    qh, kvh, d, page, pps = 8, 2, 32, 16, 12
    slots, num_pages = 2, 2 * 12 + 1
    shape = (kvh, num_pages, page, d)
    q = rng.standard_normal((7, qh, d)).astype(np.float32)
    # pools as the engine quantizes them: one scale per (head, token),
    # max |x| / 127 (ops/paged_attention.py quantize_kv)
    (k, ks), (v, vs) = (
        tuple(a.numpy() for a in quantize_kv(torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))))
        for _ in range(2))
    ptab = rng.permutation(num_pages - 1)[:slots * pps].reshape(
        slots, pps).astype(np.int32)
    slot = np.array([0, 0, 0, 1, 1, 1, 0], np.int32)
    pos = np.array([0, 63, 64, 100, 127, 190, -1], np.int32)
    args = (q, k, v, ptab, slot, pos, ks, vs)
    want = _jax(args, fn=jax_ref)
    t = torch.from_numpy
    got = _folded_int8(t(q), t(k), t(v), t(ks), t(vs), t(ptab), t(slot),
                       t(pos), d ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


# paged shapes (QH, KVH, tokens a row, split width): decode rows at split
# boundaries (G = 1) and verify chunks straddling one (G = 4), groups 1,
# 3 and 4
PAGED_FOLD_CASES = {"decode_g4": (8, 2, 1, 128), "decode_g1": (4, 4, 1, 64),
                    "verify_g4": (8, 2, 4, 128), "verify_g3": (6, 2, 4, 64)}


@pytest.mark.parametrize("case", sorted(PAGED_FOLD_CASES))
def test_int8_scale_folding_over_paged_splits(case):
    """The paged kernels' int8 arithmetic (the folding above, split into
    states of `split_cols` columns and merged) is JAX's paged decode or
    verify reference, to the fp32 tolerance: decode rows are ragged rows
    at pos = length - 1, verify token g one at base + g."""
    qh, kvh, g, split_cols = PAGED_FOLD_CASES[case]
    rng = np.random.default_rng(len(case))
    d, page, pps = 32, 16, 20
    b = 4
    num_pages = b * pps + 1
    shape = (kvh, num_pages, page, d)
    (k, ks), (v, vs) = (
        tuple(a.numpy() for a in quantize_kv(torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))))
        for _ in range(2))
    ptab = rng.permutation(num_pages - 1)[:b * pps].reshape(
        b, pps).astype(np.int32)
    q = rng.standard_normal((b, qh, g, d)).astype(np.float32)
    # bases whose rows end just before, at and after a split boundary
    base = np.asarray([split_cols - 2, split_cols - 1, 2 * split_cols - g,
                       300 - g], np.int32)
    pos = (base[:, None] + np.arange(g)[None]).reshape(-1)
    slot = np.repeat(np.arange(b, dtype=np.int32), g)
    rows = np.ascontiguousarray(q.transpose(0, 2, 1, 3).reshape(-1, qh, d))
    t = torch.from_numpy
    got = _folded_int8(t(rows), t(k), t(v), t(ks), t(vs), t(ptab), t(slot),
                       t(pos.astype(np.int32)), d ** -0.5, split_cols)
    got = got.reshape(b, g, qh, d).permute(0, 2, 1, 3).numpy()
    jp = importlib.import_module("paddle_tpu.ops.paged_attention")
    args = [jnp.asarray(a) for a in (k, v, ptab)]
    scales = {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
    if g == 1:
        want = np.asarray(jp.paged_attention_reference(
            jnp.asarray(q[:, :, 0]), *args, jnp.asarray(base + 1),
            **scales))[:, :, None]
    else:
        want = np.asarray(jp.paged_verify_reference(
            jnp.asarray(q), *args, jnp.asarray(base), **scales))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::ragged_tc_kernel<128, __nv_bfloat16>("
    "(anonymous namespace)::TcArgs)",
    "void (anonymous namespace)::ragged_tc_kernel<128, signed char>("
    "(anonymous namespace)::TcArgs)",
    "(anonymous namespace)::ragged_plan_kernel(int const*, int const*, "
    "int, int, int, int*)",
    "void (anonymous namespace)::ragged_kernel<float, float>(...)"])
def test_serving_profile_groups_the_ragged_kernels(name):
    """tools/profile_torch_serving.py charges both designs and the plan
    kernel to the ragged source."""
    assert _script("tools/profile_torch_serving.py")._group(name) == \
        "attention (ragged_paged_attention.cu)"
