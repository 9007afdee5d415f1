"""paddle_tpu_torch's paged decode attention held to the JAX package's on
the CPU: `paged_attention` (its plain version) against JAX's
`paged_attention_reference` for rows of length >= 1, and against the
Pallas decode kernels run in interpret mode (`use_pallas=True,
interpret=True`) for every row, length 0 included; fp32 and int8 pages,
GQA groups 1, 2 and 4, page-table entries past a row's length pointing
at the trash page. fp32 to 1e-5: the same sums in another order.

A length-0 row is where the two JAX sides differ: the reference's
softmax over all-masked scores is uniform (the mean of the gathered V),
the kernel skips every page and writes zeros. The port follows the
kernel; engines discard such rows (free slots)."""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as TP

# the module itself: `paddle_tpu.ops` exports a function of the same name
JP = importlib.import_module("paddle_tpu.ops.paged_attention")

ATOL = 1e-5
LENGTHS = [13, 5, 0, 32, 1]


def _batch(kvh, group, quant, d=16, page=8, pps=5, seed=0):
    """Pools with a trash page (the last) full of large values, a page
    table whose entries past each row's length point at it, and q."""
    rng = np.random.default_rng(seed)
    b = len(LENGTHS)
    npg = b * pps + 1
    shape = (kvh, npg, page, d)
    ptab = np.full((b, pps), npg - 1, np.int32)
    perm = rng.permutation(npg - 1)
    for i, n in enumerate(LENGTHS):
        used = -(-n // page)
        ptab[i, :used] = perm[i * pps:i * pps + used]
    if quant:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, shape[:-1] + (1,)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, shape[:-1] + (1,)).astype(np.float32)
        ks[:, -1] = vs[:, -1] = 50.0
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        kp[:, -1] = vp[:, -1] = 1e4
        ks = vs = None
    q = rng.standard_normal((b, kvh * group, d)).astype(np.float32)
    return q, kp, vp, ptab, np.asarray(LENGTHS, np.int32), ks, vs


def _torch(q, kp, vp, ptab, lens, ks, vs):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return TP.paged_attention(t(q), t(kp), t(vp), t(ptab), t(lens),
                              k_scale=t(ks), v_scale=t(vs)).numpy()


def _jax(q, kp, vp, ptab, lens, ks, vs, **kw):
    jn = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return np.asarray(JP.paged_attention(
        jn(q), jn(kp), jn(vp), jn(ptab), jn(lens), k_scale=jn(ks),
        v_scale=jn(vs), **kw))


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("kvh,group", [(4, 1), (2, 2), (2, 4)],
                         ids=["g1", "g2", "g4"])
def test_matches_jax_reference_for_nonempty_rows(quant, kvh, group):
    args = _batch(kvh, group, quant)
    got = _torch(*args)
    want = _jax(*args, use_pallas=False, interpret=False)
    live = args[4] > 0
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("kvh,group", [(4, 1), (2, 2), (2, 4)],
                         ids=["g1", "g2", "g4"])
def test_matches_pallas_kernel_interpret_every_row(quant, kvh, group):
    args = _batch(kvh, group, quant, seed=1)
    got = _torch(*args)
    want = _jax(*args, use_pallas=True, interpret=True)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.all(got[args[4] == 0] == 0)


def test_reference_copy_equals_jax_reference_length0_included():
    """The copied JAX reference keeps its length-0 answer (the mean of
    the gathered V), which the decode plain version does not."""
    q, kp, vp, ptab, lens, _, _ = _batch(2, 2, False, seed=2)
    t = torch.from_numpy
    got = TP.paged_attention_reference(t(q), t(kp), t(vp), t(ptab),
                                       t(lens)).numpy()
    want = np.asarray(JP.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ptab),
        jnp.asarray(lens)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    dec = TP.paged_decode_reference(t(q), t(kp), t(vp), t(ptab),
                                    t(lens)).numpy()
    assert np.abs(got[lens == 0]).max() > 0.1
    assert np.all(dec[lens == 0] == 0)
    np.testing.assert_array_equal(dec[lens > 0] != 0, got[lens > 0] != 0)


def test_sm_scale_and_output_dtype():
    q, kp, vp, ptab, lens, _, _ = _batch(2, 2, False, seed=3)
    t = torch.from_numpy
    got = TP.paged_attention(t(q), t(kp), t(vp), t(ptab), t(lens),
                             sm_scale=0.7)
    want = np.asarray(JP.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ptab),
        jnp.asarray(lens), sm_scale=0.7, use_pallas=True, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    bf = TP.paged_attention(t(q).bfloat16(), t(kp).bfloat16(),
                            t(vp).bfloat16(), t(ptab), t(lens))
    assert bf.dtype == torch.bfloat16


def test_scales_come_together():
    q, kp, vp, ptab, lens, ks, _ = _batch(2, 2, True)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="together"):
        TP.paged_attention(t(q), t(kp), t(vp), t(ptab), t(lens),
                           k_scale=t(ks))


def test_wrapper_raises_off_cpu_and_cuda():
    meta = {"device": "meta"}
    q = torch.empty((3, 4, 16), **meta)
    pages = torch.empty((2, 5, 8, 16), **meta)
    ptab = torch.zeros((3, 2), dtype=torch.int32, **meta)
    lens = torch.zeros((3,), dtype=torch.int32, **meta)
    before = (TP.launches_decode, TP.launches_decode_int8)
    with pytest.raises(ValueError, match="meta"):
        TP.paged_attention(q, pages, pages, ptab, lens)
    assert (TP.launches_decode, TP.launches_decode_int8) == before
