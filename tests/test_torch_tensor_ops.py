"""The port's tensor ops (creation, math, reductions, stat, random)
held to the JAX package's: each case of `_torch_op_cases.CASES_MATH`
runs through both packages on the same numpy inputs (values within
1e-6, dtypes by name, gradients within 1e-5; see that module). After
the same seed, rand, randint, randperm and uniform agree bit for bit and
randn within 1e-6; in-place ops and add_n as the reference computes
them."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu._core import dtypes as jdt
from paddle_tpu_torch._core import dtypes as tdt
from paddle_tpu_torch._core import state as tstate
from _torch_op_cases import A, B, CASES_MATH, I, J, P, TOL, check_case


@pytest.fixture(autouse=True)
def _cpu():
    prev = tstate._device
    tstate.set_device("cpu")
    yield
    tstate._device = prev


@pytest.mark.parametrize("case", sorted(CASES_MATH))
def test_op_matches_jax(case):
    check_case(case)


@pytest.mark.parametrize("seed", [0, 123])
def test_random_draws_follow_the_reference_key_stream(seed):
    outs = {}
    for name, pt in (("jax", jp), ("torch", tp)):
        pt.seed(seed)
        outs[name] = [pt.rand([5, 7]), pt.randint(-3, 1000, [6]),
                      pt.randn([4, 9]), pt.randperm(20),
                      pt.uniform([3, 3], min=-2.0, max=5.0),
                      pt.randint(10, shape=[2, 2], dtype="int32"),
                      pt.normal(1.0, 2.0, [8])]
        outs[name] = [np.asarray(t.numpy()) for t in outs[name]] + \
            [pt.get_rng_state()["counter"]]
    ref, got = outs["jax"], outs["torch"]
    for k in (0, 1, 3, 4, 5):
        assert ref[k].dtype == got[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])
    for k in (2, 6):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6)
    assert ref[7] == got[7]


def test_add_n_sums_its_inputs():
    """add_n against the sum of the reference's adds (the reference's own
    add_n calls its shadowed `sum`)."""
    ref = jp.add(jp.add(jp.to_tensor(A), jp.to_tensor(B)), jp.to_tensor(P))
    ts = [tp.to_tensor(a, stop_gradient=False) for a in (A, B, P)]
    out = tp.add_n(ts)
    out.sum().backward()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.numpy()), **TOL)
    for t in ts:
        np.testing.assert_array_equal(t.grad.numpy(), np.ones_like(A))


def test_rng_state_round_trip_and_key_context():
    tp.seed(5)
    st = tp.get_rng_state()
    a = tp.rand([4]).numpy()
    tp.set_rng_state(st)
    assert np.array_equal(tp.rand([4]).numpy(), a)
    from paddle_tpu_torch import _prng
    with tp.random_key_context(_prng.key(9)):
        b = tp.rand([3]).numpy()
    with tp.random_key_context(_prng.key(9)):
        assert np.array_equal(tp.rand([3]).numpy(), b)


def test_dtypes_map_by_name():
    for name in ("bool", "uint8", "int8", "int16", "int32", "int64",
                 "float16", "bfloat16", "float32", "float64", "complex64",
                 "float8_e4m3fn", "float8_e5m2"):
        assert tdt.dtype_name(tdt.convert_dtype(name)) == name
        assert tdt.dtype_name(tdt.convert_dtype(jdt.convert_dtype(name))) \
            == name
    assert tdt.convert_dtype("FP16") == tdt.float16
    assert tdt.dtype_name(tp.get_default_dtype()) == "float32"
    assert tp.finfo("bfloat16").eps == jp.finfo("bfloat16").eps
    assert tp.iinfo("int32").max == jp.iinfo("int32").max


def test_inplace_ops_match_jax():
    outs = []
    for pt in (jp, tp):
        x = pt.to_tensor(A)
        x.add_(pt.to_tensor(B)).exp_().clip_(0.5, 2.0)
        y = pt.to_tensor(I)
        y.multiply_(pt.to_tensor(J))
        z = pt.to_tensor(A)
        z[1] = 7.0
        w = pt.zeros([3])
        w.set_value(np.array([1.0, 2.0, 3.0], np.float32))
        outs.append([np.asarray(t.numpy()) for t in (x, y, z, w)])
    for r, g in zip(*outs):
        np.testing.assert_allclose(g, r, **TOL)
