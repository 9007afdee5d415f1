"""The cases of tests/test_torch_tensor_ops.py and
test_torch_tensor_manip.py: each runs through both packages on the same
numpy inputs at fp32, int64 or bool (`check_case`). Values agree within
1e-6 (relative and absolute; exactly for integers and bools), dtypes by
name, and for differentiable cases the gradient of the summed output
within 1e-5."""
import numpy as np

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu._core import dtypes as jdt
from paddle_tpu_torch._core import dtypes as tdt

TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
# lgamma and digamma come from different series in the two libraries:
# values near their zeros agree to a few 1e-6 absolute
SPECIAL_TOL = dict(rtol=1e-6, atol=4e-6)


def _f(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pos(seed, *shape):
    return (np.abs(_f(seed, *shape)) + 0.5).astype(np.float32)


def _i(seed, *shape, lo=-5, hi=6):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(np.int64)


def _b(seed, *shape):
    return np.random.RandomState(seed).rand(*shape) > 0.5


A = _f(0, 3, 4)
B = _f(1, 3, 4)
P = _pos(2, 3, 4)
U = (np.random.RandomState(3).rand(3, 4) * 1.6 - 0.8).astype(np.float32)
M = _f(4, 4, 4) + 4 * np.eye(4, dtype=np.float32)
I = _i(5, 3, 4)
J = _i(6, 3, 4, lo=1, hi=6)
BO = _b(7, 3, 4)
BO2 = _b(8, 3, 4)

# name -> (fn(pt, T), differentiable); T makes a tensor of the package.
# Creation, math, reductions and stat (tests/test_torch_tensor_ops.py):
CASES_MATH = {
    # creation
    "zeros": (lambda pt, T: pt.zeros([2, 3]), False),
    "ones_int": (lambda pt, T: pt.ones([2], "int64"), False),
    "full_int": (lambda pt, T: pt.full([2, 2], 3), False),
    "full_float": (lambda pt, T: pt.full([2], 1.5), False),
    "full_bool": (lambda pt, T: pt.full([2], True), False),
    "arange": (lambda pt, T: pt.arange(0, 10, 3), False),
    "arange_float": (lambda pt, T: pt.arange(0.0, 1.0, 0.25), False),
    "linspace": (lambda pt, T: pt.linspace(0, 1, 5), False),
    "eye": (lambda pt, T: pt.eye(3, 4), False),
    "tril": (lambda pt, T: pt.tril(T(A), 1), True),
    "triu": (lambda pt, T: pt.triu(T(A), -1), True),
    "tril_indices": (lambda pt, T: pt.tril_indices(4, 3, 0), False),
    "diag": (lambda pt, T: pt.diag(T(A[0]), 1), True),
    "diag_pad": (lambda pt, T: pt.diag(T(A[0]), 0, padding_value=2.0), True),
    "diagflat": (lambda pt, T: pt.diagflat(T(A[0])), True),
    "diag_embed": (lambda pt, T: pt.diag_embed(T(A)), True),
    "diagonal": (lambda pt, T: pt.diagonal(T(M), 1), True),
    "zeros_like": (lambda pt, T: pt.zeros_like(T(I)), False),
    "full_like": (lambda pt, T: pt.full_like(T(A), 2.0), False),
    "one_hot": (lambda pt, T: pt.one_hot(T(J[0]), 6), False),
    "assign": (lambda pt, T: pt.assign(T(A)), True),
    "to_tensor_float_list": (lambda pt, T: pt.to_tensor([1.5, 2.0]), False),
    "to_tensor_int_list": (lambda pt, T: pt.to_tensor([[1, 2]]), False),
    "to_tensor_f64_array": (lambda pt, T: pt.to_tensor(
        A.astype(np.float64)), False),
    "to_tensor_dtype": (lambda pt, T: pt.to_tensor(I, dtype="float32"), False),
    # unary math
    **{n: ((lambda n: lambda pt, T: getattr(pt, n)(T(A)))(n), True)
       for n in ("abs", "atan", "ceil", "cos", "cosh", "erf", "exp", "expm1",
                 "floor", "neg", "round", "sigmoid", "sign", "sin", "sinh",
                 "square", "tanh", "trunc", "frac", "asinh")},
    **{n: ((lambda n: lambda pt, T: getattr(pt, n)(T(P)))(n), True)
       for n in ("log", "log10", "log1p", "log2", "reciprocal", "rsqrt",
                 "sqrt", "lgamma", "digamma", "acosh")},
    **{n: ((lambda n: lambda pt, T: getattr(pt, n)(T(U)))(n), True)
       for n in ("acos", "asin", "atanh", "erfinv")},
    "abs_int": (lambda pt, T: pt.abs(T(I)), False),
    "logit": (lambda pt, T: pt.logit(T(U * 0.5 + 0.5)), True),
    "stanh": (lambda pt, T: pt.stanh(T(A)), True),
    "nan_to_num": (lambda pt, T: pt.nan_to_num(T(np.array(
        [np.nan, np.inf, -np.inf, 1.0], np.float32))), False),
    # binary math
    **{n: ((lambda n: lambda pt, T: getattr(pt, n)(T(A), T(B)))(n), True)
       for n in ("add", "subtract", "multiply", "maximum", "minimum",
                 "atan2", "logaddexp", "hypot", "fmax", "fmin")},
    "divide": (lambda pt, T: pt.divide(T(A), T(P)), True),
    "divide_int": (lambda pt, T: pt.divide(T(I), T(J)), False),
    "floor_divide_int": (lambda pt, T: pt.floor_divide(T(I), T(J)), False),
    "mod_int": (lambda pt, T: pt.mod(T(I), T(J)), False),
    "mod_float": (lambda pt, T: pt.mod(T(A), T(P)), False),
    "pow": (lambda pt, T: pt.pow(T(P), T(B)), True),
    "pow_scalar": (lambda pt, T: pt.pow(T(A), 3), True),
    "add_int": (lambda pt, T: pt.add(T(I), T(J)), False),
    "kron": (lambda pt, T: pt.kron(T(A[:2, :2]), T(B[:2, :2])), True),
    "gcd": (lambda pt, T: pt.gcd(T(I), T(J)), False),
    "scale": (lambda pt, T: pt.scale(T(A), 2.0, 1.0), True),
    "scale_before": (lambda pt, T: pt.scale(T(A), 2.0, 1.0, False), True),
    "clip": (lambda pt, T: pt.clip(T(A), -0.5, 0.5), True),
    "clip_int": (lambda pt, T: pt.clip(T(I), -2, 3), False),
    "lerp": (lambda pt, T: pt.lerp(T(A), T(B), 0.3), True),
    "lerp_tensor": (lambda pt, T: pt.lerp(T(A), T(B), T(P)), True),
    # reductions
    **{f"{n}_{ax}": ((lambda n, ax: lambda pt, T: getattr(pt, n)(
        T(A), axis=ax))(n, ax), True)
       for n in ("sum", "mean", "max", "min", "amax", "amin", "prod",
                 "logsumexp")
       for ax in (None, 1, (0, 1))},
    "sum_keepdim": (lambda pt, T: pt.sum(T(A), axis=0, keepdim=True), True),
    "sum_int": (lambda pt, T: pt.sum(T(I), axis=1), False),
    "sum_bool": (lambda pt, T: pt.sum(T(BO)), False),
    "sum_dtype": (lambda pt, T: pt.sum(T(I), dtype="float32"), False),
    "mean_int": (lambda pt, T: pt.mean(T(I)), False),
    "count_nonzero": (lambda pt, T: pt.count_nonzero(T(I), axis=1), False),
    "all": (lambda pt, T: pt.all(T(BO), axis=1), False),
    "any": (lambda pt, T: pt.any(T(BO)), False),
    "cumsum": (lambda pt, T: pt.cumsum(T(A), axis=1), True),
    "cumsum_flat": (lambda pt, T: pt.cumsum(T(A)), True),
    "cumprod": (lambda pt, T: pt.cumprod(T(A), dim=0), True),
    "cummax": (lambda pt, T: pt.cummax(T(A), axis=1), False),
    "cummin": (lambda pt, T: pt.cummin(T(A), axis=0), False),
    "logcumsumexp": (lambda pt, T: pt.logcumsumexp(T(A), axis=1), True),
    "diff": (lambda pt, T: pt.diff(T(A), axis=1), True),
    "trapezoid": (lambda pt, T: pt.trapezoid(T(A), dx=0.5), True),
    "isfinite": (lambda pt, T: pt.isfinite(T(np.array(
        [1.0, np.inf, np.nan], np.float32))), False),
    "isnan": (lambda pt, T: pt.isnan(T(np.array([1.0, np.nan],
                                                np.float32))), False),
    "inner": (lambda pt, T: pt.inner(T(A), T(B)), True),
    "outer": (lambda pt, T: pt.outer(T(A[0]), T(B[0])), True),
    "addmm": (lambda pt, T: pt.addmm(T(M), T(M), T(M), 0.5, 2.0), True),
    "trace": (lambda pt, T: pt.trace(T(M), 1), True),
    "renorm": (lambda pt, T: pt.renorm(T(A), 2.0, 0, 1.0), True),
    "std": (lambda pt, T: pt.std(T(A), axis=1), True),
    "var": (lambda pt, T: pt.var(T(A), unbiased=False), True),
    "median": (lambda pt, T: pt.median(T(A), axis=1), False),
    "median_even": (lambda pt, T: pt.median(T(A)), False),
    "quantile": (lambda pt, T: pt.quantile(T(A), [0.3, 0.7], axis=1),
                 False),
}
# linalg, manipulation, logic, search, the operators and the methods
# (tests/test_torch_tensor_manip.py):
CASES_MANIP = {
    # linalg
    "matmul": (lambda pt, T: pt.matmul(T(A), T(B), transpose_y=True), True),
    "matmul_tx": (lambda pt, T: pt.matmul(T(A), T(B), transpose_x=True),
                  True),
    "mm": (lambda pt, T: pt.mm(T(M), T(M)), True),
    "bmm": (lambda pt, T: pt.bmm(T(np.stack([A, B])),
                                 T(np.stack([B.T, A.T]))), True),
    "dot": (lambda pt, T: pt.dot(T(A), T(B)), True),
    "mv": (lambda pt, T: pt.mv(T(A), T(B[0])), True),
    "t": (lambda pt, T: pt.t(T(A)), True),
    "transpose": (lambda pt, T: pt.transpose(T(A), [1, 0]), True),
    **{f"norm_{p}_{ax}": ((lambda p, ax: lambda pt, T: pt.norm(
        T(A), p=p, axis=ax))(p, ax), True)
       for p, ax in ((None, None), ("fro", None), (2, 1), (1, 0),
                     (np.inf, 1), (3, None), (2, (0, 1)))},
    "dist": (lambda pt, T: pt.dist(T(A), T(B), 3), True),
    "cross": (lambda pt, T: pt.cross(T(A[:, :3]), T(B[:, :3]), axis=1),
              True),
    "inv": (lambda pt, T: pt.linalg.inv(T(M)), True),
    "det": (lambda pt, T: pt.linalg.det(T(M)), True),
    "solve": (lambda pt, T: pt.linalg.solve(T(M), T(A.T)), True),
    "cholesky": (lambda pt, T: pt.linalg.cholesky(T(M @ M.T)), True),
    "matrix_power": (lambda pt, T: pt.linalg.matrix_power(T(M * 0.3), 3),
                     True),
    "multi_dot": (lambda pt, T: pt.linalg.multi_dot([T(A), T(M), T(M)]),
                  True),
    # manipulation
    "reshape": (lambda pt, T: pt.reshape(T(A), [0, 2, -1]), True),
    "flatten": (lambda pt, T: pt.flatten(T(np.stack([A, B]))), True),
    "flatten_mid": (lambda pt, T: pt.flatten(T(np.stack([A, B])), 1, 2),
                    True),
    "squeeze": (lambda pt, T: pt.squeeze(T(A[None, :, None]), axis=[0, 2]),
                True),
    "unsqueeze": (lambda pt, T: pt.unsqueeze(T(A), [0, -1]), True),
    "concat": (lambda pt, T: pt.concat([T(A), T(B)], axis=1), True),
    "stack": (lambda pt, T: pt.stack([T(A), T(B)], axis=1), True),
    "split": (lambda pt, T: pt.split(T(A), [1, -1], axis=1), True),
    "split_n": (lambda pt, T: pt.split(T(A), 2, axis=1), True),
    "chunk": (lambda pt, T: pt.chunk(T(A), 3, axis=1), True),
    "tile": (lambda pt, T: pt.tile(T(A), [2, 1]), True),
    "expand": (lambda pt, T: pt.expand(T(A[:1]), [3, 4]), True),
    "broadcast_to": (lambda pt, T: pt.broadcast_to(T(A[:, :1]), [3, 4]),
                     True),
    "gather": (lambda pt, T: pt.gather(T(A), T(np.array([2, 0])), axis=0),
               True),
    "gather_nd": (lambda pt, T: pt.gather_nd(T(A), T(np.array(
        [[0, 1], [2, 3]]))), True),
    "scatter": (lambda pt, T: pt.scatter(T(A), T(np.array([1, 0])),
                                         T(B[:2])), True),
    "scatter_add": (lambda pt, T: pt.scatter(T(A), T(np.array([1, 1])),
                                             T(B[:2]), overwrite=False), True),
    "scatter_nd_add": (lambda pt, T: pt.scatter_nd_add(
        T(A), T(np.array([[0], [0], [2]])), T(B)), True),
    "scatter_nd": (lambda pt, T: pt.scatter_nd(
        T(np.array([[1], [0]])), T(B[:2]), [3, 4]), True),
    "index_select": (lambda pt, T: pt.index_select(
        T(A), T(np.array([3, 1])), axis=1), True),
    "index_sample": (lambda pt, T: pt.index_sample(
        T(A), T(np.array([[0, 1], [2, 3], [1, 1]]))), True),
    "index_add": (lambda pt, T: pt.index_add(T(A), T(np.array([0, 2])), 0,
                                             T(B[:2])), True),
    "index_fill": (lambda pt, T: pt.index_fill(T(A), T(np.array([1])), 1,
                                               2.5), True),
    "index_put": (lambda pt, T: pt.index_put(
        T(A), (T(np.array([0, 2])), T(np.array([1, 3]))), T(B[0, :2])), True),
    "masked_select": (lambda pt, T: pt.masked_select(T(A), T(BO)), False),
    "masked_fill": (lambda pt, T: pt.masked_fill(T(A), T(BO), 9.0), True),
    "roll": (lambda pt, T: pt.roll(T(A), 1, axis=1), True),
    "roll_flat": (lambda pt, T: pt.roll(T(A), 2), True),
    "flip": (lambda pt, T: pt.flip(T(A), [0, 1]), True),
    "rot90": (lambda pt, T: pt.rot90(T(A)), True),
    "take_along_axis": (lambda pt, T: pt.take_along_axis(
        T(A), T(np.array([[0], [3], [1]])), 1), True),
    "put_along_axis": (lambda pt, T: pt.put_along_axis(
        T(A), T(np.array([[0], [3], [1]])), 7.0, 1), False),
    "put_along_axis_add": (lambda pt, T: pt.put_along_axis(
        T(A), T(np.array([[0], [3], [1]])), 7.0, 1, reduce="add"), False),
    "repeat_interleave": (lambda pt, T: pt.repeat_interleave(T(A), 2, 0),
                          True),
    "unbind": (lambda pt, T: pt.unbind(T(A), 1), True),
    "slice": (lambda pt, T: pt.slice(T(A), [0, 1], [1, 0], [3, 3]), True),
    "strided_slice": (lambda pt, T: pt.strided_slice(
        T(A), [1], [0], [4], [2]), True),
    "crop": (lambda pt, T: pt.crop(T(A), [2, 2], [1, 1]), True),
    "moveaxis": (lambda pt, T: pt.moveaxis(T(np.stack([A, B])), 0, 2), True),
    "swapaxes": (lambda pt, T: pt.swapaxes(T(A), 0, 1), True),
    "tensordot": (lambda pt, T: pt.tensordot(T(A), T(B.T), 1), True),
    "take": (lambda pt, T: pt.take(T(A), T(np.array([0, 5, -1]))), True),
    "unflatten": (lambda pt, T: pt.unflatten(T(A), 1, [2, 2]), True),
    "unfold": (lambda pt, T: pt.unfold(T(A), 1, 2, 1), True),
    "where": (lambda pt, T: pt.where(T(BO), T(A), T(B)), True),
    "where_nonzero": (lambda pt, T: pt.where(T(BO)), False),
    "searchsorted": (lambda pt, T: pt.searchsorted(
        T(np.array([0.0, 1.0, 2.0], np.float32)), T(A)), False),
    "bucketize": (lambda pt, T: pt.bucketize(
        T(A), T(np.array([-1.0, 0.0, 1.0], np.float32)), right=True), False),
    "hstack": (lambda pt, T: pt.hstack([T(A), T(B)]), True),
    "vstack": (lambda pt, T: pt.vstack([T(A), T(B)]), True),
    "atleast_2d": (lambda pt, T: pt.atleast_2d(T(A[0])), True),
    "shard_index": (lambda pt, T: pt.shard_index(T(J), 8, 2, 1), False),
    # logic
    **{n: ((lambda n: lambda pt, T: getattr(pt, n)(T(A), T(B)))(n), False)
       for n in ("equal", "not_equal", "greater_than", "greater_equal",
                 "less_than", "less_equal", "isclose")},
    "equal_scalar": (lambda pt, T: pt.equal(T(I), 2), False),
    **{n: ((lambda n: lambda pt, T: getattr(pt, n)(T(BO), T(BO2)))(n), False)
       for n in ("logical_and", "logical_or", "logical_xor")},
    "logical_not": (lambda pt, T: pt.logical_not(T(BO)), False),
    **{n: ((lambda n: lambda pt, T: getattr(pt, n)(T(I), T(J)))(n), False)
       for n in ("bitwise_and", "bitwise_or", "bitwise_xor")},
    "bitwise_not": (lambda pt, T: pt.bitwise_not(T(I)), False),
    "allclose": (lambda pt, T: pt.allclose(T(A), T(A + 1e-9)), False),
    "equal_all": (lambda pt, T: pt.equal_all(T(I), T(I)), False),
    "isin": (lambda pt, T: pt.isin(T(I), T(np.array([0, 1, 2]))), False),
    # search
    "argmax": (lambda pt, T: pt.argmax(T(A), axis=1), False),
    "argmax_flat": (lambda pt, T: pt.argmax(T(A)), False),
    "argmin_keep": (lambda pt, T: pt.argmin(T(A), axis=0, keepdim=True),
                    False),
    "argsort": (lambda pt, T: pt.argsort(T(A), axis=1, descending=True),
                False),
    "sort": (lambda pt, T: pt.sort(T(A), axis=0), True),
    "topk": (lambda pt, T: pt.topk(T(A), 2, axis=1), False),
    "topk_small": (lambda pt, T: pt.topk(T(A), 2, axis=0, largest=False),
                   False),
    "kthvalue": (lambda pt, T: pt.kthvalue(T(A), 2, axis=1), False),
    "mode": (lambda pt, T: pt.mode(T(J), axis=1), False),
    "nonzero": (lambda pt, T: pt.nonzero(T(BO)), False),
    "unique": (lambda pt, T: pt.unique(T(J), return_index=True,
                                       return_inverse=True,
                                       return_counts=True), False),
    "unique_consecutive": (lambda pt, T: pt.unique_consecutive(
        T(np.array([1, 1, 2, 2, 3, 1, 1])), return_inverse=True,
        return_counts=True), False),
    "einsum": (lambda pt, T: pt.einsum("ij,kj->ik", T(A), T(B)), True),
    # operators and methods
    "op_add_scalar": (lambda pt, T: T(A) + 2, True),
    "op_radd": (lambda pt, T: 2.5 + T(A), True),
    "op_rsub": (lambda pt, T: 1 - T(A), True),
    "op_mul": (lambda pt, T: T(A) * T(B), True),
    "op_rtruediv": (lambda pt, T: 2.0 / T(P), True),
    "op_pow": (lambda pt, T: T(P) ** 2.5, True),
    "op_rpow": (lambda pt, T: 2.0 ** T(A), True),
    "op_matmul": (lambda pt, T: T(A) @ T(B.T), True),
    "op_neg_abs": (lambda pt, T: abs(-T(A)), True),
    "op_int_scalar": (lambda pt, T: T(I) * 3 + 1, False),
    "op_int_floordiv": (lambda pt, T: T(I) // T(J), False),
    "op_int_mod": (lambda pt, T: T(I) % 4, False),
    "op_cmp": (lambda pt, T: T(A) > 0.1, False),
    "op_cmp_tensor": (lambda pt, T: T(A) <= T(B), False),
    "op_invert_bool": (lambda pt, T: ~T(BO), False),
    "op_and_bool": (lambda pt, T: T(BO) & T(BO2), False),
    "op_xor_int": (lambda pt, T: T(I) ^ T(J), False),
    "op_shift": (lambda pt, T: T(J) << 2, False),
    "method_sum": (lambda pt, T: T(A).sum(axis=1), True),
    "method_mean": (lambda pt, T: T(A).mean(), True),
    "method_reshape": (lambda pt, T: T(A).reshape([4, 3]), True),
    "method_transpose": (lambda pt, T: T(A).transpose([1, 0]), True),
    "method_exp": (lambda pt, T: T(A).exp(), True),
    "method_astype": (lambda pt, T: T(A).astype("int64"), False),
    "method_cast_bool": (lambda pt, T: T(I).cast("bool"), False),
    # the reference's Tensor.T resolves its tensor package to the shadowing
    # `tensor` function; its t() is what .T means
    "method_T": (lambda pt, T: T(A).T if pt is tp else pt.t(T(A)), True),
    "method_getitem": (lambda pt, T: T(A)[1:, ::2], True),
    "method_getitem_int": (lambda pt, T: T(A)[T(np.array([2, 0]))], True),
    "method_getitem_bool": (lambda pt, T: T(A)[T(BO)], True),
    "method_clip": (lambda pt, T: T(A).clip(-0.1, 0.1), True),
    "method_matmul": (lambda pt, T: T(A).matmul(T(B), transpose_y=True),
                      True),
    "method_unsqueeze": (lambda pt, T: T(A).unsqueeze(0), True),
    "method_argmax": (lambda pt, T: T(A).argmax(axis=0), False),
}
CASES = {**CASES_MATH, **CASES_MANIP}


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [l for v in x for l in _leaves(v)]
    return [x]


def _run(pt, fn, diff):
    made = []

    def T(a):
        t = pt.to_tensor(a, stop_gradient=not (
            diff and np.asarray(a).dtype == np.float32))
        made.append(t)
        return t
    out = fn(pt, T)
    leaves = _leaves(out)
    grads = None
    if diff:
        floats = [l for l in leaves if not l.stop_gradient]
        total = floats[0].sum()
        for l in floats[1:]:
            total = total + l.sum()
        total.backward()
        grads = [None if t.grad is None else np.asarray(t.grad.numpy())
                 for t in made if not t.stop_gradient]
    return leaves, grads


def check_case(case):
    """Run CASES[case] through both packages and compare."""
    fn, diff = CASES[case]
    ref, ref_g = _run(jp, fn, diff)
    got, got_g = _run(tp, fn, diff)
    assert len(ref) == len(got), case
    for r, g in zip(ref, got):
        assert jdt.dtype_name(r.dtype) == tdt.dtype_name(g.dtype), \
            (case, r.dtype, g.dtype)
        assert r.shape == g.shape, (case, r.shape, g.shape)
        rv, gv = np.asarray(r.numpy()), g.numpy()
        if rv.dtype.kind in "biu":
            np.testing.assert_array_equal(gv, rv, err_msg=case)
        else:
            np.testing.assert_allclose(
                gv, rv, err_msg=case,
                **(SPECIAL_TOL if case in ("lgamma", "digamma") else TOL))
    if diff:
        assert len(ref_g) == len(got_g)
        for r, g in zip(ref_g, got_g):
            if r is None or g is None:
                assert r is None or not np.any(r), case
                assert g is None or not np.any(g), case
                continue
            np.testing.assert_allclose(g, r, err_msg=case, **GRAD_TOL)
