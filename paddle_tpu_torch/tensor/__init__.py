"""paddle_tpu_torch.tensor: the op namespace and the Tensor method and
operator binding (counterpart of `paddle_tpu/tensor/__init__.py`)."""
from __future__ import annotations

from .._core import dtypes as _dt
from .._core.tensor import Tensor, Parameter, apply, unwrap, wrap  # noqa: F401
from . import creation, math, linalg, manipulation, logic, random, search, \
    stat, einsum as _einsum_mod, attribute

from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .einsum import einsum  # noqa: F401
from .attribute import is_complex, is_floating_point, is_integer, rank  # noqa: F401


# ---------------------------------------------------------------- operators
def _binop(fn, swap=False):
    def op(self, other):
        if swap:
            return fn(other if isinstance(other, Tensor) else
                      _scalar_like(other, self), self)
        return fn(self, other)
    return op


def _scalar_like(v, t):
    """A non-Tensor left operand of a reflected operator. A Python scalar
    becomes a 0-d tensor beside `t`, which torch's promotion treats as
    weak (it takes t's dtype within its kind), as jnp's weak types do."""
    if isinstance(v, (bool, int, float, complex)):
        import torch
        return Tensor(torch.tensor(v, device=t._value.device))
    return creation.to_tensor(v)


_cmp_table = [
    ("__eq__", logic.equal), ("__ne__", logic.not_equal),
    ("__lt__", logic.less_than), ("__le__", logic.less_equal),
    ("__gt__", logic.greater_than), ("__ge__", logic.greater_equal),
]

Tensor.__add__ = _binop(math.add)
Tensor.__radd__ = _binop(math.add, swap=True)
Tensor.__sub__ = _binop(math.subtract)
Tensor.__rsub__ = _binop(math.subtract, swap=True)
Tensor.__mul__ = _binop(math.multiply)
Tensor.__rmul__ = _binop(math.multiply, swap=True)
Tensor.__truediv__ = _binop(math.divide)
Tensor.__rtruediv__ = _binop(math.divide, swap=True)
Tensor.__floordiv__ = _binop(math.floor_divide)
Tensor.__rfloordiv__ = _binop(math.floor_divide, swap=True)
Tensor.__mod__ = _binop(math.mod)
Tensor.__rmod__ = _binop(math.mod, swap=True)
Tensor.__pow__ = _binop(math.pow)
Tensor.__rpow__ = _binop(math.pow, swap=True)
Tensor.__matmul__ = lambda self, other: linalg.matmul(self, other)
Tensor.__rmatmul__ = lambda self, other: linalg.matmul(
    creation.to_tensor(other), self)
Tensor.__neg__ = lambda self: math.neg(self)
Tensor.__abs__ = lambda self: math.abs(self)
Tensor.__invert__ = lambda self: (logic.logical_not(self)
                                  if self.dtype == _dt.bool_
                                  else logic.bitwise_not(self))
Tensor.__and__ = lambda self, o: (logic.logical_and(self, o)
                                  if self.dtype == _dt.bool_
                                  else logic.bitwise_and(self, o))
Tensor.__or__ = lambda self, o: (logic.logical_or(self, o)
                                 if self.dtype == _dt.bool_
                                 else logic.bitwise_or(self, o))
Tensor.__xor__ = lambda self, o: (logic.logical_xor(self, o)
                                  if self.dtype == _dt.bool_
                                  else logic.bitwise_xor(self, o))
Tensor.__lshift__ = lambda self, o: logic.bitwise_left_shift(self, o)
Tensor.__rshift__ = lambda self, o: logic.bitwise_right_shift(self, o)

for _name, _fn in _cmp_table:
    def _mk(f=_fn):
        def op(self, other):
            if other is None:
                return False if f is logic.equal else True
            return f(self, other)
        return op
    setattr(Tensor, _name, _mk())


# ------------------------------------------------------- method stitching
_METHOD_SOURCES = [creation, math, linalg, manipulation, logic, random,
                   search, stat, _einsum_mod, attribute]
_SKIP = {"to_tensor", "tensor", "zeros", "ones", "full", "empty", "arange",
         "linspace", "logspace", "eye", "meshgrid", "rand", "randn",
         "randint", "randperm", "uniform", "normal", "seed", "get_rng_state",
         "set_rng_state", "tril_indices", "triu_indices", "create_parameter",
         "assign", "broadcast_shape", "einsum", "scatter_nd", "block_diag",
         "standard_normal", "log_normal", "shape", "numel"}

for _mod in _METHOD_SOURCES:
    for _fname in getattr(_mod, "__all__", []):
        if _fname in _SKIP or hasattr(Tensor, _fname):
            continue
        _f = getattr(_mod, _fname, None)
        if callable(_f):
            setattr(Tensor, _fname, _f)

# In-place `op_` variants (snapshot-consistent: extras.inplace_apply).
from .extras import make_inplace as _make_inplace  # noqa: E402

for _fname in ["add", "subtract", "multiply", "divide", "clip", "scale",
               "floor", "ceil", "exp", "sqrt", "rsqrt", "reciprocal", "round",
               "abs", "tanh", "squeeze", "unsqueeze", "flatten", "log",
               "log2", "log10", "log1p", "sin", "cos", "tan", "sinh", "cosh",
               "asin", "acos", "atan", "erf", "erfinv", "sign", "trunc",
               "frac", "sigmoid", "neg", "pow", "lerp", "tril", "triu",
               "digamma", "lgamma", "expm1", "square", "mod",
               "floor_divide", "logical_and", "logical_or", "logical_not",
               "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor",
               "bitwise_not", "masked_fill", "nan_to_num",
               "index_add", "index_fill", "index_put",
               "cumsum", "cumprod", "transpose", "cast"]:
    if hasattr(Tensor, _fname) and not hasattr(Tensor, _fname + "_"):
        setattr(Tensor, _fname + "_",
                _make_inplace(getattr(Tensor, _fname), _fname + "_"))

Tensor.mean = stat.mean
Tensor.pow = math.pow
Tensor.remainder_ = _make_inplace(Tensor.remainder, "remainder_")
Tensor.mul_ = _make_inplace(Tensor.multiply, "mul_")
Tensor.sub_ = _make_inplace(Tensor.subtract, "sub_")
Tensor.div_ = _make_inplace(Tensor.divide, "div_")
