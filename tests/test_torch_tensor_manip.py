"""The port's linalg, manipulation, logic and search ops and the Tensor
operator and method binding held to the JAX package's: each case of
`_torch_op_cases.CASES_MANIP` runs through both packages on the same
numpy inputs (values within 1e-6, dtypes by name, gradients within
1e-5; see that module)."""
import pytest

from paddle_tpu_torch._core import state as tstate
from _torch_op_cases import CASES_MANIP, check_case


@pytest.fixture(autouse=True)
def _cpu():
    prev = tstate._device
    tstate.set_device("cpu")
    yield
    tstate._device = prev


@pytest.mark.parametrize("case", sorted(CASES_MANIP))
def test_op_matches_jax(case):
    check_case(case)
