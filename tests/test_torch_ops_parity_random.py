"""The drawing sections of the port's manifest (nn: dropout / sampling;
random, with its einsum and fft family) against the JAX package, both
seeded alike before each case (cases and rules:
``tests/test_torch_ops_cases.py``)."""
import pytest

from test_torch_ops_cases import _cpu_place, cases, check_case  # noqa: F401


@pytest.mark.parametrize("case", **cases("nn: dropout / sampling",
                                         "random"))
def test_op_matches_reference(case):
    check_case(case)
