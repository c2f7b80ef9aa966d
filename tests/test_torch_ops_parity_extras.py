"""The "long-tail surface" section of the port's manifest (stack and
split family, special math, scatter family, predicates, draws) against the JAX package (cases and rules:
``tests/test_torch_ops_cases.py``)."""
import pytest

from test_torch_ops_cases import _cpu_place, cases, check_case  # noqa: F401
from test_torch_ops_cases import LONG_TAIL


@pytest.mark.parametrize("case", **cases(LONG_TAIL))
def test_op_matches_reference(case):
    check_case(case)
