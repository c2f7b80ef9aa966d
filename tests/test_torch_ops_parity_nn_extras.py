"""The "nn long tail" section of the port's manifest (3-D and 1-D
pools, fractional pools, unpools, shuffles, fold, rrelu, transposed
convolutions, losses) against the JAX package (cases and rules:
``tests/test_torch_ops_cases.py``)."""
import pytest

from test_torch_ops_cases import _cpu_place, cases, check_case  # noqa: F401
from test_torch_ops_cases import NN_TAIL


@pytest.mark.parametrize("case", **cases(NN_TAIL))
def test_op_matches_reference(case):
    check_case(case)
