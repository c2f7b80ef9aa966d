"""The linalg and activations sections of the port's manifest against
the JAX package (cases and rules: ``tests/test_torch_ops_cases.py``)."""
import pytest

from test_torch_ops_cases import _cpu_place, cases, check_case  # noqa: F401


@pytest.mark.parametrize("case", **cases("linalg", "activations"))
def test_op_matches_reference(case):
    check_case(case)
