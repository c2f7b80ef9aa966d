"""The nn sections of the port's manifest (linear, embedding, conv,
pool; normalization; losses; attention) against the JAX package (cases
and rules: ``tests/test_torch_ops_cases.py``)."""
import pytest

from test_torch_ops_cases import _cpu_place, cases, check_case  # noqa: F401


@pytest.mark.parametrize("case", **cases(
    "nn: linear / embedding / conv / pool", "nn: normalization",
    "losses", "attention"))
def test_op_matches_reference(case):
    check_case(case)
