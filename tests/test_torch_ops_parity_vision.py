"""The "vision" section of the port's manifest (RoI family, deformable
convolution, YOLOv3 loss, affine_grid / grid_sample, CTC and RNN-T,
vander) against the JAX package (cases and rules:
``tests/test_torch_ops_cases.py``)."""
import pytest

from test_torch_ops_cases import _cpu_place, cases, check_case  # noqa: F401
from test_torch_ops_cases import VISION


@pytest.mark.parametrize("case", **cases(VISION))
def test_op_matches_reference(case):
    check_case(case)
