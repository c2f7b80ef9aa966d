"""Comparison and logical emitters (port of ``paddle_tpu/ops/logic.py``)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.ops.math import _both, as_operand
from paddle_tpu_torch.ops.registry import register_emitter as op


@op
def equal(x, y):
    return torch.eq(*_both(x, y))


@op
def not_equal(x, y):
    return torch.ne(*_both(x, y))


@op
def greater_than(x, y):
    return torch.gt(*_both(x, y))


@op
def greater_equal(x, y):
    return torch.ge(*_both(x, y))


@op
def less_than(x, y):
    return torch.lt(*_both(x, y))


@op
def less_equal(x, y):
    return torch.le(*_both(x, y))


@op
def logical_and(x, y):
    return torch.logical_and(*_both(x, y))


@op
def logical_or(x, y):
    return torch.logical_or(*_both(x, y))


@op
def logical_xor(x, y):
    return torch.logical_xor(*_both(x, y))


@op
def logical_not(x):
    return torch.logical_not(x)


@op
def bitwise_and(x, y):
    return torch.bitwise_and(*_both(x, y))


@op
def bitwise_or(x, y):
    return torch.bitwise_or(*_both(x, y))


@op
def bitwise_xor(x, y):
    return torch.bitwise_xor(*_both(x, y))


@op
def bitwise_not(x):
    return torch.bitwise_not(x)


@op
def where(condition, x, y):
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        return torch.where(condition, as_operand(x, device=condition.device),
                           as_operand(y, device=condition.device))
    return torch.where(condition, x, y)


@op
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = _both(x, y)
    dt = torch.result_type(x, y)
    return torch.isclose(x.to(dt), y.to(dt), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


@op
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.all(isclose(x, y, rtol, atol, equal_nan))


@op
def equal_all(x, y):
    x, y = _both(x, y)
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return torch.all(torch.eq(x, y))
