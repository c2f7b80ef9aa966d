"""Tensor creation emitters (port of ``paddle_tpu/ops/creation.py``).

A new tensor lands on the default place (the card; see
:mod:`paddle_tpu_torch.core.place`). Integer ranges and index tensors are
int64, the port's default integer (jnp's without x64 is int32).
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.dtype import get_default_dtype, to_torch
from paddle_tpu_torch.core.place import _default_device
from paddle_tpu_torch.ops.registry import register_emitter as op


def _dt(dtype, default=None):
    if dtype is None:
        return to_torch(default if default is not None
                        else get_default_dtype())
    return to_torch(dtype)


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


@op
def zeros(shape, dtype=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=_default_device())


@op
def ones(shape, dtype=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype),
                      device=_default_device())


@op
def full(shape, fill_value, dtype=None):
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=_default_device())


@op
def empty(shape, dtype=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=_default_device())


def _like_dt(x, dtype):
    return to_torch(dtype) if dtype is not None else x.dtype


@op
def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=_like_dt(x, dtype))


@op
def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=_like_dt(x, dtype))


@op
def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=_like_dt(x, dtype))


@op
def empty_like(x, dtype=None):
    return torch.zeros_like(x, dtype=_like_dt(x, dtype))


@op
def arange(start=0, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    if dtype is None:
        ints = all(float(v).is_integer() for v in (start, end, step))
        dt = torch.int64 if ints else _dt(None)
    else:
        dt = to_torch(dtype)
    return torch.arange(start, end, step, dtype=dt, device=_default_device())


@op
def linspace(start, stop, num, dtype=None):
    return torch.linspace(start, stop, int(num), dtype=_dt(dtype),
                          device=_default_device())


@op
def logspace(start, stop, num, base=10.0, dtype=None):
    return torch.logspace(start, stop, int(num), base=base, dtype=_dt(dtype),
                          device=_default_device())


@op
def eye(num_rows, num_columns=None, dtype=None):
    m = num_rows if num_columns is None else num_columns
    return torch.eye(int(num_rows), int(m), dtype=_dt(dtype),
                     device=_default_device())


@op
def diag(x, offset=0):
    return torch.diag(x, diagonal=offset)


@op
def diagflat(x, offset=0):
    return torch.diagflat(x, offset=offset)


@op
def tril(x, diagonal=0):
    return torch.tril(x, diagonal=diagonal)


@op
def triu(x, diagonal=0):
    return torch.triu(x, diagonal=diagonal)


@op
def assign(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    from paddle_tpu_torch.core.tensor import _np_to_torch
    return _np_to_torch(x, None, _default_device())


@op
def meshgrid(xs):
    return tuple(torch.meshgrid(*xs, indexing="ij"))


@op
def tril_indices(row, col, offset=0):
    return torch.tril_indices(int(row), int(col), int(offset),
                              device=_default_device())


@op
def triu_indices(row, col, offset=0):
    return torch.triu_indices(int(row), int(col), int(offset),
                              device=_default_device())


@op
def complex(real, imag):
    dt = torch.promote_types(torch.promote_types(real.dtype, imag.dtype),
                             torch.float32)
    return torch.complex(real.to(dt), imag.to(dt))


@op
def polar(abs, angle):
    return torch.polar(abs, angle)


@op
def vander(x, n=None, increasing=False):
    """The Vandermonde matrix; integer inputs keep their dtype with exact
    integer powers."""
    cols = x.shape[0] if n is None else int(n)
    p = torch.arange(cols, dtype=x.dtype, device=x.device)
    if not increasing:
        p = p.flip(0)
    return torch.pow(x[:, None], p[None, :])
