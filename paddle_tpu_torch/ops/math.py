"""Elementwise and reduction emitters (port of ``paddle_tpu/ops/math.py``).

Each is a torch function on raw tensors computing what the jnp emitter
computes, in the same dtype. Where torch and jnp (without x64) promote
differently, the emitter says which it follows:

* reductions of int32 (``sum``, ``prod``, ``cumsum``, ``nansum``,
  ``trace``) stay int32, as in jnp; other integers and bools sum to int64,
  the port's default integer (jnp's is int32);
* ``mean``, ``var``, ``std``, ``median``, ``quantile`` and ``nanmean`` of
  an integer tensor are float32, as in jnp;
* ``median`` is the mean of the two middle values for an even count
  (jnp's), not torch's lower middle;
* index results (``argmax``, ``argmin``, ``count_nonzero``) are int64.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.dtype import to_torch
from paddle_tpu_torch.ops.registry import register_emitter as op


def as_operand(v, dtype=None, device=None):
    """``v`` as a tensor on ``device``: a Python scalar by a fill on the
    device (no host-to-device copy), in ``dtype`` or the dtype
    ``torch.as_tensor`` would give it; anything else through
    ``torch.as_tensor``."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (bool, int, float, complex)):
        if dtype is None:
            dtype = (torch.bool if isinstance(v, bool) else
                     torch.int64 if isinstance(v, int) else
                     torch.complex64 if isinstance(v, complex) else
                     torch.get_default_dtype())
        return torch.full((), v, dtype=dtype, device=device)
    return torch.as_tensor(v, dtype=dtype, device=device)


def _t(v, like):
    """A Python scalar operand as a 0-d tensor on ``like``'s device (a 0-d
    tensor promotes like jnp's weakly typed scalar)."""
    return as_operand(v, device=like.device if isinstance(
        like, torch.Tensor) else None)


def _pair(x, y):
    if not isinstance(x, torch.Tensor):
        x = _t(x, y)
    return x, y


class _Flat(torch.autograd.Function):
    """``value`` with a zero gradient to ``inputs``: the derivative jnp
    gives a piecewise-constant op, where torch defines none."""

    @staticmethod
    def forward(ctx, value, *inputs):
        ctx.metas = [(i.shape, i.dtype) for i in inputs]
        return value

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(torch.zeros(s, dtype=d, device=g.device)
                               for s, d in ctx.metas)


def _flat(value, *inputs):
    ins = [i for i in inputs if isinstance(i, torch.Tensor)]
    if value.is_floating_point() and any(i.requires_grad for i in ins):
        return _Flat.apply(value.detach(), *ins)
    return value


# ---------------------------------------------------------------------------
# binary elementwise
# ---------------------------------------------------------------------------
@op
def add(x, y):
    return torch.add(*_pair(x, y))


@op
def subtract(x, y):
    return torch.subtract(*_pair(x, y))


@op
def multiply(x, y):
    return torch.multiply(*_pair(x, y))


@op
def divide(x, y):
    return torch.true_divide(*_pair(x, y))


@op
def floor_divide(x, y):
    x, y = _pair(x, y)
    return _flat(torch.floor_divide(x.detach(), _detach(y)), x, y)


def _detach(v):
    return v.detach() if isinstance(v, torch.Tensor) else v


@op
def remainder(x, y):
    return torch.remainder(*_pair(x, y))


@op
def elementwise_pow(x, y):
    return torch.pow(*_pair(x, y))


@op
def pow(x, y):
    return torch.pow(*_pair(x, y))


@op
def maximum(x, y):
    return torch.maximum(*_both(x, y))


@op
def minimum(x, y):
    return torch.minimum(*_both(x, y))


@op
def fmax(x, y):
    return torch.fmax(*_both(x, y))


@op
def fmin(x, y):
    return torch.fmin(*_both(x, y))


@op
def atan2(x, y):
    return torch.atan2(*_both(x, y))


@op
def hypot(x, y):
    x, y = _both(x, y)
    dt = torch.result_type(x, y)
    return torch.hypot(x.to(dt), y.to(dt))


@op
def logaddexp(x, y):
    return torch.logaddexp(*_both(x, y))


@op
def heaviside(x, y):
    x, y = _both(x, y)
    dt = torch.result_type(x, y)
    x, y = x.to(dt), y.to(dt)
    # jnp's where(x < 0, 0, where(x > 0, 1, y)): the gradient reaches y
    return torch.where(x < 0, torch.zeros((), dtype=dt, device=x.device),
                       torch.where(x > 0, torch.ones((), dtype=dt,
                                                     device=x.device), y))


@op
def gcd(x, y):
    return torch.gcd(*_both(x, y))


@op
def lcm(x, y):
    return torch.lcm(*_both(x, y))


@op
def inner(x, y):
    return torch.inner(x, y)


@op
def outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@op
def kron(x, y):
    return torch.kron(x, y)


def _both(x, y):
    """Both operands as tensors (torch's binary functions that take no
    Python scalar)."""
    if not isinstance(y, torch.Tensor):
        y = _scalar_like(y, x)
    if not isinstance(x, torch.Tensor):
        x = _scalar_like(x, y)
    return x, y


def _scalar_like(v, like):
    """A Python scalar as a 0-d tensor that promotes as jnp's weak type:
    the other operand's dtype where the kinds agree."""
    if isinstance(v, bool):
        dt = torch.bool
    elif isinstance(v, int) and not like.is_floating_point():
        dt = like.dtype if like.dtype != torch.bool else torch.int64
    elif isinstance(v, (int, float)) and like.is_floating_point():
        dt = like.dtype
    else:
        dt = None
    return as_operand(v, dt, like.device)


# ---------------------------------------------------------------------------
# unary elementwise
# ---------------------------------------------------------------------------
@op
def exp(x):
    return torch.exp(x)


@op
def expm1(x):
    return torch.expm1(x)


@op
def log(x):
    return torch.log(x)


@op
def log2(x):
    return torch.log2(x)


@op
def log10(x):
    return torch.log10(x)


@op
def log1p(x):
    return torch.log1p(x)


@op
def sqrt(x):
    return torch.sqrt(x)


@op
def rsqrt(x):
    return torch.rsqrt(x)


@op
def abs(x):
    return torch.abs(x)


@op
def neg(x):
    return torch.neg(x)


@op
def sign(x):
    return torch.sgn(x) if x.is_complex() else torch.sign(x)


@op
def floor(x):
    return torch.floor(x)


@op
def ceil(x):
    return torch.ceil(x)


@op
def round(x):
    return torch.round(x)


@op
def trunc(x):
    return torch.trunc(x)


@op
def frac(x):
    return x - torch.trunc(x)


@op
def sin(x):
    return torch.sin(x)


@op
def cos(x):
    return torch.cos(x)


@op
def tan(x):
    return torch.tan(x)


@op
def asin(x):
    return torch.asin(x)


@op
def acos(x):
    return torch.acos(x)


@op
def atan(x):
    return torch.atan(x)


@op
def sinh(x):
    return torch.sinh(x)


@op
def cosh(x):
    return torch.cosh(x)


@op
def tanh(x):
    return torch.tanh(x)


@op
def asinh(x):
    return torch.asinh(x)


@op
def acosh(x):
    return torch.acosh(x)


@op
def atanh(x):
    return torch.atanh(x)


@op
def erf(x):
    return torch.erf(x)


@op
def erfinv(x):
    return torch.erfinv(x)


@op
def digamma(x):
    return torch.digamma(x)


@op
def lgamma(x):
    return torch.lgamma(x)


@op
def reciprocal(x):
    return torch.reciprocal(x)


@op
def square(x):
    return torch.square(x)


@op
def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@op
def clip(x, min=None, max=None):
    if isinstance(min, torch.Tensor) or isinstance(max, torch.Tensor):
        out = x
        if min is not None:
            out = torch.maximum(out, _t(min, x))
        if max is not None:
            out = torch.minimum(out, _t(max, x))
        return out
    if min is None and max is None:
        return x.clone()
    return torch.clamp(x, min, max)


@op
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    """Reference: paddle.scale (python/paddle/tensor/math.py scale)."""
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


@op
def lerp(x, y, weight):
    return x + weight * (y - x)


@op
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@op
def isnan(x):
    return torch.isnan(x)


@op
def isinf(x):
    return torch.isinf(x)


@op
def isfinite(x):
    return torch.isfinite(x)


@op
def angle(x):
    if not (x.is_floating_point() or x.is_complex()):
        x = x.float()
    return torch.angle(x)


@op
def conj(x):
    return x.conj_physical() if x.is_complex() else x.clone()


@op
def real(x):
    return torch.real(x) if x.is_complex() else x.clone()


@op
def imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


@op
def trace(x, offset=0, axis1=0, axis2=1):
    d = torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2)
    return d.sum(-1, dtype=_sum_dtype(x))


@op
def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _dims(x, axis):
    """``axis`` (None, int or a sequence) as a tuple of dims; None -> all."""
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _sum_dtype(x):
    """int32 sums stay int32 (jnp without x64); the rest as torch does."""
    return torch.int32 if x.dtype == torch.int32 else None


def _float(x):
    return x if (x.is_floating_point() or x.is_complex()) else x.float()


@op(name="sum")
def sum_(x, axis=None, dtype=None, keepdim=False):
    dims = _dims(x, axis)
    if x.dtype == torch.bool:
        x = x.long()
    out = torch.sum(x, dim=dims, keepdim=keepdim, dtype=_sum_dtype(x)) \
        if dims else x.clone()
    if dtype is not None:
        out = out.to(to_torch(dtype))
    return out


@op
def mean(x, axis=None, keepdim=False):
    x = _float(x)
    dims = _dims(x, axis)
    return torch.mean(x, dim=dims, keepdim=keepdim) if dims else x.clone()


@op(name="max")
def max_(x, axis=None, keepdim=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


@op(name="min")
def min_(x, axis=None, keepdim=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


@op
def amax(x, axis=None, keepdim=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


@op
def amin(x, axis=None, keepdim=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


@op
def prod(x, axis=None, keepdim=False, dtype=None):
    dt = to_torch(dtype) if dtype is not None else _sum_dtype(x)
    if dt is not None:
        x = x.to(dt)
    out = x
    for d in sorted((d % max(x.dim(), 1) for d in _dims(x, axis)),
                    reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim, dtype=dt)
    return out if out is not x else x.clone()


def _all_dims(fn, x, axis, keepdim):
    dims = _dims(x, axis)
    x = x.bool()
    return fn(x, dim=dims, keepdim=keepdim) if dims else x.clone()


@op(name="all")
def all_(x, axis=None, keepdim=False):
    return _all_dims(torch.all, x, axis, keepdim)


@op(name="any")
def any_(x, axis=None, keepdim=False):
    return _all_dims(torch.any, x, axis, keepdim)


@op
def logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(_float(x), dim=_dims(x, axis), keepdim=keepdim)


@op
def cumsum(x, axis=None, dtype=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    dt = to_torch(dtype) if dtype is not None else _sum_dtype(x)
    return torch.cumsum(x, dim=axis, dtype=dt)


@op
def cumprod(x, dim=None, dtype=None):
    if dim is None:
        x = x.reshape(-1)
        dim = 0
    dt = to_torch(dtype) if dtype is not None else _sum_dtype(x)
    return torch.cumprod(x, dim=dim, dtype=dt)


@op
def cummax(x, axis=0):
    return torch.cummax(x, dim=axis).values


@op
def cummin(x, axis=0):
    return torch.cummin(x, dim=axis).values


@op
def argmax(x, axis=None, keepdim=False, dtype="int64"):
    out = torch.argmax(x, dim=axis,
                       keepdim=keepdim if axis is not None else False)
    return out.to(to_torch(dtype))


@op
def argmin(x, axis=None, keepdim=False, dtype="int64"):
    out = torch.argmin(x, dim=axis,
                       keepdim=keepdim if axis is not None else False)
    return out.to(to_torch(dtype))


@op
def var(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(_float(x), dim=_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@op
def std(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(_float(x), dim=_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _quantile(x, q, axis, keepdim):
    """jnp.quantile (linear interpolation) over ``axis`` (None = all,
    or several axes) through torch.quantile over one flattened dim."""
    x = _float(x)
    nd = x.dim()
    dims = sorted(d % max(nd, 1) for d in _dims(x, axis)) if nd else []
    rest = [d for d in range(nd) if d not in dims]
    xm = x.permute(*rest, *dims).reshape(
        *[x.shape[d] for d in rest], -1)
    scalar_q = not isinstance(q, (list, tuple, torch.Tensor)) or (
        isinstance(q, torch.Tensor) and q.dim() == 0)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    out = torch.quantile(xm, qt, dim=-1)
    if keepdim:
        shape = list(x.shape)
        for d in dims:
            shape[d] = 1
        lead = [] if scalar_q else [qt.numel()]
        out = out.reshape(*lead, *shape)
    return out


@op
def median(x, axis=None, keepdim=False):
    return _quantile(x, 0.5, axis, keepdim)


@op
def quantile(x, q, axis=None, keepdim=False):
    return _quantile(x, q, axis, keepdim)


@op
def nanmean(x, axis=None, keepdim=False):
    return torch.nanmean(_float(x), dim=_dims(x, axis), keepdim=keepdim)


@op
def nansum(x, axis=None, dtype=None, keepdim=False):
    dt = to_torch(dtype) if dtype is not None else _sum_dtype(x)
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim, dtype=dt)


@op
def count_nonzero(x, axis=None, keepdim=False):
    dims = _dims(x, axis)
    out = torch.count_nonzero(x, dim=dims)
    if keepdim:
        for d in sorted(d % max(x.dim(), 1) for d in dims):
            out = out.unsqueeze(d)
    return out
