"""Top-level namespace completion (port of ``paddle_tpu/compat_extra.py``,
the part over ported ops): module-level in-place variants, aliases,
dtype predicates, the random in-place fills and the Tensor methods the
reference binds from module functions. ``paddle_tpu_torch/__init__``
merges ``EXPORTS`` into the package namespace.

The in-place variants compute out of place and rebind the Tensor's data,
as the registry's do. The random fills take one key from the global
generator each, as the JAX package's do; ``uniform_`` and
``randint_like`` are bit-identical to it, the others share its uniforms
(:mod:`paddle_tpu_torch.ops.threefry`).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core import generator as gen
from paddle_tpu_torch.core.dtype import to_torch
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops import random_ops as _rand, threefry
from paddle_tpu_torch.ops.registry import API as _API, rebind_inplace

EXPORTS = {}


def _export(fn, name=None):
    EXPORTS[name or fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# module-level in-place variants: paddle.<op>_(x, ...) rebinds x to the
# out-of-place result
# ---------------------------------------------------------------------------
_INPLACE_BASES = [
    "abs", "acos", "asin", "atan", "atanh", "asinh", "acosh", "cast",
    "ceil", "clip", "cos", "cosh", "cumprod", "cumsum", "digamma",
    "divide", "equal", "erf", "erfinv", "exp", "expm1", "flatten",
    "floor", "floor_divide", "frac", "gcd", "greater_equal",
    "greater_than", "hypot", "i0", "index_add", "index_fill",
    "index_put", "lcm", "less_equal", "less_than", "lgamma", "log",
    "log10", "log1p", "log2", "logical_and", "logical_not",
    "logical_or", "logical_xor", "logit", "masked_fill",
    "masked_scatter", "multiply", "multigammaln", "nan_to_num", "neg",
    "not_equal", "polygamma", "pow", "put_along_axis", "reciprocal",
    "remainder", "renorm", "reshape", "round", "rsqrt", "scale",
    "scatter", "scatter_nd_add", "sign", "sin", "sinh", "sqrt",
    "square", "squeeze", "subtract", "tan", "tanh", "tril", "triu",
    "trunc", "unsqueeze", "add", "copysign", "gammainc",
    "gammaincc", "gammaln", "ldexp", "bitwise_and", "bitwise_not",
    "bitwise_or", "bitwise_xor", "lerp", "kron", "maximum", "minimum",
    "transpose", "addmm", "rad2deg", "deg2rad",
]


def _make_inplace(base):
    api = _API[base]

    def fn(x, *args, **kwargs):
        return rebind_inplace(x, api(x, *args, **kwargs))

    fn.__name__ = base + "_"
    fn.__doc__ = f"In-place variant of paddle.{base} (rebinds the data)."
    return fn


for _b in _INPLACE_BASES:
    if _b in _API:
        _f = _make_inplace(_b)
        EXPORTS[_b + "_"] = _f
        if not hasattr(Tensor, _b + "_"):
            setattr(Tensor, _b + "_", _f)

# paddle spells some in-place names differently from the base op
for _alias, _base in (("t_", "t"), ("mod_", "remainder"),
                      ("floor_mod_", "remainder"),
                      ("divide_", "divide")):
    if _base in _API:
        _f = _make_inplace(_base)
        _f.__name__ = _alias
        EXPORTS[_alias] = _f
        if not hasattr(Tensor, _alias):
            setattr(Tensor, _alias, _f)


# ---------------------------------------------------------------------------
# aliases and small utilities
# ---------------------------------------------------------------------------
for _alias, _base in (("mm", "matmul"), ("mod", "remainder"),
                      ("floor_mod", "remainder"), ("view", "reshape")):
    if _base in _API:
        EXPORTS[_alias] = _API[_base]


@_export
def where_(condition, x, y, name=None):
    """In-place where: rebinds ``x`` (the reference's in-place target),
    not the condition."""
    return rebind_inplace(x, _API["where"](condition, x, y))


@_export
def view_as(x, other):
    return _API["reshape"](x, list(other.shape))


@_export
def clone(x):
    return x.clone()


@_export
def rank(x):
    """A 0-d int32 tensor holding ``x``'s number of dimensions."""
    return Tensor._from_data(torch.tensor(x._data.dim(), dtype=torch.int32,
                                          device=x._data.device))


@_export
def shape(x):
    """An int32 tensor of ``x``'s dimensions."""
    return Tensor._from_data(torch.tensor(list(x._data.shape),
                                          dtype=torch.int32,
                                          device=x._data.device))


# ---------------------------------------------------------------------------
# dtype predicates (host bools)
# ---------------------------------------------------------------------------
@_export
def is_complex(x):
    return x._data.is_complex()


@_export
def is_floating_point(x):
    return x._data.is_floating_point()


@_export
def is_integer(x):
    d = x._data.dtype
    return not d.is_floating_point and not d.is_complex and \
        d != torch.bool


for _p in ("is_complex", "is_floating_point", "is_integer"):
    if not hasattr(Tensor, _p):
        setattr(Tensor, _p, EXPORTS[_p])


# ---------------------------------------------------------------------------
# random in-place fills, one key each
# ---------------------------------------------------------------------------
def _fill(x, sample):
    return x._rebind(sample.to(x._data.dtype))


@_export
def normal_(x, mean=0.0, std=1.0):
    d = x._data
    return _fill(x, mean + std * _rand.normal_bits(
        gen.active_key(), d.shape, device=d.device))


@_export
def cauchy_(x, loc=0, scale=1):
    d = x._data
    return _fill(x, loc + scale * _rand.cauchy_bits(
        gen.active_key(), d.shape, d.device))


@_export
def geometric_(x, probs):
    d = x._data
    u = threefry.uniform(gen.active_key(), d.shape, 1e-12, 1.0,
                         device=d.device)
    lp = torch.log1p(-torch.tensor(probs, dtype=torch.float32,
                                   device=d.device))
    return _fill(x, torch.ceil(torch.log(u) / lp))


@_export
def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    d = x._data
    return _fill(x, threefry.uniform(gen.active_key(), d.shape, min, max,
                                     device=d.device))


@_export
def exponential_(x, lam=1.0, name=None):
    d = x._data
    return _fill(x, _rand.exponential_bits(gen.active_key(), d.shape,
                                           device=d.device) / lam)


for _r in ("normal_", "cauchy_", "geometric_", "uniform_", "exponential_"):
    if not hasattr(Tensor, _r):
        setattr(Tensor, _r, EXPORTS[_r])


@_export
def randint_like(x, low=0, high=None, dtype=None):
    if high is None:
        low, high = 0, low
    d = x._data
    out = _rand.randint_bits(gen.active_key(), d.shape, low, high, d.device)
    return Tensor._from_data(out.to(to_torch(dtype) if dtype else d.dtype))


# ---------------------------------------------------------------------------
# Tensor methods the reference binds from module functions, for the names
# the port has
# ---------------------------------------------------------------------------
def _bind_tensor_methods():
    """Called by the package's ``__init__`` once its namespace is whole."""
    import paddle_tpu_torch as _p

    names = ["add_n", "atleast_1d", "atleast_2d", "atleast_3d",
             "broadcast_shape", "broadcast_tensors", "bucketize",
             "cdist", "cholesky_solve", "concat", "create_parameter",
             "create_tensor", "eig", "eigvals", "exponential_",
             "floor_mod", "histogramdd", "increment", "is_tensor",
             "istft", "lu_unpack", "mm", "multi_dot", "multiplex",
             "ormqr", "pca_lowrank", "polar", "rank", "reduce_as",
             "scatter_nd", "slice", "stack", "stft", "svd_lowrank",
             "tensordot", "top_p_sampling", "unfold", "uniform_",
             "vander", "view", "view_as", "where_"]
    for nm in names:
        fn = EXPORTS.get(nm) or _API.get(nm) or getattr(_p, nm, None)
        if fn is not None and not hasattr(Tensor, nm):
            setattr(Tensor, nm, fn)


__all__ = sorted(EXPORTS) + ["EXPORTS"]
