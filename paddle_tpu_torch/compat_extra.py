"""Top-level namespace completion (port of ``paddle_tpu/compat_extra.py``,
the part over ported ops): module-level in-place variants, aliases,
dtype predicates, the random in-place fills and the Tensor methods the
reference binds from module functions. ``paddle_tpu_torch/__init__``
merges ``EXPORTS`` into the package namespace.

The in-place variants compute out of place and rebind the Tensor's data,
as the registry's do. The random fills take one key from the global
generator each, as the JAX package's do; ``uniform_``, ``randint_like``
and ``top_p_sampling``'s categorical draw are bit-identical to it, the
others share its uniforms (:mod:`paddle_tpu_torch.ops.threefry`).

The linalg long tail computes on the tensors' device with torch.linalg
(``eig`` and ``eigvals`` too: the JAX package sends them to the host's
LAPACK); ``lu_unpack``'s permutation and ``ormqr``'s Q are built on the
host, as there. ``svd_lowrank`` and ``pca_lowrank`` are the exact
truncated SVD, as there.
"""
from __future__ import annotations

import numpy as np
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
# small utilities
# ---------------------------------------------------------------------------
def _dd(v):
    return v._data if isinstance(v, Tensor) else torch.as_tensor(v)


def _t(d):
    return Tensor._from_data(d, stop_gradient=not d.requires_grad)


@_export
def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """N-D histogram: (hist, [edges per dimension]), numpy's binning (the
    last bin closed), computed on the tensors' device."""
    xd = _dd(x)
    n, d = xd.shape
    nb = [int(bins)] * d if isinstance(bins, int) else [int(b) for b in bins]
    if ranges is None:
        lo, hi = xd.amin(0), xd.amax(0)
        rng = [(float(lo[i]), float(hi[i])) for i in range(d)]
    else:
        r = list(ranges)
        rng = [tuple(r[i]) if isinstance(r[i], (list, tuple))
               else (float(r[2 * i]), float(r[2 * i + 1]))
               for i in range(d)]
    edges, flat, inside = [], torch.zeros(n, dtype=torch.int64,
                                          device=xd.device), None
    for i in range(d):
        a, b = rng[i]
        if a == b:
            a, b = a - 0.5, b + 0.5
        e = torch.linspace(a, b, nb[i] + 1, dtype=torch.float32,
                           device=xd.device)
        edges.append(e)
        col = xd[:, i].to(torch.float32).contiguous()
        k = torch.searchsorted(e, col, right=True) - 1
        k = torch.where(col == e[-1], torch.full_like(k, nb[i] - 1), k)
        ok = (k >= 0) & (k < nb[i])
        inside = ok if inside is None else inside & ok
        flat = flat * nb[i] + torch.clamp(k, 0, nb[i] - 1)
    w = torch.ones(n, dtype=torch.float32, device=xd.device) \
        if weights is None else _dd(weights).to(torch.float32)
    w = torch.where(inside, w, torch.zeros_like(w))
    hist = torch.zeros(int(np.prod(nb)), dtype=torch.float32,
                       device=xd.device).index_add(0, flat, w)
    hist = hist.reshape(nb)
    if density:
        vol = torch.ones((), device=xd.device)
        for i, e in enumerate(edges):
            shape = [1] * d
            shape[i] = -1
            vol = vol * (e[1:] - e[:-1]).reshape(shape)
        hist = hist / hist.sum() / vol
    return _t(hist), [_t(e) for e in edges]


@_export
def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@_export
def increment(x, value=1.0):
    """x += value, rebinding the data."""
    return rebind_inplace(x, x + value)


@_export
def reduce_as(x, target):
    """Sum ``x`` down to ``target``'s shape."""
    xd = x._data
    td = _dd(target)
    lead = xd.dim() - td.dim()
    axes = list(range(lead))
    for i, (a, b) in enumerate(zip(xd.shape[lead:], td.shape)):
        if b == 1 and a != 1:
            axes.append(lead + i)
    out = xd.sum(dim=tuple(axes)) if axes else xd
    return _t(out.reshape(td.shape))


@_export
def batch(reader, batch_size, drop_last=False):
    """The legacy reader batcher."""

    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


@_export
def check_shape(x, expected_shape):
    got = tuple(x.shape)
    exp = tuple(expected_shape)
    if len(got) != len(exp) or any(
            e not in (-1, None) and g != e for g, e in zip(got, exp)):
        raise ValueError(f"shape mismatch: got {got}, expected {exp}")
    return True


@_export
def disable_signal_handler():
    """No-op: there are no native signal handlers to disable."""


@_export
def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Forwarded to numpy's printoptions (a Tensor prints through
    numpy)."""
    kw = {}
    if precision is not None:
        kw["precision"] = int(precision)
    if threshold is not None:
        kw["threshold"] = int(threshold)
    if edgeitems is not None:
        kw["edgeitems"] = int(edgeitems)
    if linewidth is not None:
        kw["linewidth"] = int(linewidth)
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


class LazyGuard:
    """No-op context manager: parameters are created eagerly."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


EXPORTS["LazyGuard"] = LazyGuard


@_export
def bitwise_left_shift(x, y, is_arithmetic=True, out=None, name=None):
    return _t(torch.bitwise_left_shift(_dd(x), _dd(y)))


_UNSIGNED = {torch.int8: torch.uint8, torch.int16: torch.uint16,
             torch.int32: torch.uint32, torch.int64: torch.uint64}


@_export
def bitwise_right_shift(x, y, is_arithmetic=True, out=None, name=None):
    """Arithmetic (sign-propagating) shift by default; the logical shift
    reinterprets the bits as unsigned."""
    xd, yd = _dd(x), _dd(y)
    if is_arithmetic or xd.dtype not in _UNSIGNED:
        return _t(torch.bitwise_right_shift(xd, yd))
    # torch has no shift of the wide unsigned types: shift in int64 with
    # the sign bits masked off
    nbits = torch.iinfo(xd.dtype).bits
    mask = (1 << nbits) - 1
    wide = xd.to(torch.int64) & mask if nbits < 64 else xd
    sh = yd.to(torch.int64)
    if nbits < 64:
        res = torch.bitwise_right_shift(wide, sh)
    else:
        # a 64-bit logical shift: arithmetic shift, then clear the
        # copies of the sign bit
        ar = torch.bitwise_right_shift(wide, sh)
        keep = torch.where(sh > 0, (torch.ones_like(sh) << (64 - sh)) - 1,
                           torch.full_like(sh, -1))
        res = ar & keep
    if nbits < 64:
        res = torch.where(res >= (1 << (nbits - 1)), res - (1 << nbits), res)
    return _t(res.to(xd.dtype))


for _nm in ("bitwise_left_shift", "bitwise_right_shift"):
    def _mk(fname, base):
        def fn(x, *a, **k):
            return rebind_inplace(x, base(x, *a, **k))

        fn.__name__ = fname
        return fn

    EXPORTS[_nm + "_"] = _mk(_nm + "_", EXPORTS[_nm])
    if not hasattr(Tensor, _nm):
        setattr(Tensor, _nm, EXPORTS[_nm])
        setattr(Tensor, _nm + "_", EXPORTS[_nm + "_"])


@_export
def create_parameter(shape, dtype=None, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A standalone Parameter from ``default_initializer``, ``attr``'s
    initializer, or the global one (Constant(0) for a bias, XavierUniform
    for a weight)."""
    from paddle_tpu_torch.core.dtype import convert_dtype, get_default_dtype
    from paddle_tpu_torch.nn import initializer as init
    from paddle_tpu_torch.nn.layer import Parameter

    dt = convert_dtype(dtype) if dtype else get_default_dtype()
    gi = getattr(init, "_GLOBAL_INITIALIZER", {})
    ini = default_initializer or getattr(attr, "initializer", None) or (
        (gi.get("bias") or init.Constant(0.0)) if is_bias
        else (gi.get("weight") or init.XavierUniform()))
    return Parameter(ini([int(s) for s in shape], dt))


@_export
def create_tensor(dtype, name=None, persistable=False):
    """An empty named tensor."""
    from paddle_tpu_torch.core.place import _default_device

    t = Tensor._from_data(torch.zeros((0,), dtype=to_torch(dtype),
                                      device=_default_device()), name=name)
    t.persistable = persistable
    return t


# ---------------------------------------------------------------------------
# linalg long tail
# ---------------------------------------------------------------------------
@_export
def cholesky_solve(x, y, upper=False, name=None):
    """Solve A X = B with B = ``x`` and ``y`` the Cholesky factor of A."""
    return _t(torch.cholesky_solve(_dd(x), _dd(y), upper=upper))


def _eig_out(d):
    """complex64 / float32, as the JAX package's host results are."""
    if d.dtype == torch.complex128:
        return d.to(torch.complex64)
    if d.dtype == torch.float64:
        return d.to(torch.float32)
    return d


@_export
def eig(x, name=None):
    w, v = torch.linalg.eig(_dd(x))
    return _t(_eig_out(w)), _t(_eig_out(v))


@_export
def eigvals(x, name=None):
    return _t(_eig_out(torch.linalg.eigvals(_dd(x))))


@_export
def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True,
              name=None):
    """(P, L, U) from a packed LU factorization, batched; pivots 1-based
    as LAPACK gives them. Outputs not asked for are None."""
    lu = _dd(lu_data)
    m, n = lu.shape[-2], lu.shape[-1]
    k = min(m, n)
    L = U = P = None
    if unpack_ludata:
        L = torch.tril(lu[..., :, :k], -1) + torch.eye(
            m, k, dtype=lu.dtype, device=lu.device)
        U = torch.triu(lu[..., :k, :])
        L, U = _t(L), _t(U)
    if unpack_pivots:
        piv = _dd(lu_pivots).detach().cpu().numpy().astype(np.int64)
        piv = piv.reshape(-1, piv.shape[-1])
        Ps = np.zeros((piv.shape[0], m, m), np.float64)
        for b in range(piv.shape[0]):
            perm = np.arange(m)
            for i, pv in enumerate(piv[b][:k]):
                j = int(pv) - 1
                perm[[i, j]] = perm[[j, i]]
            Ps[b][perm, np.arange(m)] = 1.0
        P = torch.from_numpy(Ps.reshape(tuple(lu.shape[:-2]) + (m, m)))
        P = _t(P.to(dtype=lu.dtype, device=lu.device))
    return P, L, U


@_export
def ormqr(x, tau, y, left=True, transpose=False, name=None):
    """y multiplied by the full m x m Q of a geqrf factorization, Q built
    from the reflectors H_i = I - tau_i v_i v_i^T in float64 on the host."""
    a = _dd(x).detach().cpu().double().numpy()
    t = _dd(tau).detach().cpu().double().numpy().reshape(-1)
    m = a.shape[0]
    q = np.eye(m)
    for i, ti in enumerate(t):
        v = np.zeros(m)
        v[i] = 1.0
        v[i + 1:] = a[i + 1:, i]
        q = q @ (np.eye(m) - ti * np.outer(v, v))
    if transpose:
        q = q.T
    yd = _dd(y)
    b = yd.detach().cpu().double().numpy()
    out = q @ b if left else b @ q
    return _t(torch.from_numpy(out).to(dtype=yd.dtype, device=yd.device))


def _truncated_svd(d, k):
    u, s, vh = torch.linalg.svd(d, full_matrices=False)
    return (_t(u[..., :, :k]), _t(s[..., :k]),
            _t(vh.transpose(-1, -2)[..., :, :k]))


@_export
def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """The rank-q truncated SVD (exact: the randomized iteration is a
    memory saving)."""
    d = _dd(x)
    if M is not None:
        d = d - _dd(M)
    return _truncated_svd(d, int(q))


@_export
def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    d = _dd(x)
    k = int(q) if q is not None else min(6, *d.shape[-2:])
    if center:
        d = d - d.mean(dim=-2, keepdim=True)
    return _truncated_svd(d, k)


@_export
def top_p_sampling(x, ps, threshold=None, topp_seed=None, seed=-1,
                   k=0, mode="truncated", return_top=False, name=None):
    """Nucleus (top-p) sampling over the last axis: the smallest prefix of
    the sorted probabilities whose mass reaches ``ps``, renormalized, one
    categorical draw (the generator's key, or ``seed``'s when >= 0).
    Returns (values, ids); the ids are int64."""
    probs = _dd(x)
    p_lim = _dd(ps).reshape(-1, 1).to(probs.dtype)
    # jnp.sort then [::-1]: descending, ties in reversed index order
    sort_p = torch.sort(probs, dim=-1, stable=True)[0].flip(-1)
    sort_i = torch.argsort(probs, dim=-1, stable=True).flip(-1)
    csum = torch.cumsum(sort_p, dim=-1)
    keep = csum - sort_p < p_lim
    if threshold is not None:
        thr = _dd(threshold).reshape(-1, 1).to(probs.dtype)
        keep = keep & (sort_p >= thr)
        keep[..., 0] = True
    masked = torch.where(keep, sort_p, torch.zeros_like(sort_p))
    masked = masked / torch.clamp(masked.sum(-1, keepdim=True), min=1e-9)
    key = gen.active_key() if seed is None or int(seed) < 0 else \
        threefry.key(int(seed))
    g = threefry.categorical(key, torch.log(torch.clamp(masked, min=1e-9)),
                             axis=-1)
    ids = torch.gather(sort_i, -1, g[..., None])
    vals = torch.gather(probs, -1, ids)
    return _t(vals), _t(ids)


# stft / istft at the top level (implementations in signal)
def _stft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, pad_mode="reflect", normalized=False,
          onesided=True, name=None):
    from paddle_tpu_torch import signal

    return signal.stft(x, n_fft, hop_length=hop_length,
                       win_length=win_length, window=window,
                       center=center, pad_mode=pad_mode,
                       normalized=normalized, onesided=onesided)


def _istft(x, n_fft, hop_length=None, win_length=None, window=None,
           center=True, normalized=False, onesided=True, length=None,
           return_complex=False, name=None):
    from paddle_tpu_torch import signal

    return signal.istft(x, n_fft, hop_length=hop_length,
                        win_length=win_length, window=window,
                        center=center, normalized=normalized,
                        onesided=onesided, length=length,
                        return_complex=return_complex)


EXPORTS["stft"] = _stft
EXPORTS["istft"] = _istft


# ---------------------------------------------------------------------------
# Tensor methods the reference binds from module functions
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
