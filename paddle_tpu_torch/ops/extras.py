"""Long-tail tensor-op emitters (port of ``paddle_tpu/ops/extras.py``, the
manifest's "long-tail surface" section): the stack and split family,
special math, the indexed scatter family, predicates, complex views and
two draws.

Each is a torch function on raw tensors; autograd is torch's. Where torch
has the function with jnp's semantics it is called; elsewhere the jnp
formula is written out (``cdist``'s matmul form, ``nanmedian``'s midpoint,
``kthvalue``'s stable sort, ``mode``'s count ties, ``crop``'s clamped
start). Index results are int64 (the port's index type; jnp's are int32).

``gammainc`` and ``gammaincc`` carry their derivative in the shape
parameter (torch has none): a central difference in float64, as good as
jax's series to about 1e-9 relative. ``binomial`` and ``standard_gamma``
draw from the global generator's keys with ``jax.random``'s algorithms
(inversion and BTRS for the binomial, Marsaglia-Tsang for the gamma), and
are held to its distribution, not its bits.
"""
from __future__ import annotations

import itertools
import math

import torch

from paddle_tpu_torch.core import generator as gen
from paddle_tpu_torch.ops import threefry
from paddle_tpu_torch.ops.random_ops import normal_bits
from paddle_tpu_torch.ops.registry import register_emitter as op


def _np_split(x, num_or_indices, axis):
    """``jnp.split``: a count of equal parts, or the split points."""
    n = x.shape[axis]
    if isinstance(num_or_indices, int):
        if n % num_or_indices:
            raise ValueError(f"array split does not result in an equal "
                             f"division: {n} into {num_or_indices}")
        return tuple(torch.split(x, n // num_or_indices, dim=axis))
    pts = [0] + [int(i) % (n + 1) if int(i) < 0 else min(int(i), n)
                 for i in num_or_indices] + [n]
    return tuple(x.narrow(axis, a, max(b - a, 0))
                 for a, b in zip(pts[:-1], pts[1:]))


# ---------------------------------------------------------------------------
# stack / split family
# ---------------------------------------------------------------------------
@op
def hstack(x):
    return torch.hstack(list(x))


@op
def vstack(x):
    return torch.vstack(list(x))


@op
def dstack(x):
    return torch.dstack(list(x))


@op
def column_stack(x):
    return torch.column_stack(list(x))


@op
def row_stack(x):
    return torch.vstack(list(x))


@op
def hsplit(x, num_or_indices):
    return _np_split(x, num_or_indices, 1 if x.dim() > 1 else 0)


@op
def vsplit(x, num_or_indices):
    return _np_split(x, num_or_indices, 0)


@op
def dsplit(x, num_or_indices):
    return _np_split(x, num_or_indices, 2)


@op
def tensor_split(x, num_or_indices, axis=0):
    if isinstance(num_or_indices, int):
        # jnp.array_split: the first n % k parts one longer
        return tuple(torch.tensor_split(x, num_or_indices, dim=axis))
    return _np_split(x, list(num_or_indices), axis)


@op
def unstack(x, axis=0, num=None):
    n = num if num is not None else x.shape[axis]
    return tuple(s.squeeze(axis) for s in _np_split(x, n, axis))


@op
def unflatten(x, axis, shape):
    axis = axis % x.dim()
    new = (list(x.shape[:axis]) + [int(s) for s in shape]
           + list(x.shape[axis + 1:]))
    return torch.reshape(x, new)


# ---------------------------------------------------------------------------
# math long tail
# ---------------------------------------------------------------------------
@op
def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.matmul(x, y)


@op
def copysign(x, y):
    return torch.copysign(x, y)


@op
def ldexp(x, y):
    out_dt = torch.promote_types(x.dtype, torch.float32)
    return (x * torch.exp2(y.to(torch.float32))).to(out_dt)


@op
def nextafter(x, y):
    return torch.nextafter(x, y.to(x.dtype))


@op
def frexp(x):
    m, e = torch.frexp(x)
    return m, e.to(torch.int32)


@op
def sgn(x):
    """sign for real; the unit phasor for complex."""
    if x.is_complex():
        mag = torch.abs(x)
        safe = torch.where(mag == 0, torch.ones_like(mag), mag)
        return torch.where(mag == 0, torch.zeros_like(x), x / safe)
    return torch.sign(x)


@op
def signbit(x):
    return torch.signbit(x)


@op
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@op
def logcumsumexp(x, axis=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return torch.logcumsumexp(x, dim=axis)


@op
def trapezoid(y, x=None, dx=None, axis=-1):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


@op
def cumulative_trapezoid(y, x=None, dx=None, axis=-1):
    axis = axis % y.dim()
    ym = torch.movedim(y, axis, -1)
    avg = (ym[..., 1:] + ym[..., :-1]) / 2.0
    if x is not None:
        xm = torch.movedim(torch.broadcast_to(x, y.shape), axis, -1) \
            if x.dim() == y.dim() else x
        d = xm[..., 1:] - xm[..., :-1]
    else:
        d = 1.0 if dx is None else dx
    return torch.movedim(torch.cumsum(avg * d, dim=-1), -1, axis)


@op
def gammaln(x):
    return torch.special.gammaln(x)


class _GammaInc(torch.autograd.Function):
    """P(a, x) with both derivatives: in ``x`` the density, in ``a`` a
    central difference in float64."""

    @staticmethod
    def forward(ctx, a, x, upper):
        ctx.save_for_backward(a, x)
        ctx.upper = upper
        fn = torch.special.gammaincc if upper else torch.special.gammainc
        return fn(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        sign = -1.0 if ctx.upper else 1.0
        ga = gx = None
        if ctx.needs_input_grad[0]:
            a64, x64 = a.double(), x.double()
            h = 1e-5 * torch.clamp(a64.abs(), min=1.0)
            d = (torch.special.gammainc(a64 + h, x64)
                 - torch.special.gammainc(a64 - h, x64)) / (2 * h)
            ga = _unbroadcast(g * (sign * d).to(g.dtype), a.shape)
        if ctx.needs_input_grad[1]:
            dens = torch.exp((a - 1) * torch.log(x) - x
                             - torch.special.gammaln(a))
            dens = torch.where(x > 0, dens, torch.zeros_like(dens))
            gx = _unbroadcast(g * sign * dens, x.shape)
        return ga, gx, None


def _unbroadcast(g, shape):
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, s in enumerate(shape):
        if s == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


@op
def gammainc(x, y):
    """The regularized lower incomplete gamma P(x, y) (jax's argument
    order: ``x`` the shape, ``y`` the point)."""
    return _GammaInc.apply(x, y, False)


@op
def gammaincc(x, y):
    return _GammaInc.apply(x, y, True)


@op
def multigammaln(x, p):
    return torch.special.multigammaln(x, int(p))


@op
def polygamma(x, n):
    return torch.special.polygamma(int(n), x)


@op
def i0(x):
    return torch.special.i0(x)


@op
def i0e(x):
    return torch.special.i0e(x)


@op
def i1(x):
    return torch.special.i1(x)


@op
def i1e(x):
    return torch.special.i1e(x)


@op
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary"):
    """Pairwise distances between row batches: x [..., M, D], y [..., N, D]
    -> [..., M, N]; p = 2 through one matmul (x2 + y2 - 2xy), unless
    ``compute_mode`` forbids it."""
    if p == 2.0 and compute_mode != "donot_use_mm_for_euclid_dist":
        x2 = torch.sum(x * x, dim=-1)[..., :, None]
        y2 = torch.sum(y * y, dim=-1)[..., None, :]
        d2 = x2 + y2 - 2.0 * torch.matmul(x, y.transpose(-1, -2))
        return torch.sqrt(torch.clamp(d2, min=0.0))
    diff = x[..., :, None, :] - y[..., None, :, :]
    if p == 2.0:
        return torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1),
                                      min=0.0))
    if p == 0.0:
        return torch.sum((diff != 0).to(x.dtype), dim=-1)
    if math.isinf(p):
        return torch.amax(torch.abs(diff), dim=-1)
    return torch.sum(torch.abs(diff) ** p, dim=-1) ** (1.0 / p)


@op
def pdist(x, p=2.0):
    """Condensed pairwise distances of one row set."""
    n = x.shape[0]
    full = cdist(x, x, p=p)
    iu = torch.triu_indices(n, n, offset=1, device=x.device)
    return full[iu[0], iu[1]]


def _moved_flat(x, axis):
    """x with ``axis`` (an int, a sequence or None) flattened into one last
    dimension; the shape of the rest, and the kept-dims shape."""
    if axis is None:
        axes = list(range(x.dim()))
    elif isinstance(axis, (list, tuple)):
        axes = [a % x.dim() for a in axis]
    else:
        axes = [axis % x.dim()]
    rest = [i for i in range(x.dim()) if i not in axes]
    xm = x.permute(rest + axes)
    lead = [x.shape[i] for i in rest]
    keep = [1 if i in axes else x.shape[i] for i in range(x.dim())]
    return xm.reshape(lead + [-1]), lead, keep


@op
def nanmedian(x, axis=None, keepdim=False, mode="avg"):
    """jnp.nanmedian: the midpoint of the two middle non-NaN values."""
    xf, lead, keep = _moved_flat(x, axis)
    s, _ = torch.sort(xf, dim=-1)          # NaNs sort last
    cnt = (~torch.isnan(xf)).sum(-1, keepdim=True)
    lo = torch.clamp((cnt - 1) // 2, min=0)
    hi = torch.clamp(cnt // 2, min=0)
    med = (torch.gather(s, -1, lo) + torch.gather(s, -1, hi)) / 2
    med = torch.where(cnt == 0, torch.full_like(med, float("nan")), med)
    med = med.reshape(keep if keepdim else lead)
    return med.to(x.dtype)


@op
def nanquantile(x, q, axis=None, keepdim=False):
    x = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    xf, lead, keep = _moved_flat(x, axis)
    qs = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    out = torch.nanquantile(xf, qs, dim=-1, keepdim=False)
    shape = keep if keepdim else lead
    return out.reshape(list(qs.shape) + shape)


@op
def renorm(x, p, axis, max_norm):
    """Per-slice norm clip along ``axis``."""
    axis = axis % x.dim()
    other = tuple(i for i in range(x.dim()) if i != axis)
    norms = torch.sum(torch.abs(x) ** p, dim=other, keepdim=True) \
        ** (1.0 / p)
    factor = torch.where(norms > max_norm,
                         max_norm / torch.clamp(norms, min=1e-12),
                         torch.ones_like(norms))
    return x * factor


@op
def multiplex(inputs, index):
    """out[i] = inputs[index[i]][i]."""
    stacked = torch.stack(list(inputs))
    idx = index.reshape(-1).long()
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


@op
def tensordot(x, y, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    return torch.tensordot(x, y, dims=axes)


@op
def combinations(x, r=2, with_replacement=False):
    n = x.shape[0]
    gen_ = itertools.combinations_with_replacement(range(n), r) \
        if with_replacement else itertools.combinations(range(n), r)
    idx = torch.tensor(list(gen_), dtype=torch.int64,
                       device=x.device).reshape(-1, r)
    return x[idx]


# ---------------------------------------------------------------------------
# predicates
# ---------------------------------------------------------------------------
@op
def isneginf(x):
    return torch.isneginf(x)


@op
def isposinf(x):
    return torch.isposinf(x)


@op
def isreal(x):
    return torch.isreal(x)


@op
def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


# ---------------------------------------------------------------------------
# indexed scatter family
# ---------------------------------------------------------------------------
@op
def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset=int(offset), dim1=dim1, dim2=dim2)


@op
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1):
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    return torch.diagonal_scatter(x, y, offset=int(offset), dim1=axis1,
                                  dim2=axis2)


@op
def select_scatter(x, y, axis, index):
    axis = axis % x.dim()
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    return torch.select_scatter(x, y.expand(x.select(axis, 0).shape),
                                axis, int(index))


def _slices(nd, axes, starts, ends, strides=None):
    idx = [slice(None)] * nd
    strides = strides if strides is not None else [1] * len(axes)
    for a, s, e, st in zip(axes, starts, ends, strides):
        idx[int(a)] = slice(int(s), int(e), int(st))
    return idx


@op
def slice_scatter(x, value, axes, starts, ends, strides):
    out = x.clone()
    idx = _slices(x.dim(), axes, starts, ends, strides)
    out[tuple(idx)] = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return out


@op
def index_fill(x, index, axis, value):
    axis = axis % x.dim()
    xm = torch.movedim(x, axis, 0).clone()
    xm[index.long()] = torch.as_tensor(value, dtype=x.dtype,
                                       device=x.device)
    return torch.movedim(xm, 0, axis)


@op
def take(x, index, mode="raise"):
    flat = x.reshape(-1)
    idx = index.long()
    n = flat.shape[0]
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = torch.clamp(idx, 0, n - 1)
    else:
        if idx.numel() and (bool((idx < -n).any()) or bool((idx >= n).any())):
            raise IndexError(
                f"take: index out of range for {n} elements "
                f"(got min {int(idx.min())}, max {int(idx.max())})")
        idx = torch.where(idx < 0, idx + n, idx)
    return flat[idx]


@op
def kthvalue(x, k, axis=-1, keepdim=False):
    """The k-th smallest along ``axis`` and its index (a stable sort, so
    ties give the first occurrence, as jnp.argsort does)."""
    axis = axis % x.dim()
    args = torch.argsort(x, dim=axis, stable=True)
    i = args.select(axis, k - 1)
    v = torch.gather(x, axis, i.unsqueeze(axis)).squeeze(axis)
    if keepdim:
        v, i = v.unsqueeze(axis), i.unsqueeze(axis)
    return v, i


@op
def mode(x, axis=-1, keepdim=False):
    """The most frequent value along ``axis`` (count ties: the smallest
    value) and the index of its last occurrence."""
    axis = axis % x.dim()
    xm = torch.movedim(x, axis, -1)
    n = xm.shape[-1]
    s, _ = torch.sort(xm, dim=-1)
    counts = (s[..., :, None] == s[..., None, :]).sum(-1)
    best = torch.argmax(counts, dim=-1)
    bestv = torch.gather(s, -1, best[..., None])[..., 0]
    hit = (xm == bestv[..., None]).flip(-1).to(torch.uint8)
    idx = n - 1 - torch.argmax(hit, dim=-1)
    if keepdim:
        return (torch.movedim(bestv[..., None], -1, axis),
                torch.movedim(idx[..., None], -1, axis))
    return bestv, idx


@op
def scatter_nd(index, updates, shape):
    out = torch.zeros([int(s) for s in shape], dtype=updates.dtype,
                      device=updates.device)
    idx = tuple(i.long() for i in torch.movedim(index, -1, 0))
    return out.index_put(idx, updates, accumulate=True)


@op
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    """Deduplicate consecutive runs of the flattened input (the output's
    length depends on the data, as in the JAX package)."""
    if axis is not None:
        raise NotImplementedError("unique_consecutive with axis")
    out = torch.unique_consecutive(x.reshape(-1),
                                   return_inverse=return_inverse,
                                   return_counts=return_counts)
    return out


@op
def reverse(x, axis):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(x, dims=[int(a) for a in axes])


@op
def crop(x, shape=None, offsets=None):
    """lax.dynamic_slice: each start clamped so the window fits."""
    off = [int(o) for o in (offsets or [0] * x.dim())]
    shp = [int(s) if int(s) != -1 else x.shape[i] - off[i]
           for i, s in enumerate(shape or x.shape)]
    for i, (o, s) in enumerate(zip(off, shp)):
        o = min(max(o, 0), x.shape[i] - s)
        x = x.narrow(i, o, s)
    return x


@op
def strided_slice(x, axes, starts, ends, strides):
    """Python slicing per axis, negative strides included."""
    for a, s, e, st in zip(axes, starts, ends, strides):
        a = int(a)
        rng = range(*slice(int(s), int(e), int(st)).indices(x.shape[a]))
        x = torch.index_select(
            x, a, torch.tensor(list(rng), dtype=torch.int64,
                               device=x.device))
    return x


@op(name="slice")
def slice_(input, axes, starts, ends):
    return input[tuple(_slices(input.dim(), axes, starts, ends))]


# ---------------------------------------------------------------------------
# complex viewing
# ---------------------------------------------------------------------------
@op
def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


@op
def as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


@op
def atleast_1d(x):
    return torch.atleast_1d(x)


@op
def atleast_2d(x):
    return torch.atleast_2d(x)


@op
def atleast_3d(x):
    return torch.atleast_3d(x)


# ---------------------------------------------------------------------------
# random long tail: jax.random's algorithms over the generator's keys
# ---------------------------------------------------------------------------
_STIRLING_TAIL = (0.0810614667953272, 0.0413406959554092,
                  0.0276779256849983, 0.02079067210376509,
                  0.0166446911898211, 0.0138761288230707,
                  0.0118967099458917, 0.0104112652619720,
                  0.00925546218271273, 0.00833056343336287)


def _stirling_tail(k):
    vals = torch.tensor(_STIRLING_TAIL, dtype=k.dtype, device=k.device)
    kc = torch.clamp(k, 0.0, 9.0)
    kp1sq = (kc + 1) * (kc + 1)
    approx = (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (kc + 1)
    return torch.where(k <= 9, vals[torch.floor(kc).long()], approx)


def _binomial_inversion(key, count, q):
    log1mq = torch.log1p(-q)
    num = torch.zeros_like(q)
    gsum = torch.zeros_like(q)
    while bool((gsum <= count).any()):
        sub, key = threefry.split(key)
        num = torch.where(gsum <= count, num + 1, num)
        u = threefry.uniform(sub, q.shape, device=q.device)
        gsum = gsum + torch.ceil(torch.log(u) / log1mq)
    return num - 1


def _btrs(key, count, q):
    sd = torch.sqrt(count * q * (1 - q))
    b = 1.15 + 2.53 * sd
    a = -0.0873 + 0.0248 * b + 0.01 * q
    c = count * q + 0.5
    v_r = 0.92 - 4.2 / b
    r = q / (1 - q)
    alpha = (2.83 + 5.1 / b) * sd
    m = torch.floor((count + 1) * q)
    k_out = torch.full_like(q, -1.0)
    accepted = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    while not bool(accepted.all()):
        key, s0, s1 = threefry.split(key, 3)
        u = threefry.uniform(s0, q.shape, device=q.device) - 0.5
        v = threefry.uniform(s1, q.shape, device=q.device)
        us = 0.5 - torch.abs(u)
        accept1 = (us >= 0.07) & (v <= v_r)
        k = torch.floor((2 * a / us + b) * u + c)
        reject = (k < 0) | (k > count)
        v = torch.log(v * alpha / (a / (us * us) + b))
        ub = ((m + 0.5) * torch.log((m + 1) / (r * (count - m + 1)))
              + (count + 1) * torch.log((count - m + 1) / (count - k + 1))
              + (k + 0.5) * torch.log(r * (count - k + 1) / (k + 1))
              + _stirling_tail(m) + _stirling_tail(count - m)
              - _stirling_tail(k) - _stirling_tail(count - k))
        accept = accept1 | (~reject & (v <= ub))
        k_out = torch.where(accept, k, k_out)
        accepted |= accept
    return k_out


@op
def binomial(count, prob):
    """``jax.random.binomial`` (int32 out): inversion where count * q <=
    10, BTRS elsewhere, q = min(p, 1 - p)."""
    key = gen.active_key()
    prob = torch.as_tensor(prob).float()
    count = torch.as_tensor(count, device=prob.device).float()
    shape = torch.broadcast_shapes(count.shape, prob.shape)
    count = count.expand(shape)
    prob = prob.expand(shape)
    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    q = torch.where(torch.isnan(q) | (q < 0), torch.full_like(q, 0.01), q)
    inv = count * q <= 10.0
    count = torch.floor(count)
    c_inv = torch.where(inv, count, torch.zeros_like(count))
    c_btrs = torch.where(inv, torch.full_like(count, 1e4), count)
    q_btrs = torch.where(inv, torch.full_like(q, 0.5), q)
    s = torch.where(inv, _binomial_inversion(key, c_inv, q),
                    _btrs(key, c_btrs, q_btrs))
    s = torch.where(p_lt_half, s, count - s)
    return s.to(torch.int32)


class _Gamma(torch.autograd.Function):
    """A Gamma(alpha, 1) draw with the implicit reparameterization
    gradient d sample / d alpha = -(dF/dalpha) / f, as jax.random.gamma
    has it."""

    @staticmethod
    def forward(ctx, alpha, sample):
        ctx.save_for_backward(alpha, sample)
        return sample

    @staticmethod
    def backward(ctx, g):
        alpha, sample = ctx.saved_tensors
        return g * torch._standard_gamma_grad(alpha, sample), None


def _gamma_draw(key, a):
    """Marsaglia and Tsang's rejection (jax.random.gamma's method); below
    1 the shape is boosted by one and the draw scaled by u ** (1 / a)."""
    boost = a < 1
    ab = torch.where(boost, a + 1, a)
    d = ab - 1.0 / 3.0
    c = (1.0 / 3.0) / torch.sqrt(d)
    out = torch.zeros_like(a)
    done = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    key, bkey = threefry.split(key)
    while not bool(done.all()):
        key, kx, ku = threefry.split(key, 3)
        z = normal_bits(kx, a.shape, a.dtype, a.device)
        v = (1 + c * z) ** 3
        u = threefry.uniform(ku, a.shape, dtype=a.dtype, device=a.device)
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        out = torch.where(ok & ~done, d * v, out)
        done |= ok
    ub = 1 - threefry.uniform(bkey, a.shape, dtype=a.dtype, device=a.device)
    return torch.where(boost, out * ub ** (1.0 / a), out)


@op
def standard_gamma(x):
    """Gamma(x, 1) draws, differentiable in ``x``."""
    key = gen.active_key()
    with torch.no_grad():
        sample = _gamma_draw(key, x.detach())
    return _Gamma.apply(x, sample)


@op
def rad2deg(x):
    return torch.rad2deg(x)


@op
def deg2rad(x):
    return torch.deg2rad(x)
