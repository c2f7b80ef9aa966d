"""Linear algebra emitters (port of ``paddle_tpu/ops/linalg.py``).

``qr``, ``svd``, ``eigh`` and ``lu`` are unique only up to signs and
permutations, so their tests hold what the factors reconstruct. ``lu``
gives 0-based pivots (LAPACK's ipiv minus one), as ``lu_factor`` does in
jax.scipy. ``lstsq`` returns jnp's four results (solution, residuals,
rank, singular values) on any device.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.ops.registry import register_emitter as op


@op
def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@op
def bmm(x, y):
    return torch.matmul(x, y)


@op
def dot(x, y):
    return torch.sum(x * y, dim=-1)


@op
def mv(x, vec):
    return torch.matmul(x, vec)


@op
def t(x):
    if x.dim() < 2:
        return x.view_as(x)
    return x.transpose(-1, -2)


def _axes(axis):
    if axis is None:
        return None
    return tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),)


@op
def norm(x, p=2, axis=None, keepdim=False):
    ax = _axes(axis)
    if ax is None:
        ax = tuple(range(x.dim()))
    if p == "fro" or p == 2:
        if axis is None:
            return torch.sqrt(torch.sum(torch.square(x)))
        return torch.sqrt(torch.sum(torch.square(x), dim=ax, keepdim=keepdim))
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=ax, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=ax, keepdim=keepdim)
    if p == 1:
        return torch.sum(torch.abs(x), dim=ax, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=ax,
                               keepdim=keepdim), 1.0 / p)


@op
def dist(x, y, p=2):
    d = x - y
    if p == 0:
        return torch.sum((d != 0).to(x.dtype))
    if p == float("inf"):
        return torch.amax(torch.abs(d))
    if p == float("-inf"):
        return torch.amin(torch.abs(d))
    return torch.pow(torch.sum(torch.pow(torch.abs(d), p)), 1.0 / p)


@op
def cross(x, y, axis=None):
    return torch.linalg.cross(x, y, dim=-1 if axis is None else int(axis))


@op
def cholesky(x, upper=False):
    L = torch.linalg.cholesky(x)
    return L.transpose(-1, -2) if upper else L


@op
def qr(x, mode="reduced"):
    q, r = torch.linalg.qr(x, mode=mode)
    return q, r


@op
def svd(x, full_matrices=False):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh


@op
def eigh(x, UPLO="L"):
    w, v = torch.linalg.eigh(x, UPLO=UPLO)
    return w, v


@op
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@op
def inverse(x):
    return torch.linalg.inv(x)


@op
def pinv(x, rcond=1e-15):
    return torch.linalg.pinv(x, rtol=rcond)


@op
def det(x):
    return torch.linalg.det(x)


@op
def slogdet(x):
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs])


@op
def matrix_rank(x, tol=None):
    if tol is None:
        return torch.linalg.matrix_rank(x)
    return torch.linalg.matrix_rank(x, atol=float(tol), rtol=0.0)


@op
def matrix_power(x, n):
    return torch.linalg.matrix_power(x, int(n))


@op
def solve(x, y):
    return torch.linalg.solve(x, y)


@op
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    a = x.transpose(-1, -2) if transpose else x
    return torch.linalg.solve_triangular(a, y, upper=upper != bool(transpose),
                                         unitriangular=unitriangular)


@op
def lstsq(x, y, rcond=None):
    """jnp.linalg.lstsq: (solution, residuals, rank, singular values);
    residuals are the column sums of squared residuals when the system is
    tall and of full rank, else empty."""
    m, n = x.shape[-2], x.shape[-1]
    sv = torch.linalg.svdvals(x)
    if rcond is None:
        rcond = torch.finfo(x.dtype).eps * max(m, n)
    cut = rcond * sv.max()
    rank = (sv > cut).sum()
    sol = torch.linalg.pinv(x, rtol=rcond) @ y
    if m > n and int(rank) == n:
        r = x @ sol - y
        res = torch.sum(r * r, dim=0)
    else:
        res = torch.zeros((0,), dtype=x.dtype, device=x.device)
    return sol, res, rank, sv


@op
def lu(x):
    lu_, piv = torch.linalg.lu_factor(x)
    return lu_, (piv - 1).to(torch.int32)


@op
def cond(x, p=None):
    return torch.linalg.cond(x, p=p)


@op
def multi_dot(xs):
    return torch.linalg.multi_dot(list(xs))


@op
def householder_product(x, tau):
    return torch.linalg.householder_product(x, tau)


@op
def corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar else x.transpose(-1, -2))


@op
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else x.transpose(-1, -2),
                     correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)
