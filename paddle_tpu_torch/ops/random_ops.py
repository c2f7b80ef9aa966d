"""Random sampling emitters (port of ``paddle_tpu/ops/random_ops.py``) and
the ``jax.random`` samplers they and the other drawing ops use, over the
transforms of :mod:`paddle_tpu_torch.ops.threefry` (``split``,
``random_bits``, ``uniform``, ``gumbel``, ``categorical``).

Every draw takes one key from the active stream of the global generator
(:func:`paddle_tpu_torch.core.generator.active_key`), as in the JAX
package. A key is a pair of Python ints, or, under
:func:`~paddle_tpu_torch.core.generator.device_key_stream` (a
``jit.TrainStep``'s step), a ``(2,)`` tensor on the device the draw lands
on; its bits are ``threefry2x32(k1, k2, 0, j)`` for element ``j``,
computed on that device, so the card and the CPU draw the same bits.

What is reproduced bit for bit, and what only in distribution:

* from the bits alone, bit-identical to ``jax.random`` on XLA:CPU:
  ``threefry.uniform`` (f32, bf16, f16), :func:`bernoulli_bits`,
  :func:`randint_bits`, :func:`shuffle_bits` (the same sort rounds, a
  stable sort);
* through a transcendental, the same uniforms and the same formula
  (XLA's own ``erf_inv`` polynomial, :func:`erfinv_f32`), with torch's
  ``log``, ``log1p``, ``tan`` or ``lgamma`` where XLA has its own
  approximations, so values may differ in the last bits:
  :func:`normal_bits`, :func:`truncated_normal_bits`,
  :func:`exponential_bits`, :func:`cauchy_bits`, ``threefry.gumbel``,
  ``threefry.categorical`` and :func:`poisson_bits` (whose accept tests
  can then rarely go the other way).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.core import generator as gen
from paddle_tpu_torch.core.dtype import get_default_dtype, to_torch
from paddle_tpu_torch.core.place import _default_device
from paddle_tpu_torch.ops import threefry
from paddle_tpu_torch.ops.registry import register_emitter as op
from paddle_tpu_torch.ops.threefry import _M32


# ---------------------------------------------------------------------------
# jax.random's samplers over one key (a pair of Python ints)
# ---------------------------------------------------------------------------
def bernoulli_bits(key, p, shape, device):
    """``jax.random.bernoulli(key, p, shape)`` (``mode="low"``): a uniform
    of ``p``'s dtype below ``p``. A Python float ``p`` draws f32."""
    if isinstance(p, torch.Tensor):
        return threefry.uniform(key, shape, dtype=p.dtype,
                                device=device) < p
    u = threefry.uniform(key, shape, device=device)
    # a fill, not a host copy: a captured CUDA graph may run this
    return u < torch.full((), p, dtype=torch.float32, device=u.device)


def randint_bits(key, shape, minval, maxval, device, dtype=torch.int32):
    """``jax.random.randint`` for 32-bit integers: two draws of 32 bits
    under the key's two splits, reduced modulo the span with uint32
    arithmetic (so the multiplier wraps as XLA's does)."""
    k1, k2 = threefry.split(key)
    hi = threefry.random_bits(k1, shape, device)
    lo = threefry.random_bits(k2, shape, device)
    minval, maxval = int(minval), int(maxval)
    span = 1 if maxval <= minval else (maxval - minval) & _M32
    mult = (2 ** 16) % span
    mult = (mult * mult & _M32) % span
    off = ((hi % span) * mult & _M32) + lo % span
    off = (off & _M32) % span
    out = (minval + off) & _M32
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(dtype)


def shuffle_bits(key, x, axis=0):
    """``jax.random``'s ``_shuffle``: ``ceil(3 ln n / ln(2**32 - 1))``
    rounds, each a stable sort of ``x`` along ``axis`` by 32 fresh random
    bits per element from the next split of the key."""
    n = x.numel()
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(2 ** 32 - 1)))
    for _ in range(rounds):
        key, sub = threefry.split(key)
        sort_keys = threefry.random_bits(sub, x.shape, x.device)
        idx = torch.sort(sort_keys, dim=axis, stable=True).indices
        x = torch.take_along_dim(x, idx, dim=axis)
    return x


# XLA's f32 erf_inv (Giles' polynomials in w = -log1p(-x^2), below and
# above w = 5), whose multiply-adds XLA:CPU fuses; torch's erfinv is
# another approximation, further from it in the tails
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x):
    """XLA's f32 ``erf_inv``, the polynomial's multiply-adds each rounded
    once (from f64); within an ulp of XLA:CPU's, which differ only where
    torch's ``log1p`` and XLA's do."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    lt5 = torch.tensor(_ERFINV_LT5, dtype=torch.float64, device=x.device)
    ge5 = torch.tensor(_ERFINV_GE5, dtype=torch.float64, device=x.device)
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = (p * w + torch.where(lt, lt5[i], ge5[i])).float().double()
    r = p.float() * x
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max, r)


def normal_bits(key, shape, dtype=torch.float32, device=None):
    """``jax.random.normal``: ``sqrt(2) * erf_inv(u)`` with u uniform in
    [nextafter(-1, 0), 1)."""
    dtype = to_torch(dtype)
    lo = -1.0 + torch.finfo(dtype).eps / 2      # nextafter(-1, 0)
    u = threefry.uniform(key, shape, lo, 1.0, dtype, device)
    sqrt2 = torch.tensor(math.sqrt(2), dtype=dtype, device=u.device)
    return sqrt2 * erfinv_f32(u.float()).to(dtype)


def truncated_normal_bits(key, lower, upper, shape, device):
    """``jax.random.truncated_normal`` in f32: u uniform between
    erf(lower / sqrt 2) and erf(upper / sqrt 2), ``sqrt(2) * erf_inv(u)``,
    clipped inside the open interval."""
    f32 = torch.float32
    sqrt2 = torch.tensor(math.sqrt(2), dtype=f32)
    lo_t, hi_t = torch.tensor(lower, dtype=f32), torch.tensor(upper,
                                                              dtype=f32)
    a = float(torch.erf(lo_t / sqrt2))
    b = float(torch.erf(hi_t / sqrt2))
    u = threefry.uniform(key, shape, a, b, f32, device)
    out = sqrt2.to(u.device) * erfinv_f32(u)
    inf = torch.tensor(float("inf"), dtype=f32)
    return out.clamp(float(torch.nextafter(lo_t, inf)),
                     float(torch.nextafter(hi_t, -inf)))


def exponential_bits(key, shape, dtype=torch.float32, device=None):
    """``jax.random.exponential``: ``-log1p(-u)``."""
    u = threefry.uniform(key, shape, dtype=to_torch(dtype), device=device)
    return -torch.log1p(-u)


def cauchy_bits(key, shape, device):
    """``jax.random.cauchy`` in f32: ``tan(pi (u - 1/2))`` with u uniform
    in [eps, 1)."""
    u = threefry.uniform(key, shape,
                         float(torch.finfo(torch.float32).eps), 1.0,
                         device=device)
    return torch.tan(math.pi * (u - 0.5))


def poisson_bits(key, lam):
    """``jax.random.poisson`` (int32): Knuth's algorithm below 10,
    Hörmann's transformed rejection from 10, both run over every element
    with the same key, as jax runs them."""
    shape = tuple(lam.shape)
    dev = lam.device
    use_knuth = torch.isnan(lam) | (lam < 10)
    lam_k = torch.where(use_knuth, lam, torch.zeros_like(lam))
    lam_r = torch.where(use_knuth, torch.full_like(lam, 1e5), lam)

    rng = key
    k = torch.zeros(shape, dtype=torch.int32, device=dev)
    log_prod = torch.zeros(shape, dtype=torch.float32, device=dev)
    while bool((log_prod > -lam_k).any()):
        rng, sub = threefry.split(rng)
        k = torch.where(log_prod > -lam_k, k + 1, k)
        u = threefry.uniform(sub, shape, device=dev)
        log_prod = log_prod + torch.log(u)
    knuth = k - 1

    log_lam = torch.log(lam_r)
    b = 0.931 + 2.53 * torch.sqrt(lam_r)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    k_out = torch.full(shape, -1.0, dtype=lam.dtype, device=dev)
    accepted = torch.zeros(shape, dtype=torch.bool, device=dev)
    rng = key
    while not bool(accepted.all()):
        rng, sk0, sk1 = threefry.split(rng, 3)
        u = threefry.uniform(sk0, shape, dtype=lam.dtype, device=dev) - 0.5
        v = threefry.uniform(sk1, shape, dtype=lam.dtype, device=dev)
        us = 0.5 - u.abs()
        kk = torch.floor((2 * a / us + b) * u + lam_r + 0.43)
        s = torch.log(v * inv_alpha / (a / (us * us) + b))
        t = -lam_r + kk * log_lam - torch.lgamma(kk + 1)
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (kk < 0) | ((us < 0.013) & (v > us))
        accept = accept1 | (~reject & (s <= t))
        k_out = torch.where(accept, kk, k_out)
        accepted |= accept
    out = torch.where(use_knuth, knuth, k_out.to(torch.int32))
    return torch.where(lam == 0, torch.zeros_like(out), out)


# ---------------------------------------------------------------------------
# the random section's emitters
# ---------------------------------------------------------------------------
def _dt(dtype):
    return to_torch(dtype) if dtype is not None else \
        to_torch(get_default_dtype())


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


@op
def rand(shape, dtype=None):
    return threefry.uniform(gen.active_key(), _shape(shape),
                            dtype=_dt(dtype), device=_default_device())


@op
def randn(shape, dtype=None):
    return normal_bits(gen.active_key(), _shape(shape), _dt(dtype),
                       _default_device())


@op
def randint(low=0, high=None, shape=(1,), dtype="int64"):
    """Integers in [low, high) drawn as ``jax.random.randint`` draws
    int32; the result is ``dtype`` (the JAX package always gives int32,
    the port keeps the requested integer type: ROADMAP, by design)."""
    if high is None:
        low, high = 0, low
    return randint_bits(gen.active_key(), _shape(shape), low, high,
                        _default_device()).to(to_torch(dtype))


@op
def uniform(shape, dtype=None, min=-1.0, max=1.0):
    return threefry.uniform(gen.active_key(), _shape(shape), min, max,
                            _dt(dtype), _default_device())


@op
def normal(mean=0.0, std=1.0, shape=None):
    out = normal_bits(gen.active_key(), _shape(shape),
                      to_torch(get_default_dtype()), _default_device())
    return out * std + mean


@op
def standard_normal(shape, dtype=None):
    return normal_bits(gen.active_key(), _shape(shape), _dt(dtype),
                       _default_device())


@op
def randperm(n, dtype="int64"):
    """A permutation of ``range(n)`` as ``jax.random.permutation`` shuffles
    it; ``dtype`` kept, as for :func:`randint`."""
    key = gen.active_key()
    x = torch.arange(int(n), dtype=torch.int64, device=_default_device())
    return shuffle_bits(key, x).to(to_torch(dtype))


@op
def shuffle(x, axis=0):
    """``jax.random.permutation(key, x, axis, independent=False)``: one
    permutation of the slices along ``axis``."""
    key = gen.active_key()
    axis = int(axis) % max(x.dim(), 1)
    if x.dim() <= 1:
        return shuffle_bits(key, x, axis)
    ind = shuffle_bits(key, torch.arange(x.shape[axis], device=x.device))
    return torch.index_select(x, axis, ind)


@op
def poisson(x):
    return poisson_bits(gen.active_key(), x).to(x.dtype)


@op
def exponential(x, lam=1.0):
    return exponential_bits(gen.active_key(), x.shape, x.dtype,
                            x.device) / lam
