"""Threefry-2x32, the counter-based generator behind ``jax.random``
(port of the parts of ``jax/_src/prng.py`` and ``jax/_src/random.py``
that the serving sampler draws from).

The construction and the stream layout are those of jax 0.9 with
``jax_threefry_partitionable=True`` (its default): a key is a pair of
uint32 words ``(k1, k2)`` in the ``jax.random.PRNGKey`` layout, and

* :func:`split` row ``i`` is ``threefry2x32(k1, k2, 0, i)``;
* :func:`random_bits` element ``j`` of the flattened shape is
  ``x0 ^ x1`` of ``threefry2x32(k1, k2, 0, j)``;
* :func:`uniform`, :func:`gumbel` (``mode="low"``) and
  :func:`categorical` turn those bits into floats exactly as
  ``jax.random`` does, so the same key gives the same bits, the same
  uniforms and the same tokens in both packages.

Every function is batched over keys: ``key`` is a ``(..., 2)`` tensor
and the draw's shape follows the batch dimensions. Words travel as int64
tensors holding uint32 values (torch has no full uint32 arithmetic);
every add and rotate is masked back to 32 bits.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["threefry2x32", "split", "random_bits", "uniform", "gumbel",
           "categorical"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words
    ``(x0, x1)`` under the key ``(k1, k2)``; all four broadcast together.
    Returns the two output words."""
    ks = (k1 & _M32, k2 & _M32, (k1 ^ k2 ^ _PARITY) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _hash_counters(key, n: int):
    """``threefry2x32(k1, k2, 0, j)`` for j in 0 .. n-1 under each key of
    ``key`` (..., 2): two (..., n) words. The high counter word is 0: no
    draw here reaches 2**32 elements."""
    k1 = key[..., 0, None].long()
    k2 = key[..., 1, None].long()
    j = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(k1, k2, torch.zeros_like(k1), j)


def split(key, num: int = 2):
    """``jax.random.split``: ``key`` (..., 2) -> (..., num, 2)."""
    return torch.stack(_hash_counters(key, num), dim=-1)


def random_bits(key, shape: Sequence[int] = ()):
    """32 random bits per element: ``key`` (..., 2) -> (..., *shape),
    uint32 values in int64."""
    shape = tuple(shape)
    b0, b1 = _hash_counters(key, math.prod(shape))
    return (b0 ^ b1).reshape(key.shape[:-1] + shape)


def uniform(key, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0):
    """f32 uniforms in [minval, maxval): the top 23 random bits become the
    mantissa of a float in [1, 2), which is shifted to [0, 1) and scaled.
    XLA fuses the scale into one f32 multiply-add; here it is computed in
    f64, where the product is exact, and then rounded to f32 (on rare
    ties that second rounding can differ from the fused one's in the last
    bit; the samplers' ranges, [0, 1) and [tiny, 1), have none)."""
    bits = random_bits(key, shape)
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    # the bounds as f32 values, on the host: a copy to the card here
    # would wait for all the work queued before it
    lo = torch.tensor(minval, dtype=torch.float32)
    width = float(torch.tensor(maxval, dtype=torch.float32) - lo)
    lo = float(lo)
    return (f.double() * width + lo).float().clamp_min(lo)


def gumbel(key, shape: Sequence[int] = ()):
    """Standard Gumbel noise, ``jax.random.gumbel``'s default low mode:
    ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key, logits):
    """One draw per row of ``logits`` (..., V) from softmax(logits) by the
    Gumbel-max trick, as ``jax.random.categorical``: the first index of
    the largest ``gumbel + logits``. ``key`` (..., 2)."""
    g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits.float(), dim=-1)
