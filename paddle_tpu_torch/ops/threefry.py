"""Threefry-2x32, the counter-based generator behind ``jax.random``
(port of the parts of ``jax/_src/prng.py`` and ``jax/_src/random.py``
that the serving sampler and the random ops draw from).

The construction and the stream layout are those of jax 0.9 with
``jax_threefry_partitionable=True`` (its default): a key is a pair of
uint32 words ``(k1, k2)`` in the ``jax.random.PRNGKey`` layout, and

* :func:`split` row ``i`` is ``threefry2x32(k1, k2, 0, i)``;
* :func:`random_bits` element ``j`` of the flattened shape is
  ``x0 ^ x1`` of ``threefry2x32(k1, k2, 0, j)``;
* :func:`uniform` (f32, bf16, f16), :func:`gumbel` (``mode="low"``) and
  :func:`categorical` turn those bits into floats exactly as
  ``jax.random`` does, so the same key gives the same bits, the same
  uniforms and the same tokens in both packages;
* :func:`key` is ``jax.random.key(seed)``'s two words and
  :func:`fold_in` is ``jax.random.fold_in``, on Python ints: the global
  generator (``core/generator.py``) derives every draw's key on the host.

A key is either a ``(..., 2)`` tensor, over whose batch dimensions
every draw is batched (the serving sampler's per-slot keys), or a pair
of Python ints (the global generator's one key per draw, whose bits are
hashed on the device the draw lands on, so the card and the CPU draw the
same bits). Words travel as int64 tensors holding uint32 values (torch
has no full uint32 arithmetic); every add and rotate is masked back to
32 bits.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["threefry2x32", "key", "fold_in", "split", "random_bits",
           "uniform", "gumbel", "categorical"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


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


def key(seed: int):
    """``jax.random.key(seed)``'s words as a pair of Python ints. Without
    x64 (the JAX package's setting) the seed is taken modulo 2**32 into
    the low word and the high word is 0, negative seeds and seeds past
    2**32 included."""
    return (0, int(seed) & _M32)


def fold_in(key, data: int):
    """``jax.random.fold_in``: ``threefry2x32(key, threefry_seed(data))``,
    where the seed of a uint32 ``data`` is the words ``(0, data)``.
    ``key`` is a pair of Python ints; so is the result."""
    k1, k2 = threefry2x32(int(key[0]), int(key[1]), 0, int(data) & _M32)
    return (k1, k2)


def _hash_counters(key, n: int, device=None):
    """``threefry2x32(k1, k2, 0, j)`` for j in 0 .. n-1: two (..., n)
    words under each key of a ``(..., 2)`` tensor ``key``, on its device,
    or two (n,) words under a key of two Python ints, on ``device``. The
    high counter word is 0: no draw here reaches 2**32 elements."""
    if not isinstance(key, torch.Tensor):
        j = torch.arange(n, dtype=torch.int64, device=device)
        return threefry2x32(int(key[0]), int(key[1]), 0, j)
    k1 = key[..., 0, None].long()
    k2 = key[..., 1, None].long()
    j = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(k1, k2, torch.zeros_like(k1), j)


def _batch(key):
    return tuple(key.shape[:-1]) if isinstance(key, torch.Tensor) else ()


def split(key, num: int = 2):
    """``jax.random.split``: a ``(..., 2)`` tensor key -> (..., num, 2);
    a key of two Python ints -> a list of ``num`` such keys, hashed on
    the host."""
    if not isinstance(key, torch.Tensor):
        return [threefry2x32(int(key[0]), int(key[1]), 0, i)
                for i in range(num)]
    return torch.stack(_hash_counters(key, num), dim=-1)


def random_bits(key, shape: Sequence[int] = (), device=None):
    """32 random bits per element, uint32 values in int64: a ``(..., 2)``
    tensor key -> (..., *shape) on its device; a Python-int key ->
    ``shape`` on ``device``."""
    shape = tuple(int(s) for s in shape)
    b0, b1 = _hash_counters(key, math.prod(shape), device)
    return (b0 ^ b1).reshape(_batch(key) + shape)


# (bits drawn, mantissa bits, the word of 1.0, the int type of the width)
# per float dtype, as jax.random.uniform takes them: fewer than 8
# mantissa bits draw 8 bits
_FLOAT_BITS = {
    torch.float32: (32, 23, 0x3F800000, torch.int32),
    torch.bfloat16: (8, 7, 0x3F80, torch.int16),
    torch.float16: (16, 10, 0x3C00, torch.int16),
}


def _as_float(value, dtype):
    """``value`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def uniform(key, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0, dtype=torch.float32, device=None):
    """``jax.random.uniform`` in f32, bf16 or f16: the top mantissa bits
    of the draw become a float in [1, 2), which is shifted to [0, 1),
    scaled to [minval, maxval) and clamped below at minval. XLA fuses the
    f32 and f16 scale into one multiply-add; here it is computed in f64,
    where the product is exact, and then rounded once (on rare ties that
    second rounding can differ from the fused one's in the last bit; the
    samplers' ranges, [0, 1) and [tiny, 1), have none). bf16 draws round
    the product and the sum each to bf16, as XLA:CPU does there (both
    checked against jax 0.9.0). The bounds stay Python floats: a copy to
    the card here would wait for all the work queued before it."""
    nbits, nmant, one, itype = _FLOAT_BITS[dtype]
    bits = random_bits(key, shape, device)
    if nbits < 32:
        bits = bits & ((1 << nbits) - 1)
    word = (bits >> (nbits - nmant)) | one
    if itype == torch.int16:
        word = torch.where(word >= 0x8000, word - 0x10000, word)
    f = word.to(itype).view(dtype) - 1.0
    lo = _as_float(minval, dtype)
    width = _as_float(_as_float(maxval, dtype) - lo, dtype)
    if dtype == torch.bfloat16:
        out = f * width + lo
    else:
        out = (f.double() * width + lo).to(dtype)
    return out.clamp_min(lo)


def gumbel(key, shape: Sequence[int] = (), dtype=torch.float32,
           device=None):
    """Standard Gumbel noise, ``jax.random.gumbel``'s default low mode:
    ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    u = uniform(key, shape, torch.finfo(dtype).tiny, 1.0, dtype, device)
    return -torch.log(-torch.log(u))


def categorical(key, logits, axis: int = -1, shape=None):
    """``jax.random.categorical`` by the Gumbel-max trick: the first index
    of the largest ``gumbel + logits`` along ``axis``, the noise in the
    logits' dtype.

    A ``(..., 2)`` tensor of keys with batch dimensions draws one token
    per row of ``logits`` (..., V), each row under its own key, as
    ``jax.vmap`` over the keys does (``axis`` -1, no ``shape``). One key
    (two Python ints, or a ``(2,)`` tensor under a device key stream)
    draws the noise over ``(*prefix, *logits.shape)``, where ``shape``
    (default the batch shape, ``logits.shape`` without ``axis``) is
    ``prefix`` followed by a shape the batch shape broadcasts to, as
    ``jax.random.categorical`` with replacement does."""
    if isinstance(key, torch.Tensor) and key.dim() > 1:
        g = gumbel(key, logits.shape[-1:], logits.dtype)
        return torch.argmax(g + logits, dim=-1)
    nd = logits.dim()
    axis = axis % nd
    batch = tuple(s for i, s in enumerate(logits.shape) if i != axis)
    shape = batch if shape is None else tuple(int(s) for s in shape)
    if len(shape) < len(batch) or any(
            b != s and b != 1 for b, s in zip(batch[::-1], shape[::-1])):
        raise ValueError(f"categorical: shape {shape} does not broadcast "
                         f"with the batch shape {batch}")
    prefix = shape[:len(shape) - len(batch)]
    lshape = list(shape[len(shape) - len(batch):])
    lshape.insert(axis, logits.shape[axis])
    g = gumbel(key, (*prefix, *lshape), logits.dtype, logits.device)
    z = g + logits.reshape((1,) * len(prefix) + tuple(logits.shape))
    return torch.argmax(z, dim=len(prefix) + axis)
