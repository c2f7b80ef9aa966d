"""Token sampling on the device (port of ``paddle_tpu/ops/sampling.py``,
the one-logit-row case).

Everything here runs on the logits' device, so a step ships S int32
tokens (plus the per-slot generator keys) to the host, never the
S x vocab logits.

* :func:`filtered_probs` — fused temperature / top-k / top-p transform
  of a batch of logit rows into sampling distributions. Greedy rows
  (``temperature <= 0``) become an EXACT one-hot at ``argmax(logits)``
  (first-occurrence tie-breaking, matching ``np.argmax``).
* :func:`sample_tokens` — one categorical draw per slot from its own
  counter-based generator, keyed by the request's uint32[2] key,
  returning the advanced keys alongside the tokens.

Generator contract: every call advances each slot's key by a FIXED map
(a bijective mix of the 64-bit key), independent of the slot's data, so
a request's stream position is a pure function of how many engine steps
emitted for it (preemption and chunking do not shift it). The draw is a
second mix of the same key. The bits differ from ``jax.random``'s
threefry: the two packages agree on greedy tokens, and on sampled ones
only in distribution.

Keys travel as int64 tensors holding uint32 values (torch has no full
uint32 arithmetic); every product is split in 16-bit halves so no
intermediate leaves int64's range.
"""
from __future__ import annotations

import torch

__all__ = ["filtered_probs", "sample_tokens"]

_M32 = 0xFFFFFFFF


def filtered_probs(logits, temperature, top_k, top_p):
    """Per-row sampling distributions: ``logits`` (S, V); ``temperature``
    (S,) float (``<= 0`` = greedy one-hot); ``top_k`` (S,) int (0 = off);
    ``top_p`` (S,) float (1.0 = off). Returns (S, V) f32 probabilities.

    Same transform order as the JAX version — temperature softmax, then
    top-k renormalised, then the smallest nucleus with cumulative mass
    >= top_p — in f32."""
    lg = logits.float()
    v = lg.shape[-1]
    greedy = temperature <= 0.0
    t = torch.where(greedy, torch.ones_like(temperature), temperature)
    x = lg / t[:, None].float()
    x = x - x.max(dim=-1, keepdim=True).values
    p = x.exp()
    p = p / p.sum(dim=-1, keepdim=True)
    # top-k: zero everything below the k-th largest probability
    desc = p.sort(dim=-1, descending=True).values
    k_eff = torch.where((top_k > 0) & (top_k < v), top_k,
                        torch.full_like(top_k, v)).long()
    kth = desc.gather(-1, (k_eff - 1)[:, None])
    p = torch.where(p >= kth, p, 0.0)
    p = p / p.sum(dim=-1, keepdim=True)
    # top-p: keep the smallest descending-order prefix whose cumulative
    # mass reaches top_p (keep_n = #(csum < top_p) + 1, as in JAX)
    order = torch.argsort(-p, dim=-1, stable=True)
    sp = p.gather(-1, order)
    csum = sp.cumsum(dim=-1)
    keep_n = (csum < top_p[:, None].float()).sum(dim=-1) + 1
    rank = torch.argsort(order, dim=-1, stable=True)
    p = torch.where(rank < keep_n[:, None], p, 0.0)
    p = p / p.sum(dim=-1, keepdim=True)
    onehot = torch.zeros_like(p).scatter_(
        -1, lg.argmax(dim=-1, keepdim=True), 1.0)
    return torch.where(greedy[:, None], onehot, p)


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 tensors holding uint32 values."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x):
    """murmur3's 32-bit finaliser: a bijection with full avalanche."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _feistel(hi, lo, salt: int):
    """Four Feistel rounds over the 64-bit key (hi, lo): a bijection of
    the key space, so the advance map has no short cycles to fall into."""
    for r in range(4):
        rk = (salt * 0x9E3779B9 + r * 0x7F4A7C15) & _M32
        hi, lo = lo, hi ^ _fmix32((lo + rk) & _M32)
    return hi, lo


def _advance(keys):
    hi, lo = _feistel(keys[:, 0], keys[:, 1], 1)
    return torch.stack([hi, lo], dim=1)


def _uniform(keys):
    """One f32 uniform in [0, 1) per key, 24 random bits."""
    _, lo = _feistel(keys[:, 0], keys[:, 1], 2)
    return (lo >> 8).float() * (1.0 / (1 << 24))


def sample_tokens(logits, keys, temperature, top_k, top_p):
    """One sampled token per row: ``logits`` (S, V), ``keys`` (S, 2)
    uint32 values in an int64 tensor. Returns ``(tokens (S,) int32,
    new_keys (S, 2) int64)``. Greedy rows take the argmax; sampled rows
    invert the CDF of :func:`filtered_probs` at the key's uniform."""
    keys = keys.long() & _M32
    p = filtered_probs(logits, temperature, top_k, top_p)
    cdf = p.cumsum(dim=-1)
    u = _uniform(keys)[:, None] * cdf[:, -1:]
    tok = torch.searchsorted(cdf, u, right=True)[:, 0]
    tok = tok.clamp(max=p.shape[-1] - 1).to(torch.int32)
    return tok, _advance(keys)
