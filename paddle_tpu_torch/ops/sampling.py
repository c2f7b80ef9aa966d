"""Token sampling and speculative verify on the device (port of
``paddle_tpu/ops/sampling.py``).

Everything here runs on the logits' device, so a step ships S x (R+3)
int32 values (tokens, emit count, the per-slot generator keys) to the
host, never the S x vocab logits.

* :func:`filtered_probs` — fused temperature / top-k / top-p transform
  of a batch of logit rows into sampling distributions. Greedy rows
  (``temperature <= 0``) become an EXACT one-hot at ``argmax(logits)``
  (first-occurrence tie-breaking, matching ``np.argmax``).
* :func:`sample_or_verify` — rejection-sample each slot's ``n_draft``
  greedy draft proposals against the target's gathered logit rows and
  draw the corrected or bonus token. Draft token i is accepted with
  probability ``p(t_i)`` (a greedy draft is a point mass), a rejection
  emits a draw from ``p`` with ``t_i`` masked out, and a fully accepted
  draft earns one bonus draw from the last row: the emitted tokens are
  distributed exactly as the target alone would emit them.
* :func:`sample_tokens` — the ``n_draft == 0``, one-row case.

The draws come from threefry (:mod:`paddle_tpu_torch.ops.threefry`),
keyed by each request's uint32[2] key, with the JAX package's split
schedule: the same key, logits and knobs give the same tokens and the
same advanced keys in both packages. Generator contract: every call
advances each slot's key by exactly ``2*(R-1) + 1`` splits, whatever
its data or ``n_draft``, so a request's stream position is a pure
function of how many engine steps emitted for it.

Keys travel as int64 tensors holding uint32 values (torch has no full
uint32 arithmetic).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.ops import threefry

__all__ = ["filtered_probs", "sample_tokens", "sample_or_verify",
           "xla_cumsum", "xla_sum"]

_M32 = 0xFFFFFFFF
_SCAN_CHUNK = 16   # XLA:CPU's cumsum chunk (jax 0.9.0)
_REDUCE_WINDOW = 32  # XLA:CPU's tree-reduction window (jax 0.9.0)


def xla_sum(x):
    """Sum over the last dim, added in the order XLA:CPU adds
    ``jnp.sum`` (jax 0.9.0), so float32 results are bit-identical to the
    JAX package's: while the dim is longer than 32, pad it to a multiple
    of 32 (zeros split evenly, the odd one on the right) and add each
    window of 32 sequentially; then add what is left sequentially."""
    n = x.shape[-1]
    while n > _REDUCE_WINDOW:
        padded = -(-n // _REDUCE_WINDOW) * _REDUCE_WINDOW
        lo = (padded - n) // 2
        x = torch.nn.functional.pad(x, (lo, padded - n - lo)).reshape(
            *x.shape[:-1], padded // _REDUCE_WINDOW, _REDUCE_WINDOW)
        n = padded // _REDUCE_WINDOW
        x = _sequential_sum(x)
    return _sequential_sum(x)


def _sequential_sum(x):
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def xla_cumsum(x):
    """Inclusive cumulative sum over the last dim, added in the order
    XLA:CPU adds ``jnp.cumsum`` (jax 0.9.0), so float32 results are
    bit-identical to the JAX package's: pad to a multiple of 16, add
    sequentially within each 16-wide chunk, scan the chunk totals the
    same way (recursively), and add each chunk's exclusive prefix. Every
    add is a separate elementwise op, so the card adds in this order
    too. The top-p cut compares these sums with ``top_p``; on tied
    probabilities a sum in another order lands on the other side of it
    and keeps another number of tokens."""
    v = x.shape[-1]
    n = -(-v // _SCAN_CHUNK) * _SCAN_CHUNK
    chunks = torch.nn.functional.pad(x, (0, n - v)).reshape(
        *x.shape[:-1], n // _SCAN_CHUNK, _SCAN_CHUNK)
    cols = [chunks[..., 0]]
    for j in range(1, _SCAN_CHUNK):
        cols.append(cols[-1] + chunks[..., j])
    out = torch.stack(cols, dim=-1)
    if n > _SCAN_CHUNK:
        totals = xla_cumsum(out[..., -1])
        prefix = torch.cat([torch.zeros_like(totals[..., :1]),
                            totals[..., :-1]], dim=-1)
        out = out + prefix[..., None]
    return out.reshape(*x.shape[:-1], n)[..., :v]


def filtered_probs(logits, temperature, top_k, top_p):
    """Per-row sampling distributions: ``logits`` (S, V); ``temperature``
    (S,) float (``<= 0`` = greedy one-hot); ``top_k`` (S,) int (0 = off);
    ``top_p`` (S,) float (1.0 = off). Returns (S, V) f32 probabilities.

    Same transform order as the JAX version — temperature softmax, then
    top-k renormalised, then the smallest nucleus with cumulative mass
    >= top_p — in f32, with every sum and the cumulative sum added in
    XLA's order (:func:`xla_sum`, :func:`xla_cumsum`)."""
    lg = logits.float()
    v = lg.shape[-1]
    greedy = temperature <= 0.0
    t = torch.where(greedy, torch.ones_like(temperature), temperature)
    x = lg / t[:, None].float()
    x = x - x.max(dim=-1, keepdim=True).values
    p = x.exp()
    p = p / xla_sum(p)[:, None]
    # top-k: zero everything below the k-th largest probability
    desc = p.sort(dim=-1, descending=True).values
    k_eff = torch.where((top_k > 0) & (top_k < v), top_k,
                        torch.full_like(top_k, v)).long()
    kth = desc.gather(-1, (k_eff - 1)[:, None])
    p = torch.where(p >= kth, p, 0.0)
    p = p / xla_sum(p)[:, None]
    # top-p: keep the smallest descending-order prefix whose cumulative
    # mass reaches top_p (keep_n = #(csum < top_p) + 1, as in JAX)
    order = torch.argsort(-p, dim=-1, stable=True)
    sp = p.gather(-1, order)
    csum = xla_cumsum(sp)
    keep_n = (csum < top_p[:, None].float()).sum(dim=-1) + 1
    rank = torch.argsort(order, dim=-1, stable=True)
    p = torch.where(rank < keep_n[:, None], p, 0.0)
    p = p / xla_sum(p)[:, None]
    onehot = torch.zeros_like(p).scatter_(
        -1, lg.argmax(dim=-1, keepdim=True), 1.0)
    return torch.where(greedy[:, None], onehot, p)


def _split_rows(keys):
    """Advance an (S, 2) key batch one split: returns
    ``(chain_keys, draw_keys)``, each (S, 2)."""
    ks = threefry.split(keys, 2)
    return ks[:, 0], ks[:, 1]


def sample_or_verify(logits, draft_tokens, n_draft, keys, temperature,
                     top_k, top_p):
    """Rejection-sample ``n_draft`` proposed tokens per slot and draw the
    corrected or bonus token.

    ``logits`` (S, R, V): the slot's last R packed positions, so a slot
    with ``d < R-1`` drafts finds its verify rows right-aligned, starting
    at index ``R-1-d``. ``draft_tokens`` (S, R-1) int (garbage past
    ``n_draft``); ``n_draft`` (S,) int in [0, R-1]; ``keys`` (S, 2)
    uint32 values in int64; sampling knobs (S,) as in
    :func:`filtered_probs`.

    Returns ``(tokens (S, R) int32, n_emit (S,) int32, new_keys (S, 2)
    int64)``: ``tokens[:, :n_emit]`` are the accepted draft prefix plus
    one corrected-or-bonus token.

    Every corrected draw and the bonus draw is computed for every row, as
    the JAX package computes them; the R categoricals share one batched
    threefry pass (each keeps its own key, so the draws are the JAX
    package's)."""
    s, r, v = logits.shape
    dev = logits.device
    keys = keys.long() & _M32
    n_draft = n_draft.long()
    j = torch.arange(r - 1, device=dev)
    # row j of the gather: the target distribution for draft token j;
    # the last row is the bonus (or plain sampling) position
    idx = ((r - 1) - n_draft[:, None] + j[None, :]).clamp(0, r - 1)
    idx = torch.cat([idx, torch.full((s, 1), r - 1, device=dev,
                                     dtype=torch.long)], dim=1)
    lg = logits.gather(1, idx[:, :, None].expand(s, r, v))
    p = filtered_probs(lg.reshape(s * r, v),
                       temperature.repeat_interleave(r),
                       top_k.repeat_interleave(r),
                       top_p.repeat_interleave(r)).reshape(s, r, v)
    t = draft_tokens.long().clamp(0, v - 1)                    # (S, R-1)
    p_t = p[:, :r - 1].gather(-1, t[:, :, None])[..., 0]
    # the key schedule: per draft row a split for the accept uniform and
    # one for the corrected draw, then one for the bonus
    u, draw_keys = [], []
    for _ in range(r - 1):
        keys, sub = _split_rows(keys)
        u.append(threefry.uniform(sub))
        keys, sub2 = _split_rows(keys)
        draw_keys.append(sub2)
    keys, sub = _split_rows(keys)
    draw_keys.append(sub)
    # corrected draws: p with the rejected proposal masked out
    # (norm(max(0, p - q)) for the greedy draft's point mass q; the
    # categorical takes unnormalised log-mass); the bonus draws from p
    vocab = torch.arange(v, device=dev)
    masked = torch.cat([
        torch.where(vocab[None, None, :] == t[:, :, None], 0.0,
                    p[:, :r - 1]), p[:, r - 1:]], dim=1)
    draws = threefry.categorical(torch.stack(draw_keys, dim=1),
                                 torch.log(masked))            # (S, R)
    out = torch.zeros((s, r), dtype=torch.long, device=dev)
    n_emit = torch.zeros((s,), dtype=torch.long, device=dev)
    done = torch.zeros((s,), dtype=torch.bool, device=dev)
    for jj in range(r - 1):
        active = (~done) & (jj < n_draft)
        acc = u[jj] < p_t[:, jj]
        emit = torch.where(acc, t[:, jj], draws[:, jj])
        out[:, jj] = torch.where(active, emit, out[:, jj])
        n_emit = torch.where(active, n_emit + 1, n_emit)
        done = done | (active & ~acc)
    active = ~done
    slot = n_emit.clamp(0, r - 1)
    rows = torch.arange(s, device=dev)
    out[rows, slot] = torch.where(active, draws[:, r - 1], out[rows, slot])
    n_emit = torch.where(active, n_emit + 1, n_emit)
    return out.to(torch.int32), n_emit.to(torch.int32), keys


def sample_tokens(logits, keys, temperature, top_k, top_p):
    """One sampled token per row: ``logits`` (S, V), ``keys`` (S, 2)
    uint32 values in int64. Returns ``(tokens (S,) int32, new_keys (S, 2)
    int64)`` — the ``n_draft == 0`` case of :func:`sample_or_verify`."""
    s = logits.shape[0]
    dev = logits.device
    out, _, keys2 = sample_or_verify(
        logits[:, None, :], torch.zeros((s, 0), dtype=torch.long,
                                        device=dev),
        torch.zeros((s,), dtype=torch.long, device=dev), keys,
        temperature, top_k, top_p)
    return out[:, 0], keys2
