"""Attention entry points of the Tensor API (port of
``paddle_tpu/nn/functional/flash_attention.py`` and of
``paddle_tpu/ops/pallas_attention.py`` ``flash_attention``).

Layout: [batch, seq, heads, head_dim]. Every dropout-free call goes to
the registry's ``flash_attention`` op (the hand-written kernels on the
card, their plain versions on the CPU), whatever the sequence lengths;
the JAX dispatcher sends shapes its TPU blocks do not tile to SDPA
instead. ``dropout > 0`` keeps the JAX route: plain attention with
dropout, its mask drawn from the global generator. ``flash_attn_unpadded``
repacks the packed rows into a padded batch and calls
``variable_length_memory_efficient_attention``, as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops.registry import API as _API

__all__ = ["flash_attention", "flash_attn_unpadded",
           "scaled_dot_product_attention"]


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    training=True, name=None):
    """paddle.nn.functional.flash_attention: returns ``(out, None)``, as
    the JAX package does (``return_softmax`` and ``fixed_seed_offset``
    are accepted and ignored there too)."""
    if dropout > 0.0:
        out = _API["scaled_dot_product_attention"](
            query, key, value, is_causal=causal, dropout_p=dropout,
            training=training)
    else:
        out = _API["flash_attention"](query, key, value, causal=causal)
    return out, None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    return _API["scaled_dot_product_attention"](
        query, key, value, attn_mask=attn_mask, dropout_p=dropout_p,
        is_causal=is_causal, training=training)


def _host_lens(cu):
    if isinstance(cu, Tensor):
        cu = cu._data
    if isinstance(cu, torch.Tensor):
        cu = cu.detach().cpu().numpy()
    return np.asarray(cu).astype(np.int64)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        name=None):
    """Varlen (packed ragged) attention: query (total_q, H, D), key and
    value (total_k, KH, D) with KH dividing H; ``cu_seqlens_*`` (B+1,)
    delimit the sequences. The rows are repacked into a padded batch,
    attended by :func:`~paddle_tpu_torch.incubate.nn.functional.
    variable_length_memory_efficient_attention`, and packed back: the
    output holds the live rows only, (total_q, H, D). Returns
    ``(out, None)``."""
    from paddle_tpu_torch.incubate.nn.functional import (
        variable_length_memory_efficient_attention,
    )

    q = query._data if isinstance(query, Tensor) else torch.as_tensor(query)
    k = key._data if isinstance(key, Tensor) else torch.as_tensor(key)
    v = value._data if isinstance(value, Tensor) else torch.as_tensor(value)
    cq, ck = _host_lens(cu_seqlens_q), _host_lens(cu_seqlens_k)
    b = len(cq) - 1
    sq, sk = int(max_seqlen_q), int(max_seqlen_k)
    ql, kl = cq[1:] - cq[:-1], ck[1:] - ck[:-1]

    def padded(x, cu, lens, s):
        # row j of sequence i sits at packed row cu[i] + j (j < lens[i])
        rows = np.minimum(cu[:-1, None] + np.arange(s)[None, :],
                          max(x.shape[0] - 1, 0))
        live = np.arange(s)[None, :] < lens[:, None]
        idx = torch.from_numpy(rows.reshape(-1)).to(x.device)
        out = x.detach()[idx].reshape(b, s, *x.shape[1:])
        keep = torch.from_numpy(live).to(x.device)[:, :, None, None]
        return torch.where(keep, out, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))

    qb, kb, vb = padded(q, cq, ql, sq), padded(k, ck, kl, sk), \
        padded(v, ck, kl, sk)
    out = variable_length_memory_efficient_attention(
        qb.transpose(1, 2), kb.transpose(1, 2), vb.transpose(1, 2),
        torch.from_numpy(ql).to(q.device), torch.from_numpy(kl).to(q.device),
        scale=scale, causal=causal)
    od = out._data.transpose(1, 2)   # (B, Sq, H, D)
    live = np.arange(sq)[None, :] < ql[:, None]
    flat = torch.from_numpy(np.flatnonzero(live.reshape(-1))).to(q.device)
    packed = od.reshape(b * sq, *od.shape[2:])[flat]
    return Tensor._from_data(packed), None
