"""Attention entry points (port of ``paddle_tpu/ops/pallas_attention.py``
``flash_attention``, ``paddle_tpu/nn/functional/flash_attention.py``
``flash_attention`` and the SDPA emitter of ``paddle_tpu/ops/nn_ops.py``).

Layout: [batch, seq, heads, head_dim]. Every dropout-free call goes to
the flash op (:func:`paddle_tpu_torch.ops.flash_attention.flash_attention_data`:
the hand-written kernels on the card, their plain versions on the CPU),
whatever the sequence lengths; the JAX dispatcher sends shapes its TPU
blocks do not tile to SDPA instead. ``dropout > 0`` keeps the JAX route:
plain attention with dropout, drawn from an explicit generator.
``flash_attn_unpadded`` is not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.core.op import op
from paddle_tpu_torch.ops.flash_attention import flash_attention_data

__all__ = ["flash_attention", "scaled_dot_product_attention"]


@op
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True,
                                 generator: Optional[torch.Generator] = None):
    """Plain attention, as the JAX emitter computes it: scores in the
    inputs' dtype, masked entries set to -1e9 (causal bottom-right
    aligned; a bool ``attn_mask`` selects, any other is added), softmax
    in f32 cast back, then dropout with ``generator`` (required when
    ``dropout_p > 0`` and ``training``)."""
    q = query.transpose(1, 2)
    k = key.transpose(1, 2)
    v = value.transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    neg = torch.tensor(-1e9, dtype=scores.dtype, device=scores.device)
    if is_causal:
        sq, sk = scores.shape[-2:]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=scores.device).tril(sk - sq)
        scores = torch.where(causal, scores, neg)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores, neg)
        else:
            scores = scores + attn_mask
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        if generator is None:
            raise ValueError("attention dropout draws from an explicit "
                             "torch.Generator: pass generator=")
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return torch.matmul(probs, v).transpose(1, 2)


@op
def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    training=True, name=None,
                    generator: Optional[torch.Generator] = None):
    """paddle.nn.functional.flash_attention: returns ``(out, None)``, as
    the JAX package does (``return_softmax`` and ``fixed_seed_offset``
    are accepted and ignored there too)."""
    if dropout > 0.0:
        out = scaled_dot_product_attention(
            query, key, value, is_causal=causal, dropout_p=dropout,
            training=training, generator=generator)
    else:
        out = flash_attention_data(query, key, value, causal=causal)
    return out, None
