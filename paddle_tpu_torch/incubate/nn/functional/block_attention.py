"""Block / variable-length attention for serving (the port carries the
ragged variant; ``paged_attention`` and ``block_multihead_attention``
serve the bucketed path, which is not ported)."""
from __future__ import annotations

from paddle_tpu_torch.ops import ragged_paged_attention as _rpa

__all__ = ["ragged_paged_attention"]


def ragged_paged_attention(q, k_new, v_new, key_cache, value_cache,
                           block_tables, cu_seqlens, context_lens,
                           num_seqs, scale=None):
    """Unpadded prefill+decode attention over a concatenated token stream
    (``ops/ragged_paged_attention.py``). q/k_new/v_new: (T, H|KH, D)
    ragged-packed rows; cu_seqlens (S+1,) delimits sequence slots,
    context_lens (S,) is the post-step cache length per slot,
    block_tables (S, MB) the paged-cache indirection. Returns
    (out (T, H, D), key_cache, value_cache) — the caches are updated in
    place and returned."""
    return _rpa.ragged_paged_attention(
        q, k_new, v_new, key_cache, value_cache, block_tables, cu_seqlens,
        context_lens, num_seqs, scale=scale)
