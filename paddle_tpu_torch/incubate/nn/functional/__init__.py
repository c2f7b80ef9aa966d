"""Serving-path attention functions."""
from paddle_tpu_torch.incubate.nn.functional.block_attention import (  # noqa: F401
    block_multihead_attention, paged_attention, ragged_paged_attention,
    variable_length_memory_efficient_attention,
)

__all__ = ["ragged_paged_attention", "block_multihead_attention",
           "paged_attention", "variable_length_memory_efficient_attention"]
