"""Serving-path attention functions."""
from paddle_tpu_torch.incubate.nn.functional.block_attention import (  # noqa: F401
    ragged_paged_attention,
)

__all__ = ["ragged_paged_attention"]
