"""Functional layers of the port."""
from paddle_tpu_torch.nn.functional.flash_attention import (  # noqa: F401
    flash_attention, scaled_dot_product_attention,
)

__all__ = ["flash_attention", "scaled_dot_product_attention"]
