"""Layers of the port."""
from paddle_tpu_torch.nn import functional  # noqa: F401
from paddle_tpu_torch.nn.clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
from paddle_tpu_torch.nn.norm import RMSNorm  # noqa: F401

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "RMSNorm", "functional"]
