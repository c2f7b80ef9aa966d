"""Layers of the port."""
from paddle_tpu_torch.nn.clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
from paddle_tpu_torch.nn.norm import RMSNorm, rms_norm  # noqa: F401

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "RMSNorm", "rms_norm"]
