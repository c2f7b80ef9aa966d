"""Layers of the port."""
from paddle_tpu_torch.nn.norm import RMSNorm, rms_norm  # noqa: F401

__all__ = ["RMSNorm", "rms_norm"]
