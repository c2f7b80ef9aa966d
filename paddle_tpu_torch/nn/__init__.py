"""Layers of the port."""
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm  # noqa: F401
from paddle_tpu_torch.nn.norm import RMSNorm, rms_norm  # noqa: F401

__all__ = ["ClipGradByGlobalNorm", "RMSNorm", "rms_norm"]
