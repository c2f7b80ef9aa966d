"""Device and dtype resolution."""
from paddle_tpu_torch.core.device import resolve_device  # noqa: F401
from paddle_tpu_torch.core.dtype import to_torch  # noqa: F401

__all__ = ["resolve_device", "to_torch"]
