"""Optimizers of the port."""
from paddle_tpu_torch.optimizer.optimizer import (  # noqa: F401
    Adam, AdamW, Optimizer,
)

__all__ = ["Optimizer", "Adam", "AdamW"]
