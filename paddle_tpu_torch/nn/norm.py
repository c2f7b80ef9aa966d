"""RMSNorm (port of ``nn/norm.py::RMSNorm``) over the raw
:func:`paddle_tpu_torch.ops.nn_ops.rms_norm` (the JAX op's order)."""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.ops.nn_ops import rms_norm

__all__ = ["rms_norm", "RMSNorm"]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, epsilon=self.epsilon)
