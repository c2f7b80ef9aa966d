"""RMSNorm (port of ``ops/nn_ops.py::rms_norm`` and
``nn/norm.py::RMSNorm``)."""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.core.op import op

__all__ = ["rms_norm", "RMSNorm"]


@op
def rms_norm(x, weight=None, epsilon=1e-6):
    """Same order as the JAX op: normalise in f32, cast back to the
    input dtype, then multiply by the weight."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(dt)
    if weight is not None:
        out = out * weight
    return out


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, epsilon=self.epsilon)
