"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``
``ClipGradByGlobalNorm``)."""
from __future__ import annotations

from typing import List

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    """scale = clip_norm / max(global_norm, clip_norm), the norm taken in
    f32 over every gradient. :meth:`clip_fn` is what ``TrainStep`` calls
    (it reads the clip from ``optimizer._grad_clip``)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    @staticmethod
    def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
        norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                             for g in grads])
        return norms.square().sum().sqrt()

    def clip_fn(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Scales ``grads`` IN PLACE (each in f32, rounded back to its
        dtype once) and returns them; no host sync."""
        if not grads:
            return grads
        gn = self.global_norm(grads)
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        torch._foreach_mul_(grads, scale)
        return grads
