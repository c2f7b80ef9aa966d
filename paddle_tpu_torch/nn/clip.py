"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``:
``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``).

Each clip has :meth:`clip_fn` over a list of gradients, which
``TrainStep`` calls (it reads the clip from ``optimizer._grad_clip``),
and ``__call__`` over ``(parameter, grad)`` pairs, which the eager
``Optimizer.step`` calls. Both scale the gradients IN PLACE (each in
f32, rounded back to its dtype once) and return them, with no host
sync."""
from __future__ import annotations

from typing import List

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


class ClipGradBase:
    def clip_fn(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    def __call__(self, params_grads):
        gs = [g for _, g in params_grads if g is not None]
        if not gs:
            return params_grads
        clipped = iter(self.clip_fn(gs))
        return [(p, g if g is None else next(clipped))
                for p, g in params_grads]


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def clip_fn(self, grads):
        for g in grads:
            g.clamp_(self.min, self.max)
        return grads


class ClipGradByNorm(ClipGradBase):
    """Each gradient on its own: scale = min(clip_norm / max(norm,
    1e-12), 1), the norm taken in f32."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def clip_fn(self, grads):
        for g in grads:
            norm = torch.linalg.vector_norm(g, dtype=torch.float32)
            g.mul_(torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                               max=1.0))
        return grads


class ClipGradByGlobalNorm(ClipGradBase):
    """scale = clip_norm / max(global_norm, clip_norm), the norm taken in
    f32 over every gradient."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    @staticmethod
    def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
        norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                             for g in grads])
        return norms.square().sum().sqrt()

    def clip_fn(self, grads):
        if not grads:
            return grads
        gn = self.global_norm(grads)
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        torch._foreach_mul_(grads, scale)
        return grads
