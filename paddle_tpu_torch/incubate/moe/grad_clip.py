"""MoE-aware global-norm gradient clipping (port of
``paddle_tpu/incubate/moe/grad_clip.py``).

``ClipGradForMOEByGlobalNorm`` takes one global norm over two buckets:
the normal parameters' gradients and the experts' (``is_expert_param_func``
picks them). Used eagerly on a rank of expert parallelism, where each
rank holds the gradients of its own experts, the experts' squared norm is
all-reduced over ``moe_group`` before it joins the normal parameters'
(counted once): Paddle's semantics, which the JAX package's global view
makes implicit. Inside ``ParallelTrainStep`` the step's clip takes the
norm itself (a ``ClipGradByGlobalNorm``), summing each squared norm over
the groups that shard its gradient.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.distributed import communication as comm
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

__all__ = ["ClipGradForMOEByGlobalNorm"]


def _sum_sq(grads) -> torch.Tensor:
    tot = torch.zeros((), dtype=torch.float32)
    for g in grads:
        tot = tot.to(g.device) + torch.linalg.vector_norm(
            g, dtype=torch.float32).square()
    return tot


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    def __init__(self, clip_norm, is_expert_param_func=None,
                 moe_group=None, group_name="default_moe_group"):
        super().__init__(clip_norm)
        self.is_expert_param_func = is_expert_param_func
        self.moe_group = moe_group
        self.group_name = group_name

    def _split(self, params_grads):
        normal, expert = [], []
        for p, g in params_grads:
            if g is None:
                continue
            d = g._data if isinstance(g, Tensor) else g
            if self.is_expert_param_func is not None and \
                    self.is_expert_param_func(p):
                expert.append(d)
            else:
                normal.append(d)
        return normal, expert

    def norms(self, params_grads):
        """(the normal parameters' squared norm, the experts' summed over
        ``moe_group``) in f32."""
        normal, expert = self._split(params_grads)
        expert_sq = _sum_sq(expert).reshape(1)
        if self.moe_group is not None and self.moe_group.nranks > 1:
            comm.all_reduce_(expert_sq, comm.ReduceOp.SUM, self.moe_group)
        return _sum_sq(normal), expert_sq[0]

    @torch.no_grad()
    def __call__(self, params_grads):
        norm_sq, expert_sq = self.norms(params_grads)
        norm = (norm_sq.to(expert_sq.device) + expert_sq).sqrt()
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        for _, g in params_grads:
            if g is not None:
                d = g._data if isinstance(g, Tensor) else g
                d.copy_((d.float() * scale).to(d.dtype))
        return params_grads
