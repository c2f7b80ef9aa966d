"""Fleet gradient-sync utilities (port of
``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``).

Reference: python/paddle/distributed/fleet/utils/hybrid_parallel_util.py
(broadcast_mp_parameters:213, broadcast_dp_parameters:221,
fused_allreduce_gradients:241) and tensor_fusion_helper.py
(fused_parameters:797).

The wrapper-time parameter broadcasts that align the replicas, and the
manual fused gradient all-reduce of a hybrid training loop: the
gradients of one dtype are flattened into one bucket (or a few, of
``bucket_mb`` each), reduced in one collective and split back.
"""
from __future__ import annotations

from typing import List

import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.distributed import communication as comm

__all__ = [
    "broadcast_dp_parameters", "broadcast_mp_parameters",
    "broadcast_sharding_parameters", "fused_allreduce_gradients",
    "fused_parameters",
]


def _data(p) -> torch.Tensor:
    return p._data if isinstance(p, Tensor) else p


def _grad(p):
    """A parameter's gradient as a torch tensor, or None."""
    return _data(p).grad


def _broadcast_params(params: List, group):
    """Every parameter takes the value of the group's first rank's."""
    if group is None or getattr(group, "nranks", 1) <= 1:
        return
    src = group.ranks[0]
    for p in params:
        comm.broadcast_(_data(p).data, src, group)


def broadcast_dp_parameters(model, hcg):
    """reference hybrid_parallel_util.py:221"""
    _broadcast_params(list(model.parameters()),
                      hcg.get_data_parallel_group())


def broadcast_mp_parameters(model, hcg):
    """reference hybrid_parallel_util.py:213 — aligns the NON-sharded
    (replicated) parameters across the tensor-parallel group; sharded
    mp params (is_distributed) are intentionally left alone."""
    group = hcg.get_model_parallel_group()
    params = [p for p in model.parameters()
              if not getattr(p, "is_distributed", False)
              and "mp" not in (getattr(p, "_placement_hints", None) or {})]
    _broadcast_params(params, group)


def broadcast_sharding_parameters(model, hcg):
    """reference hybrid_parallel_util.py (sharding group variant)."""
    group = hcg.get_sharding_parallel_group() \
        if hasattr(hcg, "get_sharding_parallel_group") else None
    _broadcast_params(list(model.parameters()), group)


def fused_allreduce_gradients(parameter_list, hcg=None, group=None,
                              bucket_mb: float = 25.0, scale=None):
    """Average the gradients over the data-parallel group (``scale``,
    default 1/n, times the sum): the gradients of one dtype flattened
    into buckets of about ``bucket_mb``, one all-reduce each (in f32 for
    16-bit gradients, rounded once), split back in place."""
    group = group if group is not None else (
        hcg.get_data_parallel_group() if hcg is not None else None)
    if group is None or getattr(group, "nranks", 1) <= 1:
        return
    if scale is None:
        scale = 1.0 / group.nranks
    by_dtype = {}
    for p in parameter_list:
        g = _grad(p)
        if g is not None:
            by_dtype.setdefault(g.dtype, []).append(g)
    comm.all_reduce_into([g for grads in by_dtype.values() for g in grads],
                         group, scale, int(bucket_mb * 1024 * 1024))


def fused_parameters(parameters, use_main_grad=False, fuse_param=True,
                     comm_overlap=False, comm_group=None, act=None,
                     dst=-1, scale_after_comm=False, group_params=False,
                     apply_decay_param_fun=None):
    """The dtype-grouped parameter buckets (the flat-storage planning
    step of tensor_fusion_helper.fused_parameters): one list per dtype,
    in first-seen order."""
    by_dtype = {}
    for p in parameters:
        by_dtype.setdefault(str(_data(p).dtype), []).append(p)
    return list(by_dtype.values())
