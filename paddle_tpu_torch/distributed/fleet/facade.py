"""fleet.init / distributed_model / distributed_optimizer (port of
``paddle_tpu/distributed/fleet/facade.py``).

Reference: python/paddle/distributed/fleet/fleet.py (init:283,
_init_hybrid_parallel_env:599), model.py:32 (wrapper selection :140-170),
base/distributed_strategy.py (DistributedStrategy over
distributed_strategy.proto's 33 messages — here a plain config object with
the same field names).

A ``PipelineLayer`` at pp > 1 comes back as a ``PipelineParallel`` (the
pipeline runner); every other model is returned as it is, marked with
the hybrid group (the parallel step shards it).
"""
from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.distributed.topology import (
    CommunicateTopology, HybridCommunicateGroup,
)

__all__ = ["DistributedStrategy", "init", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group", "fleet"]


class DistributedStrategy:
    """Config holder matching the reference's strategy surface
    (hybrid_configs, amp, recompute, sharding, pipeline...)."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0, "use_pure_bf16":
                            False}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "degree": 1}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "schedule_mode": "1F1B",
                                 "micro_batch_size": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1}
        self.find_unused_parameters = False
        self.fuse_grad_size_in_MB = 32
        self.gradient_scale_configs = {"scale_strategy": "avg"}

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


class _Fleet:
    def __init__(self):
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._is_initialized = False

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO"):
        from paddle_tpu_torch.distributed import env as dist_env

        dist_env.init_parallel_env()
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        topo = CommunicateTopology(
            hybrid_group_names=["data", "pipe", "sharding", "sep", "model"],
            dims=[hc.get("dp_degree", 1), hc.get("pp_degree", 1),
                  hc.get("sharding_degree", 1), hc.get("sep_degree", 1),
                  hc.get("mp_degree", 1)])
        self._hcg = HybridCommunicateGroup(topo)
        self._is_initialized = True
        return self

    def get_hybrid_communicate_group(self) -> HybridCommunicateGroup:
        if self._hcg is None:
            self.init()
        return self._hcg

    @property
    def worker_num(self):
        from paddle_tpu_torch.distributed import env as dist_env
        return dist_env.get_world_size()

    @property
    def worker_index(self):
        from paddle_tpu_torch.distributed import env as dist_env
        return dist_env.get_rank()

    def distributed_model(self, model):
        """Select the parallel wrapper (reference model.py:140-170): the
        model marked with the hcg; tensor parallelism and ZeRO come from
        ``ParallelTrainStep``, and a ``PipelineLayer`` at pp > 1 is
        wrapped in ``PipelineParallel``."""
        hcg = self.get_hybrid_communicate_group()
        model._hcg = hcg
        from paddle_tpu_torch.distributed.fleet.pipeline_parallel import (
            PipelineLayer, PipelineParallel)

        if hcg.get_pipe_parallel_world_size() > 1 and isinstance(
                model, PipelineLayer):
            return PipelineParallel(model, hcg, self._strategy)
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        hcg = self.get_hybrid_communicate_group()
        optimizer._hcg = hcg
        return optimizer


fleet = _Fleet()


def init(role_maker=None, is_collective=True, strategy=None, **kw):
    return fleet.init(role_maker, is_collective, strategy, **kw)


def distributed_model(model):
    return fleet.distributed_model(model)


def distributed_optimizer(optimizer, strategy=None):
    return fleet.distributed_optimizer(optimizer, strategy)


def get_hybrid_communicate_group():
    return fleet.get_hybrid_communicate_group()
