"""Hybrid-parallel topology (port of ``paddle_tpu/distributed/topology.py``).

Reference: python/paddle/distributed/fleet/base/topology.py —
CommunicateTopology:65 and HybridCommunicateGroup:178 build the
dp/mp/pp/sep/sharding groups from an N-D rank grid.

The rank-grid bookkeeping is the JAX package's, array-free and copied.
Each group is bound to its torch process group
(:class:`~paddle_tpu_torch.distributed.communication.Group`): a rank
makes the groups it is a member of, and each group's members make it
together. Outside a world the groups carry their ranks and no torch
group, so the bookkeeping runs in one process.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from paddle_tpu_torch.distributed import env as dist_env
from paddle_tpu_torch.distributed.communication import new_group
from paddle_tpu_torch.distributed.mesh import ProcessMesh

__all__ = ["ParallelMode", "CommunicateTopology", "HybridCommunicateGroup"]


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4


class CommunicateTopology:
    def __init__(self, hybrid_group_names: Sequence[str] = ("data", "pipe",
                                                            "sharding",
                                                            "sep", "model"),
                 dims: Sequence[int] = (1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = None
        self._world_size = int(np.prod(self._dims))
        ranks = np.arange(self._world_size).reshape(self._dims)
        self._rank_grid = ranks
        self._coord_of_rank = {
            int(ranks[c]): c for c in np.ndindex(*self._dims)
        }

    def get_hybrid_group_names(self) -> List[str]:
        return list(self._parallel_names)

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world_size

    def get_rank(self, **kwargs) -> int:
        coord = tuple(kwargs[n] for n in self._parallel_names)
        return int(self._rank_grid[coord])

    def get_coord(self, rank: int):
        return self._coord_of_rank[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        axis = self._parallel_names.index(axis_name)
        sl = [slice(None)] * len(self._dims)
        sl[axis] = index
        return sorted(int(r) for r in self._rank_grid[tuple(sl)].reshape(-1))

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """All groups along ``axis_name``: one list of ranks per combination
        of the other axes."""
        axis = self._parallel_names.index(axis_name)
        other_dims = [d for i, d in enumerate(self._dims) if i != axis]
        comm_list = []
        for combo in np.ndindex(*other_dims):
            idx = list(combo)
            sl = []
            k = 0
            for i in range(len(self._dims)):
                if i == axis:
                    sl.append(slice(None))
                else:
                    sl.append(idx[k])
                    k += 1
            comm_list.append([int(r) for r in
                              self._rank_grid[tuple(sl)].reshape(-1)])
        return comm_list

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        coord = list(self.get_coord(global_rank))
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return int(self._rank_grid[tuple(coord)])


class HybridCommunicateGroup:
    """Builds the dp/mp/pp/sharding/sep groups for this rank. Every
    group along axis X carries the mesh axis name X and its torch
    process group; :attr:`mesh` is the rank grid as a
    :class:`~paddle_tpu_torch.distributed.mesh.ProcessMesh`."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.global_rank = dist_env.get_rank()
        self._dp_degree = topology.get_dim("data")
        self._mp_degree = topology.get_dim("model")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep") \
            if "sep" in topology.get_hybrid_group_names() else 1

        names = topology.get_hybrid_group_names()
        dims = [topology.get_dim(n) for n in names]
        axis_rename = {"data": "dp", "pipe": "pp", "model": "mp",
                       "sharding": "sharding", "sep": "sep"}
        self.mesh = ProcessMesh(
            np.arange(int(np.prod(dims))).reshape(dims),
            dim_names=[axis_rename.get(n, n) for n in names])

        coord = topology.get_coord(self.global_rank) \
            if self.global_rank < topology.world_size() else \
            tuple(0 for _ in dims)
        self._coord = dict(zip(names, coord))

        def make(axis):
            # the group along ``axis`` containing this rank; falls back to
            # the first group along the axis if this rank is out of grid
            grp_ranks = [r for r in topology.get_comm_list(axis)
                         if self.global_rank in r]
            ranks = grp_ranks[0] if grp_ranks else \
                topology.get_comm_list(axis)[0]
            return new_group(ranks, axis_name=axis_rename.get(axis, axis),
                             mesh=self.mesh)

        self._dp_group = make("data")
        self._mp_group = make("model")
        self._pp_group = make("pipe")
        self._sharding_group = make("sharding")
        self._sep_group = make("sep") if self._sep_degree > 1 else None
        # dp+sharding fused group for param sync (reference
        # topology.py get_fused_ranks): ranks whose coords match this
        # rank's on every axis EXCEPT data and sharding
        fused_axes = {"data", "sharding"}
        my = self._coord
        fused_ranks = []
        for r in range(topology.world_size()):
            c = dict(zip(names, topology.get_coord(r)))
            if all(c[a] == my.get(a, 0) for a in names
                   if a not in fused_axes):
                fused_ranks.append(r)
        self._dp_sharding_fused = new_group(
            sorted(fused_ranks), axis_name="dp_sharding", mesh=self.mesh)

        # register TP rng streams so dropout differs across mp ranks
        from paddle_tpu_torch.core.generator import get_rng_tracker
        tracker = get_rng_tracker()
        if "local_seed" not in tracker.states():
            try:
                tracker.add("local_seed", 2718 + self._coord.get("model", 0))
                tracker.add("global_seed", 1234)
            except ValueError:
                pass

    # -- parallel mode ---------------------------------------------------
    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return ParallelMode.PIPELINE_PARALLEL
        if self._mp_degree > 1:
            return ParallelMode.TENSOR_PARALLEL
        if self._sharding_degree > 1:
            return ParallelMode.SHARDING_PARALLEL
        if self._sep_degree > 1:
            return ParallelMode.SEGMENT_PARALLEL
        return ParallelMode.DATA_PARALLEL

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    # -- degree / rank / group accessors (reference API) ------------------
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_rank(self):
        return self._coord.get("data", 0)

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_rank(self):
        return self._coord.get("model", 0)

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_stage_id(self):
        return self._coord.get("pipe", 0)

    def get_pipe_parallel_group(self):
        return self._pp_group

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_rank(self):
        return self._coord.get("sharding", 0)

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_rank(self):
        return self._coord.get("sep", 0)

    def get_sep_parallel_group(self):
        return self._sep_group

    def get_check_parallel_group(self, *a, **k):
        return self._mp_group

    def get_rank_from_stage(self, stage_id, **kwargs):
        return self._topo.get_rank_from_stage(self.global_rank,
                                              pipe=stage_id, **kwargs)
