"""paddle_tpu_torch.distributed — hybrid-parallel training over
``torch.distributed`` (port of ``paddle_tpu/distributed/``).

One process per rank: :func:`init_parallel_env` joins the world (NCCL
with a card per rank, gloo on the CPU or when the ranks share a card), a
:class:`ProcessMesh` names the ranks' grid, and
:class:`ParallelTrainStep` trains a model at dp x mp with ZeRO stages
1-3, sequence parallelism and recompute, context parallelism (a model
that declares its sequence axis, the Llama's ``context_parallel`` over
``ops.ring_attention``) and expert parallelism (``incubate.moe``);
``fleet.pp_engine.PipelineTrainStep`` adds the pipeline
(``fleet.pipeline_parallel``).
The collectives, the topology, the fleet facade, ``DataParallel``, the
stores, the checkpoints, the layout algebra (``redistribute``) and the
semi-auto API (``api.py``: ``shard_tensor``, ``reshard``,
``shard_optimizer``, ``DistModel``, ...) are here too.

The launcher (``python -m paddle_tpu_torch.distributed.launch``, with
elastic ``--nnodes min:max``), the gang watchdog
(``distributed.watchdog``) and the auto-tuner (``auto_tuner``) are here
too. Not ported yet, raising with the part of the port that brings it:
``io`` (slice E3: it saves the persistables of a static Program).
"""
from paddle_tpu_torch.distributed.env import (  # noqa: F401
    ParallelEnv, get_rank, get_world_size, init_parallel_env, is_initialized,
)
from paddle_tpu_torch.distributed.mesh import (  # noqa: F401
    Partial, Placement, ProcessMesh, Replicate, Shard, auto_mesh,
    create_hybrid_mesh, get_mesh, init_mesh, set_mesh,
)
from paddle_tpu_torch.distributed.communication import (  # noqa: F401
    Group, ReduceOp, all_gather, all_gather_object, all_reduce, all_to_all,
    barrier, broadcast, get_group, irecv, isend, new_group, recv, reduce,
    reduce_scatter, scatter, send, shift, stream,
)
from paddle_tpu_torch.distributed.store import FileStore, Store  # noqa: F401
from paddle_tpu_torch.distributed.redistribute import (  # noqa: F401
    Layout, redistribute, redistribute_host,
)
from paddle_tpu_torch.distributed.topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, ParallelMode,
)
from paddle_tpu_torch.distributed import checkpoint  # noqa: F401
from paddle_tpu_torch.distributed import fleet  # noqa: F401
from paddle_tpu_torch.distributed.parallel_wrapper import (  # noqa: F401
    DataParallel,
)
from paddle_tpu_torch.distributed.engine import (  # noqa: F401
    ParallelConfig, ParallelTrainStep, shard_model_parameters,
)
from paddle_tpu_torch.distributed.compat import (  # noqa: F401
    CountFilterEntry, DistAttr, InMemoryDataset, ProbabilityEntry,
    QueueDataset, ReduceType, ShowClickEntry, Strategy, alltoall,
    alltoall_single, broadcast_object_list, destroy_process_group,
    dtensor_from_fn, gather, get_backend, gloo_barrier,
    gloo_init_parallel_env, gloo_release, is_available,
    load_state_dict, save_state_dict, scatter_object_list,
    shard_scaler, spawn, split, wait,
)


from paddle_tpu_torch.distributed.api import (  # noqa: F401
    DistModel, ShardDataloader, ShardingStage1, ShardingStage2,
    ShardingStage3, dtensor_from_local, dtensor_to_local, reshard,
    shard_dataloader, shard_layer, shard_optimizer, shard_tensor, to_static,
    unshard_dtensor,
)


def _waits(name: str, part: str):
    def refused(*args, **kwargs):
        raise NotImplementedError(
            f"paddle_tpu_torch.{name} is not ported yet; it comes with "
            f"slice {part}")

    refused.__name__ = name.rsplit(".", 1)[-1]
    return refused


class _Waiting:
    """A name (``<namespace>.<name>`` under the package) whose class or
    module waits for a later part of the port: any use of it raises
    ``NotImplementedError`` naming the part."""

    def __init__(self, name: str, part: str):
        self._name, self._part = name, part

    def __call__(self, *args, **kwargs):
        _waits(self._name, self._part)()

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        _waits(f"{self._name}.{attr}", self._part)()


from paddle_tpu_torch.distributed import launch  # noqa: F401,E402

# distributed io saves a static Program's persistables: it comes with
# static/ (slice E3)
io = _Waiting("distributed.io", "E3 (static/, then distributed/io.py)")
