"""``paddle.distributed`` namespace completion (port of
``paddle_tpu/distributed/compat.py``): collective aliases and object
collectives, process helpers, the auto-parallel config types, and the
parameter-server stubs the JAX package refuses.

The object collectives pickle through ``torch.distributed``'s own
object collectives; :func:`gather` gives every member the gathered list,
as the JAX package's does; :func:`spawn` starts processes with the
launcher's env protocol (:func:`~paddle_tpu_torch.distributed.env.
init_parallel_env` reads it).
"""
from __future__ import annotations

from typing import List

import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.distributed import communication as comm

__all__ = [
    "alltoall", "alltoall_single", "gather", "wait", "get_backend",
    "is_available", "destroy_process_group", "broadcast_object_list",
    "scatter_object_list", "spawn", "shard_scaler", "dtensor_from_fn",
    "DistAttr", "ReduceType", "Strategy", "gloo_init_parallel_env",
    "gloo_barrier", "gloo_release", "split", "InMemoryDataset",
    "QueueDataset", "ProbabilityEntry", "CountFilterEntry",
    "ShowClickEntry", "save_state_dict", "load_state_dict",
]


# ---------------------------------------------------------------------------
# collective aliases / variants
# ---------------------------------------------------------------------------
def alltoall(out_tensor_list, in_tensor_list=None, group=None,
             sync_op=True):
    """The list form of all_to_all."""
    return comm.all_to_all(out_tensor_list, in_tensor_list, group=group,
                           sync_op=sync_op)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Single-tensor all-to-all: dim 0 is split evenly across the ranks
    (uneven splits are refused, as the JAX package refuses them)."""
    if in_split_sizes is not None or out_split_sizes is not None:
        raise NotImplementedError(
            "alltoall_single with uneven split sizes is not supported "
            "(the JAX package's all_to_all requires equal splits)")
    g = comm._group(group)
    data = comm._data(in_tensor)
    outs = comm.all_to_all_list(list(data.chunk(g.nranks)), g)
    res = torch.cat(outs)
    if out_tensor is None:
        return Tensor._from_data(res) if isinstance(in_tensor, Tensor) \
            else res
    return comm._set(out_tensor, res)


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every member gets the gathered list (the JAX package's reading);
    ``dst`` names where the reference would gather it."""
    out: List = []
    comm.all_gather(out, tensor, group=group, sync_op=sync_op)
    if gather_list is not None:
        gather_list.clear()
        gather_list.extend(out)
        return gather_list
    return out


def wait(tensor, group=None, use_calc_stream=True):
    """Wait for the work queued on the tensor's device."""
    d = comm._data(tensor)
    if isinstance(d, torch.Tensor) and d.is_cuda:
        torch.cuda.current_stream(d.device).synchronize()
    return tensor


def get_backend(group=None) -> str:
    """The group's backend: ``"nccl"`` or ``"gloo"`` (``"gloo"`` outside
    a world, where the one-rank world would be)."""
    g = comm._group(group)
    if g.process_group is None:
        if comm._world_up():
            return str(torch.distributed.get_backend())
        return "gloo"
    return g.backend


def is_available() -> bool:
    import torch.distributed as dist

    return dist.is_available()


def destroy_process_group(group=None):
    """Tear down the world (or drop one group) and forget the groups."""
    import torch.distributed as dist

    if group is not None:
        if group.process_group is not None and \
                group.process_group is not dist.group.WORLD:
            dist.destroy_process_group(group.process_group)
            comm._pgs.pop(tuple(sorted(group.ranks)), None)
        comm._groups.pop(group.id, None)
        return
    comm._reset()
    if comm._world_up():
        from paddle_tpu_torch.distributed import store, watchdog

        # the gang record's readers stop before the world's store goes
        watchdog.release_store()
        store._store = None
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# object collectives
# ---------------------------------------------------------------------------
def broadcast_object_list(object_list, src=0, group=None):
    """``object_list`` takes global rank ``src``'s objects, in place."""
    g = comm._group(group)
    if g.nranks == 1 or g.process_group is None:
        return object_list
    torch.distributed.broadcast_object_list(object_list, src=src,
                                            group=g.process_group)
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """``out_object_list`` takes this member's object of global rank
    ``src``'s ``in_object_list`` (the group's order)."""
    g = comm._group(group)
    if g.nranks == 1 or g.process_group is None:
        out_object_list[:] = list(in_object_list or [])[:1]
        return out_object_list
    gathered: List = []
    comm.all_gather_object(gathered, in_object_list or [], group=g)
    objs = gathered[g.ranks.index(src)]
    me = g.rank()
    out_object_list[:] = [objs[me]] if me < len(objs) else []
    return out_object_list


# ---------------------------------------------------------------------------
# process helpers
# ---------------------------------------------------------------------------
def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start ``nprocs`` processes of ``func(*args)``, each with the
    launcher's env protocol (rank, world size, rendezvous address on the
    loopback interface); with ``join``, wait for them and raise if one
    failed."""
    import multiprocessing as mp
    import os
    import socket

    if nprocs <= 0:
        nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nprocs),
            "PADDLE_MASTER": f"127.0.0.1:{port}",
            "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port),
            "PADDLE_LOCAL_RANK": str(rank),
            "PADDLE_LOCAL_SIZE": str(nprocs),
        }
        p = ctx.Process(target=_spawn_entry, args=(func, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"spawned workers failed: {bad}")
    return procs


def _spawn_entry(func, args, env):
    import os

    os.environ.update(env)
    func(*args)


def shard_scaler(scaler):
    """The scaler as it is: ``ParallelTrainStep`` agrees on ``found_inf``
    across the ranks itself."""
    return scaler


def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    """Build a tensor by calling ``fn`` then shard it (reference
    dtensor_from_fn, auto_parallel/api.py)."""
    from paddle_tpu_torch.distributed.api import shard_tensor

    return shard_tensor(fn(*args, **kwargs), mesh, placements)


# ---------------------------------------------------------------------------
# auto-parallel config types
# ---------------------------------------------------------------------------
class ReduceType:
    """Reference phi ReduceType enum (placement_types.h)."""

    kRedSum = "sum"
    kRedMax = "max"
    kRedMin = "min"
    kRedProd = "prod"
    kRedAvg = "avg"
    kRedAny = "any"
    kRedAll = "all"


class DistAttr:
    """Tensor distribution attributes: mesh + per-dim sharding."""

    def __init__(self, mesh=None, sharding_specs=None):
        self.process_mesh = mesh
        self.sharding_specs = list(sharding_specs or [])

    def __repr__(self):
        return (f"DistAttr(mesh={self.process_mesh}, "
                f"specs={self.sharding_specs})")


class _Toggle:
    def __init__(self, **kw):
        self.enable = False
        self.__dict__.update(kw)


class Strategy:
    """Auto-parallel strategy config (reference distributed.Strategy):
    the toggles the semi-auto API reads."""

    def __init__(self, config=None):
        self.sharding = _Toggle(stage=1, degree=-1)
        self.amp = _Toggle(dtype="bfloat16", level="O1")
        self.recompute = _Toggle()
        self.pipeline = _Toggle(schedule_mode="1F1B", micro_batch_size=1,
                                accumulate_steps=1)
        self.fused_passes = _Toggle(fused_passes_list=[])
        if config:
            for k, v in dict(config).items():
                setattr(self, k, v)


# ---------------------------------------------------------------------------
# gloo compat (the CPU backend)
# ---------------------------------------------------------------------------
def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """CPU bootstrap: :func:`~paddle_tpu_torch.distributed.env.
    init_parallel_env` with the given rank, world and endpoint."""
    import os

    os.environ.setdefault("PADDLE_TRAINER_ID", str(rank_id))
    os.environ.setdefault("PADDLE_TRAINERS_NUM", str(rank_num))
    os.environ.setdefault("PADDLE_MASTER", server_endpoint)
    from paddle_tpu_torch.distributed.env import init_parallel_env

    return init_parallel_env()


def gloo_barrier():
    comm.barrier()


def gloo_release():
    destroy_process_group()


# ---------------------------------------------------------------------------
# legacy static-graph model-parallel splitter + PS-stack stubs
# ---------------------------------------------------------------------------
def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    raise NotImplementedError(
        "paddle.distributed.split is the legacy static-graph "
        "model-parallel splitter; use fleet.meta_parallel "
        "Column/Row/VocabParallelLinear|Embedding (eager/compiled TP) "
        "or dist.shard_tensor + GSPMD for the same partitioning")


class _PSStub:
    _WHAT = "this class"

    def __init__(self, *a, **k):
        raise NotImplementedError(
            f"{self._WHAT} belongs to the parameter-server training "
            "stack, which this TPU build deliberately excludes (see "
            "README 'Scope': synchronous mesh parallelism replaces the "
            "brpc PS architecture)")


class InMemoryDataset(_PSStub):
    _WHAT = "InMemoryDataset"


class QueueDataset(_PSStub):
    _WHAT = "QueueDataset"


class ProbabilityEntry(_PSStub):
    _WHAT = "ProbabilityEntry"


class CountFilterEntry(_PSStub):
    _WHAT = "CountFilterEntry"


class ShowClickEntry(_PSStub):
    _WHAT = "ShowClickEntry"


from paddle_tpu_torch.distributed.checkpoint import (  # noqa: E402,F401
    load_state_dict, save_state_dict,
)
