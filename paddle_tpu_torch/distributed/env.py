"""Process-level distributed environment (port of
``paddle_tpu/distributed/env.py``).

The launcher's env protocol is the reference's: ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM`` and ``PADDLE_MASTER`` (or ``RANK``,
``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``). The JAX package hands
them to ``jax.distributed.initialize``; here
:func:`init_parallel_env` hands them to
``torch.distributed.init_process_group``, one process per rank.

Where a rank runs, and so the backend: on the CPU every rank, over gloo;
on the card rank r takes ``cuda:<local rank>`` and the world is NCCL,
which needs a card for each rank of the host (a ``ValueError`` names the
shortfall, as :func:`paddle_tpu_torch.serving.tp.rank_devices` does).
Inside :func:`paddle_tpu_torch.testing.tp_hooks.ranks_share_one_device`
every rank takes the first card and the world is gloo, since NCCL takes
one rank per card. The backend follows where the ranks sit, never a
caught error.

Without a world in the environment, :func:`init_parallel_env` starts a
one-rank gloo world on an in-memory store, so that the default group,
its store and the collectives exist at degree 1. Once joined, it starts
the default watchdog's abort watch (a no-op without a step timeout).

``python -m paddle_tpu_torch.distributed.launch`` sets the protocol,
and ``PADDLE_LOCAL_SIZE`` (its ``--nproc_per_node``), which places rank
r of a node on ``cuda:<local rank>``.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch

__all__ = ["get_rank", "get_world_size", "is_initialized",
           "init_parallel_env", "ParallelEnv", "rank_device",
           "world_backend", "GROUP_TIMEOUT_S"]

# seconds a collective (or the rendezvous) waits for a rank; a rank that
# died or hangs fails the others' collectives within it
GROUP_TIMEOUT_S = 120.0

_state = {"device": None}


def _dist():
    import torch.distributed as dist

    return dist


def _env_int(*names) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def get_rank() -> int:
    """The launcher's ``PADDLE_TRAINER_ID``, else the rank of the
    initialized world, else 0."""
    r = _env_int("PADDLE_TRAINER_ID")
    if r is not None:
        return r
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def get_world_size() -> int:
    """The launcher's ``PADDLE_TRAINERS_NUM``, else the initialized
    world's size, else 1."""
    n = _env_int("PADDLE_TRAINERS_NUM")
    if n is not None:
        return n
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def rank_device(local_rank: int, local_world: int) -> torch.device:
    """The device of a rank: the CPU when no card is visible; the first
    card for every rank inside ``ranks_share_one_device``; else
    ``cuda:<local_rank>``, which needs ``local_world`` visible cards."""
    from paddle_tpu_torch.testing import tp_hooks

    if not torch.cuda.is_available():
        return torch.device("cpu")
    if tp_hooks.shared_device():
        return torch.device("cuda", 0)
    n = torch.cuda.device_count()
    if n < local_world:
        raise ValueError(f"{local_world} ranks on this host need "
                         f"{local_world} devices, {n} visible")
    return torch.device("cuda", local_rank)


def world_backend(device: torch.device) -> str:
    """NCCL when each rank has its own card, gloo on the CPU or when the
    ranks share one card."""
    from paddle_tpu_torch.testing import tp_hooks

    if device.type == "cuda" and not tp_hooks.shared_device():
        return "nccl"
    return "gloo"


def current_device() -> torch.device:
    """This rank's device: the one :func:`init_parallel_env` chose, else
    the first card (the CPU without one)."""
    if _state["device"] is not None:
        return _state["device"]
    return torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")


def init_parallel_env():
    """Join the world the launcher's environment describes (or a
    one-rank world without one) and return :class:`ParallelEnv`. Idempotent:
    a world already initialized (by this call or by the caller's own
    ``init_process_group``) is kept."""
    dist = _dist()
    if dist.is_initialized():
        return ParallelEnv()
    world = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE")
    rank = _env_int("PADDLE_TRAINER_ID", "RANK")
    coord = os.environ.get("PADDLE_MASTER") or os.environ.get("MASTER_ADDR")
    timeout = timedelta(seconds=GROUP_TIMEOUT_S)
    if world is not None and world > 1:
        if rank is None:
            raise RuntimeError(
                "multi-host init: PADDLE_TRAINERS_NUM/WORLD_SIZE is set "
                "but PADDLE_TRAINER_ID/RANK is not — every process would "
                "claim rank 0 and the rendezvous would hang. Export RANK "
                "(or PADDLE_TRAINER_ID) for each process.")
        if not coord:
            raise RuntimeError(
                "multi-host init: PADDLE_MASTER (or MASTER_ADDR) names no "
                "rendezvous address")
        port = os.environ.get("MASTER_PORT", "8476")
        addr = coord if ":" in coord else f"{coord}:{port}"
        local = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK")
        local_world = _env_int("PADDLE_LOCAL_SIZE", "LOCAL_WORLD_SIZE")
        dev = rank_device(rank if local is None else local,
                          world if local_world is None else local_world)
        backend = world_backend(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if addr.startswith(("127.", "localhost")):
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(backend, init_method=f"tcp://{addr}",
                                rank=rank, world_size=world,
                                timeout=timeout)
    else:
        dev = rank_device(0, 1)
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    _state["device"] = dev
    # cross-rank abort watch: an idle rank must still exit promptly when
    # a peer's watchdog fires (a no-op unless PADDLE_STEP_TIMEOUT is set)
    from paddle_tpu_torch.distributed.watchdog import default_watchdog

    default_watchdog().start_abort_watch()
    return ParallelEnv()


class ParallelEnv:
    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        dev = current_device()
        return 0 if dev.index is None else dev.index

    @property
    def current_endpoint(self):
        eps = self.trainer_endpoints
        return eps[self.rank] if self.rank < len(eps) else ""

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []

    @property
    def nrings(self):
        return 1
