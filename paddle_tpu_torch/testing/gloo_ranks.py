"""Run a function on k CPU processes joined in one gloo group, for the
tests of the port's collectives (``redistribute``, a restore onto TP
shards). :func:`run` spawns the ranks (spawn context: a rank imports
the function's module and the port, nothing of the caller's), each of
which joins the default ``torch.distributed`` group through a
``FileStore`` in a temporary directory, calls ``fn(rank, world,
*args)`` and sends back what it returns. The rank bodies the tests use
live here too, so that a rank imports no test module::

    results = gloo_ranks.run(gloo_ranks.redistribute_cases, 4, cases)
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import sys
import tempfile
import traceback
from datetime import timedelta
from typing import Callable, List

import numpy as np
import torch

__all__ = ["run", "start", "World", "redistribute_cases", "tp_restore"]


def _entry(fn, rank, world, store_dir, timeout_s, out):
    import pickle

    import torch.distributed as dist

    code = 0
    try:
        with open(os.path.join(store_dir, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        torch.set_num_threads(1)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        store = dist.FileStore(os.path.join(store_dir, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        res = (rank, None, fn(rank, world, *args))
    except BaseException:
        res = (rank, traceback.format_exc(), None)
        code = 1
    # the queue's feeder thread must have written the result before the
    # world is torn down (a broken world may not tear down) and the
    # process ends
    out.put(res)
    out.close()
    out.join_thread()
    sys.stderr.flush()
    if code == 0:
        dist.destroy_process_group()
    os._exit(code)


class World:
    """A started world of ranks (:func:`start`); :meth:`results` waits
    for them."""

    def __init__(self, fn: Callable, world: int, args, timeout_s: float):
        ctx = mp.get_context("spawn")
        self._world = world
        self._timeout = timeout_s
        self._out = ctx.Queue()
        self._dir = tempfile.mkdtemp(prefix="gloo-ranks-")
        # the arguments go through a file: a large payload on a rank's
        # start-up pipe would hold this process until the rank has
        # imported what unpickling it needs
        with open(os.path.join(self._dir, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        self._procs = [ctx.Process(target=_entry, daemon=True,
                                   args=(fn, r, world, self._dir,
                                         timeout_s, self._out))
                       for r in range(world)]
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self._reap()
            raise

    def results(self, ranks=None) -> List:
        """``[fn(0, ...), ..., fn(world - 1, ...)]`` (or the results of
        ``ranks`` alone, in their order); raises with a rank's traceback
        if one failed, or after the timeout; leaves no process behind."""
        want = list(range(self._world)) if ranks is None else list(ranks)
        try:
            got = {}
            while len(got) < len(want):
                try:
                    rank, err, res = self._out.get(timeout=self._timeout)
                except queue.Empty:
                    raise TimeoutError(
                        f"{self._world} gloo ranks: {sorted(got)} answered "
                        f"within {self._timeout} s") from None
                if err is not None:
                    raise RuntimeError(f"gloo rank {rank} failed:\n{err}")
                got[rank] = res
            return [got[r] for r in want]
        finally:
            self._reap()

    def alive(self) -> List[int]:
        """The ranks whose process still runs."""
        return [r for r, p in enumerate(self._procs) if p.is_alive()]

    def _reap(self):
        for p in self._procs:
            if p.pid is None:
                continue
            p.join(10.0)
            if p.exitcode is None:
                p.kill()
                p.join(10.0)
        shutil.rmtree(self._dir, ignore_errors=True)


def start(fn: Callable, world: int, *args, timeout_s: float = 120.0
          ) -> World:
    """Start ``fn(rank, world, *args)`` on ``world`` ranks and return at
    once (the caller works meanwhile, then calls ``results()``)."""
    return World(fn, world, args, timeout_s)


def run(fn: Callable, world: int, *args, timeout_s: float = 120.0
        ) -> List:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in its own process of a ``world``-rank gloo group. Raises with a
    rank's traceback if one failed, or after ``timeout_s``; leaves no
    process behind."""
    return start(fn, world, *args, timeout_s=timeout_s).results()


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------
def redistribute_cases(rank: int, world: int, cases) -> dict:
    """For each ``(src_meta, dst_meta, global_shape, seed)``: the global
    f32 array ``RandomState(seed).randn(*global_shape)``, this rank's
    ``src`` shard (rank f holds shard ``f // (world // size)``) through
    :func:`~paddle_tpu_torch.distributed.redistribute.redistribute`.
    Returns this rank's ``dst`` shards and the transfer stats of the
    cases."""
    import importlib

    # the package exports the function under the module's name
    rd = importlib.import_module("paddle_tpu_torch.distributed.redistribute")

    rd.reset_stats()
    shards = []
    for src_m, dst_m, shape, seed in cases:
        src, dst = rd.Layout.from_meta(src_m), rd.Layout.from_meta(dst_m)
        x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
        mine = src.shards(x)[rank // (world // src.size)]
        got = rd.redistribute(torch.from_numpy(mine), src, dst)
        shards.append(got.numpy())
    return {"shards": shards, "stats": rd.get_stats()}


def tp_restore(rank: int, world: int, ckpt_dir: str, step: int, ids):
    """Restore a tiny Llama checkpoint that the JAX package wrote (its
    names, its [in, out] Linear weights) onto this rank's TP shards: the
    JAX-orientation tensors take the engine's layouts transposed with
    them, come back as this rank's slices, and turn into the port's
    [out, in] shards (``models.convert.llama_state_from_jax``). Then the
    TP forward of ``ids`` over the default group (the all-reduce after
    each o_proj and down_proj). Returns the shards (JAX orientation) and
    rank 0's logits."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.models.convert import llama_state_from_jax
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving.engine import _tp_param_layout
    from paddle_tpu_torch.serving.tp import _set_param, shard_layers

    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").eval()
    template, layouts = {}, {}
    for name, p in model.named_parameters():
        lay = _tp_param_layout(name, p.ndim, world)
        shape = tuple(p.shape)
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            # stored [in, out] (``_torch_layout`` turns it): the split
            # dim turns with the weight
            lay = type(lay)(lay.mesh_axes, lay.dim_placements[::-1])
            shape = shape[::-1]
        template[name] = torch.empty(shape)
        layouts[name] = lay
    # this rank's shards: its rank in the default group
    CheckpointManager(ckpt_dir).restore(template, step,
                                        target_layout=layouts)
    mine = {n: t.numpy() for n, t in template.items()}
    for name, t in llama_state_from_jax(mine).items():
        _set_param(model, name, t)

    def reduce(t):
        dist.all_reduce(t)
        return t

    shard_layers(model.llama.layers, world, reduce)
    with torch.no_grad():
        logits = model(torch.as_tensor(ids))
    return {"shards": mine,
            "logits": logits.numpy() if rank == 0 else None}
