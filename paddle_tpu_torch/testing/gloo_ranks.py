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
import queue
import shutil
import sys
import tempfile
import traceback
from datetime import timedelta
from typing import Callable, List

import numpy as np
import torch

__all__ = ["run", "redistribute_cases", "tp_restore"]


def _entry(fn, rank, world, store_dir, args, timeout_s, out):
    import torch.distributed as dist

    code = 0
    try:
        torch.set_num_threads(1)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        store = dist.FileStore(os.path.join(store_dir, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        out.put((rank, None, fn(rank, world, *args)))
        dist.destroy_process_group()
    except BaseException:
        out.put((rank, traceback.format_exc(), None))
        code = 1
    sys.stderr.flush()
    os._exit(code)


def run(fn: Callable, world: int, *args, timeout_s: float = 120.0
        ) -> List:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in its own process of a ``world``-rank gloo group. Raises with a
    rank's traceback if one failed, or after ``timeout_s``; leaves no
    process behind."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="gloo-ranks-")
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(fn, r, world, store_dir, args, timeout_s, out))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        got = {}
        while len(got) < world:
            try:
                rank, err, res = out.get(timeout=timeout_s)
            except queue.Empty:
                raise TimeoutError(
                    f"{world} gloo ranks: {sorted(got)} answered within "
                    f"{timeout_s} s") from None
            if err is not None:
                raise RuntimeError(f"gloo rank {rank} failed:\n{err}")
            got[rank] = res
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            p.join(10.0)
            if p.exitcode is None:
                p.kill()
                p.join(10.0)
        shutil.rmtree(store_dir, ignore_errors=True)


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
    from paddle_tpu_torch.distributed import redistribute as rd

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
