"""Rank bodies of the gang tests (slice D4): multi-rank checkpoints, the
agreed restore step, the broadcast preemption and a failed save, the
watchdog's hooks, and the auto-tuner's model. Each runs in a process of a gloo world started
by :func:`paddle_tpu_torch.testing.gloo_ranks.run` and imports only the
port.

:func:`checkpoints` trains the tiny Llama of ``case`` (the JAX model's
initial weights) with a ``ParallelTrainStep`` at dp 2 x mp 2, ZeRO 1:

* resumes from a checkpoint the JAX package wrote at step 2 and runs
  the last two batches;
* trains the first two batches and saves for the JAX package (its
  parameter and slot names, its [in, out] Linear weights: the port's
  tensors transposed, which carry their layouts transposed) and in the
  port's own names;
* restores the port's own save on a ``ParallelTrainStep`` at dp 4.

:func:`manager_gang` drives ``CheckpointManager`` through the gang's
paths on a small replicated state.
"""
from __future__ import annotations

import os
import signal
import time

import numpy as np
import torch

__all__ = ["checkpoints", "manager_gang", "watched_tags", "jax_view",
           "tiny_llama_builder", "tiny_llama_batch", "TINY_LLAMA"]


def _cpu():
    import paddle_tpu_torch as paddle

    paddle.set_device("cpu")
    torch.set_num_threads(1)


def _transposed(name: str) -> bool:
    return name.endswith("_proj.weight") or name == "lm_head.weight"


def jax_view(model, opt, jax_names):
    """``{"model": ..., "opt": ...}`` under the JAX package's keys for
    the Llama ``model`` and its optimizer: the same storage, Linear
    weights and their slots transposed to [in, out]. ``jax_names``: the
    JAX model's parameter names in its ``parameters()`` order (its
    optimizer keys a slot ``param_<position>.<slot>``)."""
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    port_sd = opt.state_dict()
    m = {n: (params[n].detach().t() if _transposed(n)
             else params[n].detach()) for n in names}
    o = {"step": port_sd["step"]}
    for i, n in enumerate(jax_names):
        j = names.index(n)
        for slot in ("moment1", "moment2", "master_weight"):
            v = port_sd.get(f"param_{j}.{slot}")
            if v is not None:
                o[f"param_{i}.{slot}"] = v.t() if _transposed(n) else v
    return {"model": m, "opt": o}


def _shards(model, opt, step):
    """This rank's parameter and slot shards (numpy) with their layouts
    (``Layout.to_meta``), keyed ``<name>`` and ``<name>.<slot>``."""
    lay = step.layouts()
    out, metas = {}, {}
    for n, p in model.named_parameters():
        out[n] = p.detach().clone().numpy()
        metas[n] = lay[n].to_meta()
    by_id = {id(t): (n, lay[n]) for n, t in model.named_parameters()}
    for t, slot_lay, gshape, _, _ in step.shard_layouts():
        if id(t) in by_id:
            continue
        for n, p in model.named_parameters():
            for k, v in opt._slots[id(p)].items():
                if v is t:
                    out[f"{n}.{k}"] = v.clone().numpy()
                    metas[f"{n}.{k}"] = slot_lay.to_meta()
    return out, metas


def _llama(case, mesh_shape, dims, config):
    from paddle_tpu_torch.distributed import (ParallelConfig,
                                              ParallelTrainStep,
                                              ProcessMesh)
    from paddle_tpu_torch.models.convert import llama_state_from_jax
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               LlamaForCausalLM,
                                               LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(LlamaConfig(**case["spec"]), device="cpu")
    model.load_state_dict(llama_state_from_jax(case["state"]))
    opt = AdamW(parameters=model.parameters(), **case["opt_kw"])
    mesh = ProcessMesh(np.arange(int(np.prod(mesh_shape))).reshape(
        mesh_shape), dims)
    step = ParallelTrainStep(model, LlamaPretrainingCriterion(None), opt,
                             mesh, ParallelConfig(**config))
    return model, opt, step


def _train(step, batches):
    return [float(step(torch.from_numpy(np.asarray(x)),
                       torch.from_numpy(np.asarray(y))))
            for x, y in batches]


def checkpoints(rank: int, world: int, case: dict, jax_ckpt: str,
                port_ckpt: str, native_ckpt: str, jax_names) -> dict:
    """The port's side of the cross-package and reshard checks (see the
    module docstring)."""
    _cpu()
    from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                         save_state_dict)

    zero1 = {"sharding_stage": 1}
    out = {}
    # the JAX package saved at step 2: restore and run steps 3-4
    model, opt, step = _llama(case, [2, 2], ["dp", "mp"], zero1)
    view = jax_view(model, opt, jax_names)
    load_state_dict(view, jax_ckpt)
    opt._step_count = int(view["opt"]["step"])
    out["resumed_losses"] = _train(step, case["batches"][2:])
    out["resumed"], out["layouts"] = _shards(model, opt, step)
    del model, opt, step
    # steps 1-2 here, saved for the JAX package and in the port's names
    model, opt, step = _llama(case, [2, 2], ["dp", "mp"], zero1)
    out["first_losses"] = _train(step, case["batches"][:2])
    save_state_dict(jax_view(model, opt, jax_names), port_ckpt)
    save_state_dict({"model": model.state_dict(),
                     "opt": opt.state_dict()}, native_ckpt)
    out["saved"], out["saved_layouts"] = _shards(model, opt, step)
    # copies of the mp shards carry no layout: saved as replicated, the
    # ranks' digests differ and the save fails on every rank
    try:
        save_state_dict({"model": {k: v.clone() for k, v in
                                   model.state_dict().items()}},
                        native_ckpt + "_copied")
        out["copied"] = None
    except (ValueError, OSError) as e:   # what this scenario checks
        out["copied"] = f"{type(e).__name__}: {e}"
    del model, opt, step
    # the port's save restored at another layout: dp 4, ZeRO 1
    model, opt, step = _llama(case, [4], ["dp"], zero1)
    state = {"model": model.state_dict(), "opt": opt.state_dict()}
    load_state_dict(state, native_ckpt)
    out["dp4"], out["dp4_layouts"] = _shards(model, opt, step)
    out["dp4_step"] = int(state["opt"]["step"])
    return out


def manager_gang(rank: int, world: int, root: str) -> dict:
    """``CheckpointManager`` at world > 1 on a small replicated state:

    * ``agreed``: steps 1 and 2 committed, then rank 2's own listing
      shows step 1 only; every rank restores rank 0's newest, 2;
    * ``preempt``: a SIGTERM to rank 1 at step 3 of a paced loop; every
      rank meets the notice at one save boundary and takes its final
      blocking save there;
    * ``fault``: ``ckpt.data_written:raise`` on rank 2 in step 3's save;
      every rank's save raises, step 3 is not committed and every rank
      restores step 2;
    * ``lost``: a leaf that only rank 1 holds, with no layout: no rank
      writes it, and every rank's ``save_state_dict`` raises."""
    _cpu()
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.testing import faults

    def state(v):
        return {"w": torch.full((4, 3), float(v)), "n": int(v)}

    out = {}
    # -- agreed restore step -----------------------------------------------
    mgr = CheckpointManager(os.path.join(root, "agreed"), async_save=True)
    for s in (1, 2):
        mgr.save(s, state(s))
    mgr.wait()
    if rank == 2:
        mgr.all_steps = lambda include_uncommitted=False: [1]
    got = state(0)
    out["agreed"] = {"step": mgr.restore_or_initialize(got),
                     "w": float(got["w"][0, 0]), "n": got["n"],
                     "own_latest": mgr.latest_step()}
    # -- broadcast preemption ----------------------------------------------
    mgr = CheckpointManager(os.path.join(root, "preempt"), async_save=True)
    mon = mgr.install_preemption_handler()
    preempted = None
    try:
        for s in range(1, 40):
            if rank == 1 and s == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            mgr.save(s, state(s))
            time.sleep(0.1)
            if mgr.reached_preemption(s):
                mgr.save(s, state(s), block=True, force=True)
                preempted = s
                break
        mgr.wait()
    finally:
        mon.uninstall()
    out["preempt"] = {"at": preempted, "committed": mgr.all_steps()}
    # -- a rank's part of a save fails -------------------------------------
    mgr = CheckpointManager(os.path.join(root, "fault"), async_save=True)
    for s in (1, 2):
        mgr.save(s, state(s))
    mgr.wait()
    err = None
    if rank == 2:
        faults.install("ckpt.data_written:raise")
    try:
        mgr.save(3, state(3))
        mgr.wait()
    except Exception as e:   # what this scenario checks
        err = f"{type(e).__name__}: {e}"
    finally:
        faults.clear()
    got = state(0)
    out["fault"] = {"error": err, "committed": mgr.all_steps(),
                    "restored": mgr.restore_or_initialize(got),
                    "w": float(got["w"][0, 0])}
    # -- a leaf only rank 1 holds, with no layout: nobody writes it ---------
    from paddle_tpu_torch.distributed.checkpoint import save_state_dict

    mine = state(1)
    if rank == 1:
        mine["only_rank1"] = torch.ones(2)
    try:
        save_state_dict(mine, os.path.join(root, "lost"))
        out["lost"] = None
    except (ValueError, OSError) as e:   # what this scenario checks
        out["lost"] = f"{type(e).__name__}: {e}"
    return out


# -- the auto-tuner's model (a module-level builder its ranks import) ------
TINY_LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=4, max_position_embeddings=64)


def tiny_llama_builder():
    """(model, loss_fn, optimizer) of ``tests/test_auto_tuner.py``'s
    Llama, on the CPU, from seed 0."""
    _cpu()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               LlamaForCausalLM,
                                               LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    paddle.seed(0)
    cfg = LlamaConfig(**TINY_LLAMA)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    return model, LlamaPretrainingCriterion(None), opt


def tiny_llama_batch():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, (8, 32)).astype(np.int32),
            rng.randint(0, 256, (8, 32)).astype(np.int32)]


def watched_tags(rank: int, world: int) -> list:
    """The tags the training hooks arm the default watchdog with, with a
    step timeout set: an eager all-reduce over the world, then two
    steps of a ``ParallelTrainStep`` at dp ``world`` (the first of new
    batch shapes: the COMPILE_ALLOWANCE factor)."""
    _cpu()
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.distributed import (ParallelConfig,
                                              ParallelTrainStep,
                                              ProcessMesh)
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.distributed import watchdog
    from paddle_tpu_torch.optimizer import SGD

    flags.set_flags({"step_timeout_s": 30.0})
    wd = watchdog.default_watchdog()
    tags, arm = [], wd.arm

    def record(tag, factor=1.0):
        tags.append((tag, factor))
        return arm(tag, factor)

    wd.arm = record
    comm.all_reduce_(torch.ones(2))
    model = torch.nn.Linear(4, 2)
    step = ParallelTrainStep(model, torch.nn.MSELoss(),
                             SGD(learning_rate=0.1,
                                 parameters=model.parameters()),
                             ProcessMesh(np.arange(world), ["dp"]),
                             ParallelConfig())
    for _ in range(2):
        step(torch.ones(4, 4), torch.zeros(4, 2))
    left = len(wd._entries)
    wd.arm = arm
    return [tags, left]
