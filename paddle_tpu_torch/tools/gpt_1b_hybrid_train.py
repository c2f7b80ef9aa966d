"""Hybrid-parallel training of ``bench.py``'s ``bench_gpt_1b`` on one
card: ``chip_smoke.py`` phase 28 (``hybrid_train``).

One world of :data:`WORLD` ranks is started with
``paddle_tpu_torch.distributed.spawn`` (the launcher's env protocol) and
joins through ``init_parallel_env``; inside
:func:`~paddle_tpu_torch.testing.tp_hooks.ranks_share_one_device` every
rank takes the first card and the world is gloo. The world stays up for
every case, so the CUDA start-up is paid once. Two parts:

(a) f32 at ``bench_gpt_1b`` widths, :data:`F32_LAYERS` of its 16
    layers, batch 4 x 2048 (:func:`gpt_1b_train.config`'s batch), three
    AdamW steps per case (:data:`CASES`: dp 2, mp 2, dp 2 x mp 2, with
    SP, ZeRO 1, 2 and 3 at dp 2, eager ``DataParallel`` at dp 2, dp 2 x
    mp 2 with ZeRO 1 and recompute; two 2-rank cases run at once on
    ranks 0-1 and 2-3), each held against a one-rank
    ``TrainStep`` of the same model and batches on the card: losses at
    rtol 1e-4, every rank's parameter shards against the same slices of
    the one-rank parameters at rtol 2e-3 / atol 2e-5 (reported) and at
    the repository's AdamW bound, parameter by parameter (checked:
    :data:`ADAM_NOISE`, :data:`PARAM_MAX_ABS`). Each rank's
    optimizer state must be the reckoned share (2 f32 moments over its
    parameter elements, over dp at stage >= 1); each rank's peak memory
    is reported;
(b) bf16 at full width and depth (0.95B parameters, 16 layers), batch
    4 x 2048, dp 2 x mp 2 with ZeRO 1 and SP: one warm-up and
    :data:`TIMED_STEPS` timed steps. The losses (returned for the caller
    to hold against the one-rank ``TrainStep`` of phase 7), the flash
    kernels' launches on each rank (16 a step), the step times, the
    collectives' host seconds (``communication.stats``), rank 0's
    device-phase breakdown of one more step (``profiler.device_phases``)
    and each rank's peak memory.

Four ranks share one card over gloo through the host: this checks the
path's numbers and its kernel launches, not parallel speed.

    python -m paddle_tpu_torch.tools.gpt_1b_hybrid_train
"""
from __future__ import annotations

import importlib
import json
import multiprocessing as mp
import os
import queue
import threading
import time
import traceback

import numpy as np
import torch

from paddle_tpu_torch.tools import gpt_1b_train

__all__ = ["WORLD", "F32_LAYERS", "TIMED_STEPS", "CASES", "run"]

WORLD = 4
F32_LAYERS = 2
# (b)'s timed steps (also phase 30 (b)'s): one, for chip_smoke.py's
# time limit
TIMED_STEPS = 1
LR = 3e-4
STEPS = 3
LOSS_RTOL = 1e-4
# the parameters' bound: rtol / atol as the reference's own
# tests/test_distributed_engine.py (an SGD test), reported; and, since
# AdamW's first steps are near a sign function of the gradient, the
# repository's AdamW bound (tests/test_torch_train.py
# ``_close_after_adam``), checked on each parameter shard: under
# ADAM_SHARE of its elements beyond ADAM_NOISE, and its largest |diff|
# within PARAM_MAX_ABS: about twice the largest that sound runs of
# chip_smoke.py phase 28 read on an H100 (1.18e-4), a seventh of 2 lr
# a step
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-5
ADAM_NOISE, ADAM_SHARE = 1e-5, 1e-3
PARAM_MAX_ABS = 2.5e-4
# name, mesh shape, mesh dims, ParallelConfig kwargs, LlamaConfig kwargs;
# "data_parallel" is eager DataParallel over the dp ranks
CASES = [
    ("dp2", [2], ["dp"], {}, {}),
    ("mp2", [2], ["mp"], {}, {}),
    ("dp2_mp2", [2, 2], ["dp", "mp"], {}, {}),
    ("dp2_mp2_sp", [2, 2], ["dp", "mp"], {}, {"sequence_parallel": True}),
    ("zero1_dp2", [2], ["dp"], {"sharding_stage": 1}, {}),
    ("zero2_dp2", [2], ["dp"], {"sharding_stage": 2}, {}),
    ("zero3_dp2", [2], ["dp"], {"sharding_stage": 3}, {}),
    ("data_parallel_dp2", [2], ["dp"], None, {}),
    ("dp2_mp2_zero1_recompute", [2, 2], ["dp", "mp"],
     {"sharding_stage": 1}, {"recompute": True}),
]


def _rounds(world: int = WORLD):
    """CASES packed into rounds: the cases of a round run at once on
    disjoint ranks of the world (each a mesh over the next free ranks),
    in CASES' order. Returns [[(case, first rank), ...], ...]."""
    rounds, cur, free = [], [], 0
    for case in CASES:
        n = int(np.prod(case[1]))
        if free + n > world:
            rounds.append(cur)
            cur, free = [], 0
        cur.append((case, free))
        free += n
    if cur:
        rounds.append(cur)
    return rounds


# (b): the full model
FULL = ([2, 2], ["dp", "mp"], {"sharding_stage": 1},
        {"sequence_parallel": True})


# a dry run's smaller sizes (``run(shrink=)``): LlamaConfig fields and
# ``batch`` = (batch, seq); empty on the card
_shrink: dict = {}


def _cuda(dev) -> bool:
    return dev.type == "cuda"


def _reset_peak(dev):
    if _cuda(dev):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if _cuda(dev) else None


def _free(dev):
    if _cuda(dev):
        torch.cuda.empty_cache()


def _sync(dev):
    if _cuda(dev):
        torch.cuda.synchronize(dev)


def _config():
    from dataclasses import replace

    kw = {k: v for k, v in _shrink.items() if k != "batch"}
    return replace(gpt_1b_train.config(), **kw)


def _model(dev, layers, dtype, **cfg_kw):
    from dataclasses import replace

    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = replace(_config(), num_hidden_layers=layers, dtype=dtype, **cfg_kw)
    model = LlamaForCausalLM(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    return model


def _batch(dev):
    cfg = _config()
    rng = np.random.RandomState(0)
    shape = _shrink.get("batch", (gpt_1b_train.BATCH, gpt_1b_train.SEQ))
    x = rng.randint(0, cfg.vocab_size, shape).astype(np.int32)
    y = rng.randint(0, cfg.vocab_size, shape).astype(np.int32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def _reference(dev, x, y, layers: int = F32_LAYERS):
    """The one-rank TrainStep of part (a) at ``layers`` layers: losses
    and the final parameters (kept on the device for the
    comparisons)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    model = _model(dev, layers, "float32")
    step = TrainStep(model, model.criterion(model.config),
                     AdamW(learning_rate=LR, parameters=model.parameters()))
    losses = [float(step(x, y)) for _ in range(STEPS)]
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model, step
    _free(dev)
    return losses, params


def _compare(named, layouts, index, ref_params):
    """Each parameter shard (``named``: (name, torch tensor) pairs)
    against the same slice of the one-rank parameters. ``per_param``: for each parameter its largest |diff|,
    its elements beyond ADAM_NOISE and outside rtol / atol, and its
    element count; ``within_adam_bound`` holds when every shard is within
    the AdamW bound on its own; the totals and the worst element's
    parameter, |diff| and one-rank value beside them."""
    per_param, outside, worst, where, ok = {}, 0, 0.0, None, True
    for name, p in named:
        want = ref_params[name]
        if layouts is not None:
            want = want[layouts[name].shard_slices(tuple(want.shape), index)]
        diff = (p.detach() - want).abs()
        out = int((diff > PARAM_ATOL + PARAM_RTOL * want.abs()).sum())
        noisy = int((diff > ADAM_NOISE).sum())
        m = float(diff.max())
        per_param[name] = {"max_abs_err": m, "beyond_noise": noisy,
                           "outside_rtol_atol": out,
                           "elements": diff.numel()}
        ok = ok and m <= PARAM_MAX_ABS and noisy < ADAM_SHARE * diff.numel()
        outside += out
        if m > worst:
            worst = m
            where = {"param": name, "diff": m,
                     "value": float(want.reshape(-1)[int(diff.argmax())])}
    return {"within_rtol_atol": outside == 0, "within_adam_bound": ok,
            "max_abs_err": worst, "outside_rtol_atol": outside,
            "beyond_noise": sum(v["beyond_noise"]
                                for v in per_param.values()),
            "elements": sum(v["elements"] for v in per_param.values()),
            "worst": where, "per_param": per_param}


def _case(dev, rank, case, first, x, y, ref):
    """One case of part (a) on the ranks first, first + 1, ..."""
    from paddle_tpu_torch.distributed import (ParallelConfig,
                                              ParallelTrainStep,
                                              ProcessMesh)
    from paddle_tpu_torch.optimizer import AdamW

    name, shape, dims, cfg, model_kw = case
    n = int(np.prod(shape))
    if cfg is None:
        return _data_parallel(dev, rank, list(range(first, first + n)),
                              x, y, ref)
    mesh = ProcessMesh(np.arange(first, first + n).reshape(shape), dims)
    model = _model(dev, F32_LAYERS, "float32", **model_kw)
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    _reset_peak(dev)
    step = ParallelTrainStep(model, model.criterion(model.config), opt,
                             mesh, ParallelConfig(**cfg))
    losses, step_s = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))
        step_s.append(time.perf_counter() - t0)
    cmp = _compare(model.named_parameters(), step.layouts(),
                   mesh.process_ids.index(rank), ref[1])
    # at stages 1 and 2 the slots cover 1/dp of each (mp-cut) parameter;
    # at stage 3 the parameter at rest is already that slice
    dp = mesh.dim_size("dp") if cfg.get("sharding_stage", 0) in (1, 2) \
        else 1
    local = sum(p.numel() for p in model.parameters())
    out = {"losses": losses,
           "losses_ok": bool(np.allclose(losses, ref[0], rtol=LOSS_RTOL)),
           "params": cmp, "slot_bytes": step.slot_bytes(),
           "reckoned_slot_bytes": 2 * 4 * local // dp,
           "max_memory_allocated": _peak(dev), "step_s": step_s}
    del model, step, opt
    _free(dev)
    return out


def _data_parallel(dev, rank, ranks, x, y, ref):
    """Eager DataParallel over ``ranks``: each rank its share of the
    batch."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.optimizer import AdamW

    group = dist.new_group(ranks)
    model = _model(dev, F32_LAYERS, "float32")
    crit = model.criterion(model.config)
    dp = dist.DataParallel(model, group=group)
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    i, n = ranks.index(rank), len(ranks)
    xs, ys = x.chunk(n)[i], y.chunk(n)[i]
    losses, step_s = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        loss = crit(dp(xs), ys)
        loss.backward()
        opt.step()
        opt.clear_grad()
        lt = loss.detach().clone()
        dist.all_reduce(lt, op=dist.ReduceOp.AVG, group=group)
        losses.append(float(lt))
        step_s.append(time.perf_counter() - t0)
    out = {"losses": losses,
           "losses_ok": bool(np.allclose(losses, ref[0], rtol=LOSS_RTOL)),
           "params": _compare(model.named_parameters(), None, rank,
                              ref[1]), "step_s": step_s}
    del model, dp, opt
    _free(dev)
    return out


def _full(dev, rank, full=FULL, phases: bool = True):
    """Part (b): the bf16 full model at dp 2 x mp 2, ZeRO 1, SP (or the
    mesh shape, dims, ParallelConfig and LlamaConfig kwargs ``full``);
    with ``phases``, rank 0's device phases of one more step."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed import (ParallelConfig,
                                              ParallelTrainStep,
                                              ProcessMesh)
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    shape, dims, cfg, model_kw = full
    mesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape), dims)
    x, y = _batch(dev)
    _reset_peak(dev)
    t0 = time.perf_counter()
    model = _model(dev, _config().num_hidden_layers, "bfloat16",
                   **model_kw)
    step = ParallelTrainStep(model, model.criterion(model.config),
                             AdamW(learning_rate=LR,
                                   parameters=model.parameters()),
                             mesh, ParallelConfig(**cfg))
    params = sum(p.numel() for p in model.parameters())   # this rank's
    _sync(dev)
    setup_s = time.perf_counter() - t0
    losses = [float(step(x, y))]          # warm-up step
    for name in fa.launches:              # the main path starts here
        fa.launches[name] = 0
    comm.stats(reset=True)
    step_ms = []
    for _ in range(TIMED_STEPS):
        t1 = time.perf_counter()
        loss = step(x, y)
        _sync(dev)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
    launches = dict(fa.launches)          # the main path ends here
    coll = comm.stats()
    peak = _peak(dev)
    breakdown = None
    if phases and rank == 0 and _cuda(dev):
        breakdown = profiler.device_phases(lambda: step(x, y), steps=1,
                                           warmup=0)
    elif phases:
        step(x, y)
    out = {"losses": losses, "step_ms": step_ms,
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "kernel_launches": launches,
           "collective_host_ms_per_step": coll["seconds"] * 1e3
           / TIMED_STEPS,
           "collective_calls_per_step": coll["calls"] / TIMED_STEPS,
           "collective_bytes_per_step": coll["bytes"] / TIMED_STEPS,
           "p2p_host_ms_per_step": coll["p2p_seconds"] * 1e3 / TIMED_STEPS,
           "p2p_calls_per_step": coll["p2p_calls"] / TIMED_STEPS,
           "p2p_bytes_per_step": coll["p2p_bytes"] / TIMED_STEPS,
           "device_phases_one_step": breakdown,
           "max_memory_allocated": peak, "setup_s": setup_s,
           "local_params": params, "slot_bytes": step.slot_bytes()}
    del model, step
    _free(dev)
    return out


def _rank_main(out_q, parts, shrink):
    """A rank: join the world, run the parts, put (rank, error, result)."""
    rank = None
    _shrink.update(shrink or {})
    # the ranks share the host's cores: one intra-op pool each would
    # oversubscribe them (the host runs gloo's copies and reductions)
    torch.set_num_threads(max(1, (os.cpu_count() or WORLD) // WORLD))
    # torch.utils.checkpoint imports torch._dynamo at its first call, for
    # seconds; import it while the world rendezvouses and the reference
    # runs
    warm = threading.Thread(target=importlib.import_module,
                            args=("torch._dynamo",), daemon=True)
    warm.start()
    try:
        import paddle_tpu_torch.distributed as dist

        dist.init_parallel_env()
        rank = dist.get_rank()
        from paddle_tpu_torch.distributed.env import current_device

        dev = current_device()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res = {"backend": dist.get_backend(), "device": str(dev),
               "cases": {}}
        if "a" in parts:
            x, y = _batch(dev)
            ref = _reference(dev, x, y)
            res["reference_losses"] = ref[0]
            warm.join()
            for cases in _rounds():
                for case, first in cases:
                    if first <= rank < first + int(np.prod(case[1])):
                        res["cases"][case[0]] = _case(dev, rank, case,
                                                      first, x, y, ref)
                dist.barrier()
            del ref, x, y
            _free(dev)
        if "b" in parts:
            res["full"] = _full(dev, rank)
        out_q.put((rank, None, res))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        out_q.put((rank, traceback.format_exc(), None))
        raise


def run_world(rank_main, args: tuple, timeout_s: float, what: str,
              world: int = WORLD) -> dict:
    """Spawn ``world`` ranks on the card (``rank_main(out_q, *args)``,
    each putting (rank, error, result) on ``out_q``) and return each
    rank's result; raises with a rank's traceback if one failed or after
    ``timeout_s``; leaves no process behind."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.testing import tp_hooks

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    with tp_hooks.ranks_share_one_device():
        procs = dist.spawn(rank_main, args=(out_q,) + tuple(args),
                           nprocs=world, join=False, daemon=True)
    got = {}
    try:
        while len(got) < world:
            try:
                rank, err, res = out_q.get(timeout=timeout_s)
            except queue.Empty:
                raise TimeoutError(f"{what} ranks {sorted(got)} of "
                                   f"{world} answered in {timeout_s} s") \
                    from None
            if err is not None:
                raise RuntimeError(f"{what} rank {rank} failed:\n{err}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(30.0)
            if p.exitcode is None:
                p.kill()
                p.join(10.0)
    return {"ranks": [got[r] for r in range(world)],
            "alive_after": [p.pid for p in procs if p.is_alive()]}


def run(parts=("a", "b"), timeout_s: float = 600.0,
        shrink: dict = None) -> dict:
    """Start the world on the card, run ``parts`` and return each rank's
    results; raises with a rank's traceback if one failed or after
    ``timeout_s``; leaves no process behind. ``shrink`` (LlamaConfig
    fields, and ``batch``: (batch, seq)) makes the model smaller for a
    dry run on the CPU."""
    return run_world(_rank_main, (tuple(parts), shrink), timeout_s,
                     "hybrid_train")


if __name__ == "__main__":
    print(json.dumps(run()))
