"""Pipeline-parallel training of ``bench.py``'s ``bench_gpt_1b`` on one
card: ``chip_smoke.py`` phase 29 (``pipeline_train``).

The model is ``LlamaForCausalLMPipe`` at ``bench_gpt_1b``'s widths
(hidden 2048, MLP 5632, 16 heads, vocab 32000), batch 4 x 2048, AdamW,
under ``PipelineTrainStep``. One world of :data:`WORLD` ranks is started
with ``paddle_tpu_torch.distributed.spawn`` and joins through
``init_parallel_env``; inside
:func:`~paddle_tpu_torch.testing.tp_hooks.ranks_share_one_device` every
rank takes the first card and the world is gloo. Every rank builds the
same ``LlamaForCausalLM`` from seed 0 (``init_weights``), keeps its
stage's share of it (``models.convert.llama_pipe_state_from_causal_lm``)
and frees the rest. Two parts:

(a) f32, :data:`F32_LAYERS` of the 16 layers (S V = 8 divides them),
    three AdamW steps per case (:data:`CASES`: pp 4 "1f1b" M 4, pp 2
    "1f1b" M 4 (two chunks), pp 4 "gpipe", pp 4 "zero_bubble", pp 4
    "interleave" V 2, dp 2 x pp 2, pp 2 x mp 2; two 2-rank cases run at
    once on ranks 0-1 and 2-3), each held against a one-rank
    ``TrainStep`` of ``LlamaForCausalLM`` with the same weights and
    batch (the ranks run it one after another): losses at rtol 1e-4,
    each parameter shard against the same slice of the one-rank
    parameters at phase 28's AdamW bound (largest |diff| within
    ``PARAM_MAX_ABS``, under ``ADAM_SHARE`` of it beyond ``ADAM_NOISE``).
    Each rank's parameter and slot bytes and its peak memory; the pre
    and post parameters must hold the reckoned 1/S of their elements;
(b) bf16 at full width and depth (0.95B parameters, 16 layers), pp 4,
    "1f1b", M 4, ``shard_pre_post=True``, ``remat_body=True``: one
    warm-up and :data:`TIMED_STEPS` timed steps. The losses (for the
    caller to hold against phase 7's), K2-K4 launches on each rank
    (4 layers x 4 microbatches a step, K2 twice for the recompute), the
    step times, the P2P and collective host seconds
    (``communication.stats``), rank 0's device-phase breakdown of one
    more step, each rank's parameter count and peak memory.

Four ranks share one card over gloo through the host: this checks the
path's numbers and its kernel launches, not pipeline speed.

    python -m paddle_tpu_torch.tools.gpt_1b_pipe_train
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

from paddle_tpu_torch.tools import gpt_1b_hybrid_train as H

__all__ = ["WORLD", "F32_LAYERS", "TIMED_STEPS", "CASES", "run"]

WORLD = 4
F32_LAYERS = 8
# (b)'s timed steps: one, for chip_smoke.py's time limit
TIMED_STEPS = 1
LR = H.LR
STEPS = 3
LOSS_RTOL = H.LOSS_RTOL
# name, mesh shape, mesh dims, schedule, n_microbatches, interleave V
CASES = [
    ("pp4_1f1b", [4], ["pp"], "1f1b", 4, 1),
    ("pp2_1f1b_two_chunks", [2], ["pp"], "1f1b", 4, 1),
    ("dp2_pp2", [2, 2], ["dp", "pp"], "1f1b", 2, 1),
    ("pp2_mp2", [2, 2], ["pp", "mp"], "1f1b", 4, 1),
    ("pp4_gpipe", [4], ["pp"], "gpipe", 4, 1),
    ("pp4_zero_bubble", [4], ["pp"], "zero_bubble", 4, 1),
    ("pp4_interleave", [4], ["pp"], "interleave", 4, 2),
]
# (b): pp 4, 1f1b, M 4
FULL = ([4], ["pp"], "1f1b", 4)


def _rounds(world: int = WORLD):
    """CASES packed into rounds of cases on disjoint ranks, in order."""
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


def _pipe_to_model_name(name: str) -> str:
    """A Pipe parameter's name in ``LlamaForCausalLM``."""
    if name == "pre_layers.0.weight":
        return "llama.embed_tokens.weight"
    if name.startswith("body_layers."):
        return "llama.layers." + name[len("body_layers."):]
    if name == "post_layers.0.norm.weight":
        return "llama.norm.weight"
    if name == "post_layers.0.lm_head.weight":
        return "lm_head.weight"
    raise KeyError(name)


def _stage(dev, layers, dtype, mesh, rank, v):
    """This rank's Pipe stage, loaded with the seed-0 model's weights."""
    from dataclasses import replace

    from paddle_tpu_torch.models.convert import (
        llama_pipe_state_from_causal_lm)
    from paddle_tpu_torch.models.llama import LlamaForCausalLMPipe

    S = mesh.dim_size("pp")
    stage = mesh.coord(rank)[mesh.dim_names.index("pp")] if S > 1 else 0
    cfg = replace(H._config(), num_hidden_layers=layers, dtype=dtype)
    pipe = LlamaForCausalLMPipe(cfg, S, device=dev, stage_id=stage,
                                num_virtual_pipeline_stages=v)
    model = H._model(dev, layers, dtype)
    state = llama_pipe_state_from_causal_lm(model.state_dict(), pipe._owned)
    missing, _ = pipe.set_state_dict(state)
    del model, state
    H._free(dev)
    if missing:
        raise KeyError(f"no weights for {missing}")
    return pipe


def _compare(pipe, step, index, ref_params):
    """Each parameter shard against the same slice of the one-rank
    parameters (phase 28's readings and bound)."""
    per_param, worst, where, ok = {}, 0.0, None, True
    layouts = step.layouts()
    for name, p in pipe.named_parameters():
        want = ref_params[_pipe_to_model_name(name)]
        want = want[layouts[name].shard_slices(tuple(want.shape), index)]
        diff = (p.detach() - want).abs()
        out = int((diff > H.PARAM_ATOL + H.PARAM_RTOL * want.abs()).sum())
        noisy = int((diff > H.ADAM_NOISE).sum())
        m = float(diff.max())
        per_param[name] = {"max_abs_err": m, "beyond_noise": noisy,
                           "outside_rtol_atol": out,
                           "elements": diff.numel()}
        ok = ok and m <= H.PARAM_MAX_ABS and \
            noisy < H.ADAM_SHARE * diff.numel()
        if m > worst:
            worst = m
            where = {"param": name, "diff": m,
                     "value": float(want.reshape(-1)[int(diff.argmax())])}
    return {"within_adam_bound": ok, "max_abs_err": worst,
            "outside_rtol_atol": sum(v["outside_rtol_atol"]
                                     for v in per_param.values()),
            "beyond_noise": sum(v["beyond_noise"]
                                for v in per_param.values()),
            "elements": sum(v["elements"] for v in per_param.values()),
            "worst": where, "per_param": per_param}


def _shares(pipe, step, mesh):
    """Each pre/post parameter's local elements times S against its mp
    share (the reckoned 1/S of what the rank's mp cut leaves)."""
    S = step.S
    out = {}
    for name, p in pipe.named_parameters():
        if name.startswith("body_layers."):
            continue
        plan = p._dist_plan
        whole = int(np.prod(plan.global_shape)) // int(np.prod(
            [mesh.dim_size(a) for a in plan.dims.values()]))
        out[name] = {"local": p.numel(), "whole": whole,
                     "one_over_s": p.numel() * S == whole}
    return out


def _case(dev, rank, case, first, x, y, ref):
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.distributed.fleet.pp_engine import (
        PipelineTrainStep)
    from paddle_tpu_torch.optimizer import AdamW

    name, shape, dims, schedule, M, v = case
    n = int(np.prod(shape))
    mesh = ProcessMesh(np.arange(first, first + n).reshape(shape), dims)
    pipe = _stage(dev, F32_LAYERS, "float32", mesh, rank, v)
    opt = AdamW(learning_rate=LR, parameters=pipe.parameters())
    H._reset_peak(dev)
    step = PipelineTrainStep(pipe, pipe.get_loss_fn(), opt, mesh,
                             n_microbatches=M, schedule=schedule,
                             interleave_degree=max(v, 1))
    losses, step_s = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))
        step_s.append(time.perf_counter() - t0)
    cmp = _compare(pipe, step, mesh.process_ids.index(rank), ref[1])
    shares = _shares(pipe, step, mesh)
    out = {"losses": losses,
           "losses_ok": bool(np.allclose(losses, ref[0], rtol=LOSS_RTOL)),
           "params": cmp, "owned": list(pipe._owned),
           "pre_post_shares": shares,
           "pre_post_one_over_s": all(s["one_over_s"]
                                      for s in shares.values()),
           "param_bytes": step.param_bytes(),
           "slot_bytes": step.slot_bytes(),
           "reckoned_slot_bytes": 2 * 4 * sum(
               p.numel() for p in pipe.parameters()),
           "bubble_fraction": step.bubble_fraction,
           "max_memory_allocated": H._peak(dev), "step_s": step_s}
    del pipe, step, opt
    H._free(dev)
    return out


def _full(dev, rank):
    """Part (b): the bf16 full model at pp 4, 1f1b, M 4."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.distributed.fleet.pp_engine import (
        PipelineTrainStep)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    shape, dims, schedule, M = FULL
    mesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape), dims)
    x, y = H._batch(dev)
    H._reset_peak(dev)
    t0 = time.perf_counter()
    pipe = _stage(dev, H._config().num_hidden_layers, "bfloat16", mesh,
                  rank, 1)
    step = PipelineTrainStep(pipe, pipe.get_loss_fn(),
                             AdamW(learning_rate=LR,
                                   parameters=pipe.parameters()),
                             mesh, n_microbatches=M, schedule=schedule,
                             shard_pre_post=True, remat_body=True)
    params = sum(p.numel() for p in pipe.parameters())   # this rank's
    H._sync(dev)
    setup_s = time.perf_counter() - t0
    losses = [float(step(x, y))]          # warm-up step
    for name in fa.launches:              # the main path starts here
        fa.launches[name] = 0
    comm.stats(reset=True)
    step_ms = []
    for _ in range(TIMED_STEPS):
        t1 = time.perf_counter()
        loss = step(x, y)
        H._sync(dev)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
    launches = dict(fa.launches)          # the main path ends here
    coll = comm.stats()
    peak = H._peak(dev)
    if rank == 0 and H._cuda(dev):
        phases = profiler.device_phases(lambda: step(x, y), steps=1,
                                        warmup=0)
    else:
        step(x, y)
        phases = None
    out = {"losses": losses, "step_ms": step_ms,
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "kernel_launches": launches,
           "layers_owned": list(pipe._owned),
           "p2p_host_ms_per_step": coll["p2p_seconds"] * 1e3 / TIMED_STEPS,
           "p2p_calls_per_step": coll["p2p_calls"] / TIMED_STEPS,
           "p2p_bytes_per_step": coll["p2p_bytes"] / TIMED_STEPS,
           "collective_host_ms_per_step": coll["seconds"] * 1e3
           / TIMED_STEPS,
           "collective_calls_per_step": coll["calls"] / TIMED_STEPS,
           "collective_bytes_per_step": coll["bytes"] / TIMED_STEPS,
           "device_phases_one_step": phases,
           "max_memory_allocated": peak, "setup_s": setup_s,
           "local_params": params, "param_bytes": step.param_bytes(),
           "slot_bytes": step.slot_bytes(),
           "bubble_fraction": step.bubble_fraction}
    del pipe, step
    H._free(dev)
    return out


def _rank_main(out_q, parts, shrink):
    """A rank: join the world, run the parts, put (rank, error, result)."""
    rank = None
    H._shrink.update(shrink or {})
    torch.set_num_threads(max(1, (os.cpu_count() or WORLD) // WORLD))
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
            x, y = H._batch(dev)
            # the one-rank reference, one rank at a time (its f32
            # activations at 8 layers would not fit four times)
            ref = None
            for r in range(WORLD):
                if r == rank:
                    ref = H._reference(dev, x, y, F32_LAYERS)
                dist.barrier()
            res["reference_losses"] = ref[0]
            warm.join()
            for cases in _rounds():
                for case, first in cases:
                    if first <= rank < first + int(np.prod(case[1])):
                        res["cases"][case[0]] = _case(dev, rank, case,
                                                      first, x, y, ref)
                dist.barrier()
            del ref, x, y
            H._free(dev)
        if "b" in parts:
            res["full"] = _full(dev, rank)
        out_q.put((rank, None, res))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        out_q.put((rank, traceback.format_exc(), None))
        raise


def run(parts=("a", "b"), timeout_s: float = 600.0,
        shrink: dict = None) -> dict:
    """Start the world on the card, run ``parts`` and return each rank's
    results; raises with a rank's traceback if one failed or after
    ``timeout_s``; leaves no process behind. ``shrink`` (LlamaConfig
    fields, and ``batch``: (batch, seq)) makes the model smaller for a
    dry run on the CPU."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.testing import tp_hooks

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    with tp_hooks.ranks_share_one_device():
        procs = dist.spawn(_rank_main, args=(out_q, tuple(parts), shrink),
                           nprocs=WORLD, join=False, daemon=True)
    got = {}
    try:
        while len(got) < WORLD:
            try:
                rank, err, res = out_q.get(timeout=timeout_s)
            except queue.Empty:
                raise TimeoutError(f"pipeline_train ranks {sorted(got)} of "
                                   f"{WORLD} answered in {timeout_s} s") \
                    from None
            if err is not None:
                raise RuntimeError(
                    f"pipeline_train rank {rank} failed:\n{err}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(30.0)
            if p.exitcode is None:
                p.kill()
                p.join(10.0)
    return {"ranks": [got[r] for r in range(WORLD)],
            "alive_after": [p.pid for p in procs if p.is_alive()]}


if __name__ == "__main__":
    print(json.dumps(run()))
