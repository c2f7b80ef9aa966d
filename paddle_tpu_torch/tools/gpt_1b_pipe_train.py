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
    and post parameters must hold the reckoned 1/S of their elements.
    Three cases do more: ``pp4_1f1b`` saves after step 2 (a multi-rank
    checkpoint of the step's state, ``PipelineTrainStep.state_dict``),
    rebuilds the ``PipelineLayer`` and the step on the same ranks,
    restores and reruns step 3, whose loss, parameters and slots must be
    bit-identical to the unbroken step 3's; ``pp2_lamb`` trains with
    ``Lamb`` against a one-rank ``TrainStep`` with ``Lamb``, each
    parameter's update within :data:`LAMB_UPDATE_REL` of the one-rank
    update; ``pp2_sp2_cp`` runs the context-parallel Pipe at pp 2 x sp 2
    (each microbatch's sequence cut over sp, the attention over the
    ring), its largest |diff| within :data:`CP_PARAM_MAX_ABS`, and
    counts its K2-K4 launches against :func:`reckoned_cp_launches`. The
    worst element of each case carries the one-rank run's first
    gradient there and the share of its parameter's elements with a
    smaller one (``grad_quantile``): AdamW moves an element by about lr
    a step whatever its gradient's size, so where the two runs'
    summation orders flip the sign of a gradient near zero, an element
    lands up to 2 lr a step apart;
(b) bf16 at full width and depth (0.95B parameters, 16 layers), pp 4,
    "1f1b", M 4, ``shard_pre_post=True``, ``remat_body=True``: one
    warm-up and :data:`TIMED_STEPS` timed steps. The losses (for the
    caller to hold against phase 7's), K2-K4 launches on each rank
    (4 layers x 4 microbatches a step, K2 twice for the recompute), the
    step times, the P2P and collective host seconds
    (``communication.stats``), rank 0's device-phase breakdown of its
    timed step (traced), each rank's parameter count and peak memory.

Four ranks share one card over gloo through the host: this checks the
path's numbers and its kernel launches, not pipeline speed.

    python -m paddle_tpu_torch.tools.gpt_1b_pipe_train
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from paddle_tpu_torch.tools import gpt_1b_hybrid_train as H

__all__ = ["WORLD", "F32_LAYERS", "TIMED_STEPS", "CASES", "CKPT_DIR",
           "reckoned_cp_launches", "rank_parts", "run"]

WORLD = 4
F32_LAYERS = 8
# (b)'s timed steps: one, for chip_smoke.py's time limit
TIMED_STEPS = 1
LR = H.LR
STEPS = 3
LOSS_RTOL = H.LOSS_RTOL
# name, mesh shape, mesh dims, schedule, n_microbatches, interleave V,
# options: "round_trip" (a checkpoint after step 2), "opt" (the
# optimizer, AdamW by default), "cp" (context parallel over "sp")
CASES = [
    ("pp4_1f1b", [4], ["pp"], "1f1b", 4, 1, {"round_trip": True}),
    ("pp2_1f1b_two_chunks", [2], ["pp"], "1f1b", 4, 1),
    ("pp2_lamb", [2], ["pp"], "1f1b", 4, 1, {"opt": "lamb"}),
    ("dp2_pp2", [2, 2], ["dp", "pp"], "1f1b", 2, 1),
    ("pp2_mp2", [2, 2], ["pp", "mp"], "1f1b", 4, 1),
    ("pp4_gpipe", [4], ["pp"], "gpipe", 4, 1),
    ("pp4_zero_bubble", [4], ["pp"], "zero_bubble", 4, 1),
    ("pp4_interleave", [4], ["pp"], "interleave", 4, 2),
    ("pp2_sp2_cp", [2, 2], ["pp", "sp"], "1f1b", 4, 1, {"cp": True}),
]
# the round trip's checkpoint, under the checkout (removed after)
CKPT_DIR = "_pipe_ckpt_smoke"


def reckoned_cp_launches(sp_index: int, layers: int, microbatches: int,
                         steps: int, remat: bool = True) -> dict:
    """K2-K4 launches of a context-parallel pipeline rank: each of its
    ``layers`` body layers on each microbatch is one
    ``gpt_1b_cp_train.reckoned_launches`` layer, and with ``remat`` the
    backward runs the forward again (K2 twice)."""
    from paddle_tpu_torch.tools.gpt_1b_cp_train import reckoned_launches

    out = reckoned_launches(sp_index, layers * microbatches, steps)
    if remat:
        out["flash_attention_fwd"] *= 2
    return out


# Lamb's bound: each parameter's update within this share of the one-rank
# update (``_update_errors``), between the readings of sound runs on an
# H100 (3.4e-5 here, 9.3e-6 in the card tests' pair) and of runs without
# the pp norm_reduce (4.3e-3 and 4.5e-3); an update skipped reads 1
LAMB_UPDATE_REL = 5e-4
# pp2_sp2_cp's largest |diff|: twice its sound reading on an H100
# (2.515e-4 in two runs, at an element whose one-rank first gradient is
# 3e-9 against a median 1.7e-4; the dense pp2_mp2 reads 2.05e-4 there),
# where the ring's merges add summation orders to phase 28's
CP_PARAM_MAX_ABS = 5e-4


def _opts(case) -> dict:
    return case[6] if len(case) > 6 else {}


def _opt_name(case) -> str:
    """The optimizer of a case, and of the one-rank run it is held
    against."""
    return _opts(case).get("opt", "adamw")


def _optimizer(name: str, params):
    from paddle_tpu_torch.optimizer import AdamW, Lamb

    return {"adamw": AdamW, "lamb": Lamb}[name](learning_rate=LR,
                                                parameters=params)
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


def _stage(dev, layers, dtype, mesh, rank, v, cp=False, load=True):
    """This rank's Pipe stage, loaded with the seed-0 model's weights
    unless ``load`` is False (a stage a checkpoint restores; ``cp``:
    context parallel over "sp", no batch axis)."""
    from dataclasses import replace

    from paddle_tpu_torch.models.convert import (
        llama_pipe_state_from_causal_lm)
    from paddle_tpu_torch.models.llama import LlamaForCausalLMPipe

    S = mesh.dim_size("pp")
    stage = mesh.coord(rank)[mesh.dim_names.index("pp")] if S > 1 else 0
    cfg = replace(H._config(), num_hidden_layers=layers, dtype=dtype)
    if cp:
        cfg = replace(cfg, context_parallel=True, cp_batch_axis=None)
    pipe = LlamaForCausalLMPipe(cfg, S, device=dev, stage_id=stage,
                                num_virtual_pipeline_stages=v)
    if not load:
        return pipe
    model = H._model(dev, layers, dtype)
    state = llama_pipe_state_from_causal_lm(model.state_dict(), pipe._owned)
    missing, _ = pipe.set_state_dict(state)
    del model, state
    H._free(dev)
    if missing:
        raise KeyError(f"no weights for {missing}")
    return pipe


def _compare(pipe, step, index, ref, max_abs=H.PARAM_MAX_ABS):
    """Each parameter shard against the same slice of the one-rank
    parameters (phase 28's readings and bound, the largest |diff| within
    ``max_abs``); the worst element with the one-rank first gradient
    there."""
    per_param, worst, where, ok = {}, 0.0, None, True
    layouts = step.layouts()
    for name, p in pipe.named_parameters():
        full = ref["params"][_pipe_to_model_name(name)]
        cut = layouts[name].shard_slices(tuple(full.shape), index)
        want = full[cut]
        diff = (p.detach() - want).abs()
        out = int((diff > H.PARAM_ATOL + H.PARAM_RTOL * want.abs()).sum())
        noisy = int((diff > H.ADAM_NOISE).sum())
        m = float(diff.max())
        per_param[name] = {"max_abs_err": m, "beyond_noise": noisy,
                           "outside_rtol_atol": out,
                           "elements": diff.numel()}
        ok = ok and m <= max_abs and \
            noisy < H.ADAM_SHARE * diff.numel()
        if m > worst:
            worst = m
            at = int(diff.argmax())
            g = ref["grads"][_pipe_to_model_name(name)][cut].reshape(-1)
            where = {"param": name, "index": at, "diff": m,
                     "value": float(want.reshape(-1)[at]),
                     "got": float(p.detach().reshape(-1)[at]),
                     "grad": float(g[at]),
                     "grad_quantile": float(
                         (g.abs() < g[at].abs()).double().mean()),
                     "grad_median_abs": float(g.abs().median())}
    return {"within_adam_bound": ok, "max_abs_bound": max_abs,
            "max_abs_err": worst,
            "outside_rtol_atol": sum(v["outside_rtol_atol"]
                                     for v in per_param.values()),
            "beyond_noise": sum(v["beyond_noise"]
                                for v in per_param.values()),
            "elements": sum(v["elements"] for v in per_param.values()),
            "worst": where, "per_param": per_param}


def _update_errors(pipe, step, index, ref, init):
    """Lamb's check: each parameter shard's update against the same
    slice of the one-rank update, ||p - p_ref|| / ||p_ref - p_0|| (a
    trust ratio off by k reads |k - 1|, an update skipped 1), and the
    parameters whose shard did not move from ``init``."""
    layouts = step.layouts()
    rel, still = {}, []
    for name, p in pipe.named_parameters():
        full = ref["params"][_pipe_to_model_name(name)]
        want = full[layouts[name].shard_slices(tuple(full.shape), index)]
        p = p.detach()
        rel[name] = float((p - want).norm() / (want - init[name]).norm())
        if torch.equal(p, init[name]):
            still.append(name)
    worst = max(rel, key=rel.get)
    return {"max_rel_err": rel[worst], "worst": worst, "unmoved": still,
            "within_lamb_bound": rel[worst] <= LAMB_UPDATE_REL
            and not still, "per_param": rel}


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


def _state(step) -> dict:
    """A host copy of the step's parameters and slots by state name."""
    return {f"{sec}/{k}": v.detach().cpu().clone()
            for sec, d in step.state_dict().items() for k, v in d.items()
            if isinstance(v, torch.Tensor)}


def _round_trip(dev, rank, case, mesh, step, x, y):
    """After step 2: save the step's state, run the unbroken step 3, then
    rebuild the stage and the step on the same ranks, restore, rerun step
    3; the two step 3s' loss, parameters and slots, bit for bit."""
    import shutil

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                         save_state_dict)
    from paddle_tpu_torch.distributed.fleet.pp_engine import (
        PipelineTrainStep)

    name, shape, dims, schedule, M, v = case[:6]
    path = os.path.join(os.getcwd(), CKPT_DIR)
    H._sync(dev)
    t0 = time.perf_counter()
    save_state_dict(step.state_dict(), path)
    save_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size()
                 for d in step.state_dict().values() for t in d.values()
                 if isinstance(t, torch.Tensor))
    loss = float(step(x, y))
    want = _state(step)
    # the restore writes every parameter: no seed-0 model to build
    pipe = _stage(dev, F32_LAYERS, "float32", mesh, rank, v, load=False)
    again = PipelineTrainStep(pipe, pipe.get_loss_fn(),
                              _optimizer("adamw", pipe.parameters()), mesh,
                              n_microbatches=M, schedule=schedule)
    state = again.state_dict()
    H._sync(dev)
    t0 = time.perf_counter()
    load_state_dict(state, path)
    again.set_state_dict(state)
    H._sync(dev)
    restore_s = time.perf_counter() - t0
    got_loss = float(again(x, y))
    got = _state(again)
    same = sorted(k for k in want if torch.equal(want[k], got[k]))
    del pipe, again, state
    H._free(dev)
    dist.barrier()
    if rank == mesh.process_ids[0]:
        shutil.rmtree(path, ignore_errors=True)
    return loss, {"loss": loss, "restored_loss": got_loss,
                  "loss_bit_identical": got_loss == loss,
                  "tensors": len(want), "bit_identical_tensors": len(same),
                  "slots": sum(1 for k in want if k.startswith("opt/")),
                  "bytes_this_rank": nbytes, "save_s": save_s,
                  "restore_s": restore_s}


def _case(dev, rank, case, first, x, y, ref):
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.distributed.fleet.pp_engine import (
        PipelineTrainStep)
    from paddle_tpu_torch.ops import flash_attention as fa

    name, shape, dims, schedule, M, v = case[:6]
    opts = _opts(case)
    n = int(np.prod(shape))
    mesh = ProcessMesh(np.arange(first, first + n).reshape(shape), dims)
    pipe = _stage(dev, F32_LAYERS, "float32", mesh, rank, v,
                  cp=opts.get("cp", False))
    opt = _optimizer(_opt_name(case), pipe.parameters())
    H._reset_peak(dev)
    step = PipelineTrainStep(pipe, pipe.get_loss_fn(), opt, mesh,
                             n_microbatches=M, schedule=schedule,
                             interleave_degree=max(v, 1))
    # the shards the step starts from (it cuts the pre/post slices)
    init = {n: p.detach().clone() for n, p in pipe.named_parameters()} \
        if _opt_name(case) == "lamb" else None
    losses, step_s = [], []
    trip = None
    for name_ in fa.launches:
        fa.launches[name_] = 0
    for i in range(STEPS):
        t0 = time.perf_counter()
        if opts.get("round_trip") and i == STEPS - 1:
            loss, trip = _round_trip(dev, rank, case, mesh, step, x, y)
            losses.append(loss)
        else:
            losses.append(float(step(x, y)))
        step_s.append(time.perf_counter() - t0)
    launches = dict(fa.launches)
    ref = ref[_opt_name(case)]
    index = mesh.process_ids.index(rank)
    cmp = _compare(pipe, step, index, ref, CP_PARAM_MAX_ABS
                   if opts.get("cp") else H.PARAM_MAX_ABS)
    shares = _shares(pipe, step, mesh)
    out = {"losses": losses, "optimizer": _opt_name(case),
           "losses_ok": bool(np.allclose(losses, ref["losses"],
                                         rtol=LOSS_RTOL)),
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
    if trip is not None:
        out["round_trip"] = trip
    if init is not None:
        out["lamb_update"] = _update_errors(pipe, step, index, ref, init)
    if opts.get("cp"):
        sp = mesh.coord(rank)[dims.index("sp")]
        out["sp_index"] = sp
        out["kernel_launches"] = launches
        out["reckoned_launches"] = reckoned_cp_launches(
            sp, len(pipe._owned), M, STEPS)
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

    def timed():
        t1 = time.perf_counter()
        loss = step(x, y)
        H._sync(dev)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))

    phases = None
    for i in range(TIMED_STEPS):
        # rank 0 traces its last timed step (its ms include the trace)
        if rank == 0 and H._cuda(dev) and i == TIMED_STEPS - 1:
            phases = profiler.device_phases(timed, steps=1, warmup=0)
        else:
            timed()
    launches = dict(fa.launches)          # the main path ends here
    coll = comm.stats()
    peak = H._peak(dev)
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


def _reference(dev, x, y, opt: str):
    """The one-rank TrainStep of part (a) with optimizer ``opt``: its
    losses, its final parameters and (on the host) its first
    gradients."""
    from paddle_tpu_torch.jit import TrainStep

    class _FirstGrads(TrainStep):
        grads = None

        def _sync(self, grads, loss):
            if self.grads is None:
                self.grads = [g.detach().cpu() for g in grads]
            return grads, loss

    model = H._model(dev, F32_LAYERS, "float32")
    step = _FirstGrads(model, model.criterion(model.config),
                       _optimizer(opt, model.parameters()))
    losses = [float(step(x, y)) for _ in range(STEPS)]
    named = list(model.named_parameters())
    out = {"losses": losses,
           "params": {n: p.detach().clone() for n, p in named},
           "grads": dict(zip([n for n, _ in named], step.grads))}
    del model, step
    H._free(dev)
    return out


def rank_parts(dev, rank, warm, parts=("a", "b"), shrink=None) -> dict:
    """This tool's ``parts`` on a rank of a joined world (a job of
    ``gpt_1b_hybrid_train.run_jobs``)."""
    import paddle_tpu_torch.distributed as dist

    H._shrink.clear()
    H._shrink.update(shrink or {})
    res = {"backend": dist.get_backend(), "device": str(dev), "cases": {}}
    if "a" in parts:
        x, y = H._batch(dev)
        # the one-rank references, two at a time (two 8-layer f32 runs
        # fit the card; four would not): AdamW's on every rank, then each
        # other optimizer's on the ranks of its cases
        jobs = [(r, "adamw") for r in range(WORLD)] + sorted(
            {(r, _opt_name(case)) for case, first in sum(_rounds(), [])
             for r in range(first, first + int(np.prod(case[1])))
             if _opt_name(case) != "adamw"})
        ref = {}
        for turn in range(0, len(jobs), 2):
            for r, opt in jobs[turn:turn + 2]:
                if r == rank:
                    ref[opt] = _reference(dev, x, y, opt)
            dist.barrier()
        res["reference_losses"] = ref["adamw"]["losses"]
        warm.join()
        for cases in _rounds():
            for case, first in cases:
                if first <= rank < first + int(np.prod(case[1])):
                    res["cases"][case[0]] = _case(dev, rank, case, first,
                                                  x, y, ref)
            dist.barrier()
        del ref, x, y
        H._free(dev)
    if "b" in parts:
        res["full"] = _full(dev, rank)
    return res


def run(parts=("a", "b"), timeout_s: float = 600.0,
        shrink: dict = None) -> dict:
    """Start the world on the card, run ``parts`` and return each rank's
    results; raises with a rank's traceback if one failed or after
    ``timeout_s``; leaves no process behind. ``shrink`` (LlamaConfig
    fields, and ``batch``: (batch, seq)) makes the model smaller for a
    dry run on the CPU."""
    out = H.run_jobs([("paddle_tpu_torch.tools.gpt_1b_pipe_train",
                       {"parts": tuple(parts), "shrink": shrink})],
                     timeout_s, "pipeline_train")
    return {"ranks": out["jobs"][0], "alive_after": out["alive_after"]}


if __name__ == "__main__":
    print(json.dumps(run()))
