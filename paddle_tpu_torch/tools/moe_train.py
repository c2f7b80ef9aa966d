"""Mixture-of-experts training with expert parallelism on one card:
``chip_smoke.py`` phase 31 (``moe_train``).

The reference test's ``MoEModel`` (``tests/test_moe.py``: Linear ->
``MoELayer`` -> Linear, ``testing/moe_ranks.MoEModel``) at the 1B
Llama's widths: d 2048, :data:`EXPERTS` experts of Linear(2048, 5632) ->
gelu -> Linear(5632, 2048), gate ``"gshard"`` with its own capacity
factors (train 1.2: C = 1229 slots an expert at 8192 tokens), 193,019,904
parameters of which 184,610,816 are the experts'; loss MSE + 0.01 aux on
a batch of 4 x 2048 tokens of 2048 features (``tanh`` of the input as
the target, as the reference test has it). Random weights from seed 0.

:func:`rank_part` runs on each rank of a world of 4 that share the card
(started by :func:`run`, or beside the context-parallel phase by
``gpt_1b_cp_train.run(parts=(..., "moe"))``):

(a) f32, three AdamW steps per placement (:data:`PLACEMENTS`: ep 4 with
    the batch replicated over ep, ep 4 with it sharded over ep (the
    all-to-all), dp 2 x ep 2), each held against a one-rank
    ``TrainStep`` of the same model and batch on the card: losses rtol
    1e-4, every rank's parameter shards at phase 28's AdamW bound;
(b) bf16, ep 4 sharded, one warm-up and :data:`TIMED_STEPS` timed steps
    against the one-rank bf16 ``TrainStep``: losses within
    :data:`BF16_LOSS_ATOL`, falling.

Each reports per step the choices dropped on the rank (tokens whose
expert was full), the aux loss, the all-to-all and collective bytes and
host ms (``communication.stats``), the step times and the peaks.

    python -m paddle_tpu_torch.tools.moe_train
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from paddle_tpu_torch.tools import gpt_1b_hybrid_train as H

__all__ = ["D_MODEL", "HIDDEN", "EXPERTS", "BATCH", "PLACEMENTS",
           "TIMED_STEPS", "rank_part", "rank_parts", "run"]

D_MODEL, HIDDEN, EXPERTS = 2048, 5632, 8
BATCH = (4, 2048)           # sequences x tokens, each of D_MODEL features
STEPS = 3
TIMED_STEPS = 3
LR = H.LR
BF16_LOSS_ATOL = 0.02
# name, mesh shape, mesh dims, ParallelConfig kwargs
PLACEMENTS = [
    ("ep4_replicated", [4], ["ep"], {}),
    ("ep4_sharded", [4], ["ep"], {"dp_axes": ("ep",)}),
    ("dp2_ep2", [2, 2], ["dp", "ep"], {}),
]
BF16 = ("ep4_sharded", [4], ["ep"], {"dp_axes": ("ep",)})


def _sizes(shrink):
    s = dict(d=D_MODEL, hidden=HIDDEN, experts=EXPERTS, batch=BATCH)
    s.update(shrink or {})
    return s


def _model(dev, s, dtype, ep):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.testing.moe_ranks import MoEModel

    paddle.set_device(str(dev).replace("cuda", "gpu"))
    paddle.seed(0)
    m = MoEModel(d=s["d"], n_experts=s["experts"], hidden=s["hidden"],
                 gate="gshard", ep_axis="ep" if ep else None,
                 capacity_factor=None)
    return m.bfloat16() if dtype == "bfloat16" else m


def _batch(dev, s, dtype):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*s["batch"], s["d"]).astype(np.float32))
    x = x.to(dev)
    return x.to(getattr(torch, dtype)), torch.tanh(x).to(getattr(torch,
                                                                 dtype))


def _steps(step, model, x, y, n, dev):
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.testing.moe_ranks import DropWatch

    watch = DropWatch()
    comm.stats(reset=True)
    losses, aux, step_ms = [], [], []
    try:
        for _ in range(n):
            t0 = time.perf_counter()
            loss = step(x, y)
            H._sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            aux.append(float(model.moe.aux_loss.item()))
    finally:
        watch.close()
    c = comm.stats()
    return {"losses": losses, "aux": aux, "dropped": watch.dropped,
            "step_ms": step_ms,
            "collective_calls_per_step": c["calls"] / n,
            "collective_bytes_per_step": c["bytes"] / n,
            "collective_host_ms_per_step": c["seconds"] * 1e3 / n}


def _one_rank(dev, s, dtype, steps):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.testing.moe_ranks import moe_loss

    model = _model(dev, s, dtype, ep=False)
    x, y = _batch(dev, s, dtype)
    step = TrainStep(model, moe_loss(model),
                     AdamW(learning_rate=LR, parameters=model.parameters()))
    out = _steps(step, model, x, y, steps, dev)
    params = {n: p._data.detach().clone()
              for n, p in model.named_parameters()}
    del model, step
    H._free(dev)
    return out, params


def _placed(dev, rank, case, s, dtype, steps):
    from paddle_tpu_torch.distributed import (ParallelConfig,
                                              ParallelTrainStep,
                                              ProcessMesh)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.testing.moe_ranks import moe_loss

    name, shape, dims, cfg = case
    mesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape), dims)
    model = _model(dev, s, dtype, ep=True)
    x, y = _batch(dev, s, dtype)
    H._reset_peak(dev)
    step = ParallelTrainStep(model, moe_loss(model),
                             AdamW(learning_rate=LR,
                                   parameters=model.parameters()),
                             mesh, ParallelConfig(**cfg), n_model_inputs=1)
    out = _steps(step, model, x, y, steps, dev)
    out["max_memory_allocated"] = H._peak(dev)
    out["local_params"] = sum(p._data.numel() for p in model.parameters())
    return out, model, step, mesh


def rank_part(dev, rank, shrink: dict = None, placements=PLACEMENTS,
              bf16=BF16) -> dict:
    """Parts (a) and (b) on this rank (module docstring): (a) at each of
    ``placements``, (b) at ``bf16``. ``shrink`` (``d``, ``hidden``,
    ``experts``, ``batch``) makes the model smaller (the card tests, a
    dry run on the CPU)."""
    import paddle_tpu_torch.distributed as dist

    t0 = time.perf_counter()
    s = _sizes(shrink)
    res = {"sizes": {k: list(v) if isinstance(v, tuple) else v
                     for k, v in s.items()}}
    ref, ref_params = _one_rank(dev, s, "float32", STEPS)
    res["reference_f32"] = ref
    res["f32"] = {}
    for case in placements:
        out, model, step, mesh = _placed(dev, rank, case, s, "float32",
                                         STEPS)
        out["losses_ok"] = bool(np.allclose(out["losses"], ref["losses"],
                                            rtol=H.LOSS_RTOL))
        named = [(n, p._data) for n, p in model.named_parameters()]
        out["params"] = H._compare(named, step.layouts(),
                                   mesh.process_ids.index(rank), ref_params)
        res["f32"][case[0]] = out
        del model, step
        H._free(dev)
        dist.barrier()
    del ref_params
    H._free(dev)
    # (b): bf16, the one-rank step then the sharded placement
    ref16, p16 = _one_rank(dev, s, "bfloat16", 1 + TIMED_STEPS)
    del p16
    out, model, step, _ = _placed(dev, rank, bf16, s, "bfloat16",
                                  1 + TIMED_STEPS)
    out["reference_losses"] = ref16["losses"]
    out["max_loss_diff"] = max(abs(a - b) for a, b in
                               zip(out["losses"], ref16["losses"]))
    out["step_ms_p50"] = float(np.percentile(out["step_ms"][1:], 50))
    res["bf16"] = out
    del model, step
    H._free(dev)
    res["seconds"] = time.perf_counter() - t0
    return res


def rank_parts(dev, rank, warm, shrink=None) -> dict:
    """:func:`rank_part` on a rank of a joined world (a job of
    ``gpt_1b_hybrid_train.run_jobs``)."""
    import paddle_tpu_torch.distributed as dist

    return {"backend": dist.get_backend(), "device": str(dev),
            "moe": rank_part(dev, rank, shrink)}


def run(timeout_s: float = 600.0, shrink: dict = None) -> dict:
    """Start a world of 4 ranks on the card, run :func:`rank_part` on
    each and return their results (``gpt_1b_hybrid_train.run_jobs``)."""
    out = H.run_jobs([("paddle_tpu_torch.tools.moe_train",
                       {"shrink": shrink})], timeout_s, "moe_train")
    return {"ranks": out["jobs"][0], "alive_after": out["alive_after"]}


if __name__ == "__main__":
    print(json.dumps(run()))
