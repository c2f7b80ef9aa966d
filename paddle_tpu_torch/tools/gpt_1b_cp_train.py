"""Context-parallel training of ``bench.py``'s ``bench_gpt_1b`` on one
card, and the mixture of experts beside it: ``chip_smoke.py`` phases 30
(``cp_train``) and 31 (``moe_train``, :mod:`~paddle_tpu_torch.tools.
moe_train`).

One world of :data:`WORLD` ranks is started with
``paddle_tpu_torch.distributed.spawn`` and joins through
``init_parallel_env``; inside :func:`~paddle_tpu_torch.testing.tp_hooks.
ranks_share_one_device` every rank takes the first card and the world is
gloo. The Llama runs with ``context_parallel=True``: each rank of the
``sp`` axis holds its chunk of the sequence through the whole stack and
the attention is the ring (K2-K4 on each chunk, the key/value chunks
passed around the ring by batched isend/irecv through the host). Parts:

(a) f32 at ``bench_gpt_1b`` widths, :data:`F32_LAYERS` of its 16 layers,
    batch 4 x 2048, three AdamW steps per case (:data:`CASES`: dp 2 x sp
    2, sp 4 with ``cp_batch_axis=None``, dp 2 x sp 2 with ZeRO 1), each
    held against a one-rank ``TrainStep`` of the dense model with the
    same weights and batches on the card, as phase 28 holds its cases
    (``gpt_1b_hybrid_train``: losses rtol 1e-4, each parameter shard at
    the AdamW bound); then ``cp_dp2_sp2_masked``: the model at
    :data:`MASKED_LAYERS` layers given a padding mask that cuts a
    different number of keys in each sequence (:data:`MASKED_LENS`), one
    forward and backward at dp 2 x sp 2 (each rank its query rows, K and
    V all-gathered over sp, dense attention with the mask, not causal:
    the reference's masked branch), held against the one-rank dense
    model's forward and backward on the whole batch (each rank's logits
    and the gradients summed over the ranks, every reading's largest
    |diff| within :data:`MASKED_REL` of its largest value);
(b) bf16 at full width and depth, dp 2 x sp 2, ZeRO 1 over dp: one
    warm-up and :data:`TIMED_STEPS` timed steps. The losses (for the
    caller to hold against phase 7's), K2-K4's launches on each rank
    (the reckoned count: a rank at sp index r runs r + 1 chunks a layer,
    its diagonal and the r earlier ones, in the forward and as many in
    the backward), the step times, the ring's P2P and the collectives'
    host seconds and bytes (``communication.stats``) and each rank's
    peak memory;
(moe) :func:`~paddle_tpu_torch.tools.moe_train.rank_part`.

Four ranks share one card over gloo through the host: this checks the
path's numbers and its kernel launches, not parallel speed.

    python -m paddle_tpu_torch.tools.gpt_1b_cp_train
"""
from __future__ import annotations

import json

from paddle_tpu_torch.tools import gpt_1b_hybrid_train as H

__all__ = ["WORLD", "F32_LAYERS", "TIMED_STEPS", "CASES", "FULL",
           "MASKED_LAYERS", "MASKED_LENS", "MASKED_REL", "masked_case",
           "reckoned_launches", "rank_parts", "run"]

WORLD = H.WORLD
F32_LAYERS = H.F32_LAYERS
TIMED_STEPS = H.TIMED_STEPS
CP = {"context_parallel": True}
# name, mesh shape, mesh dims, ParallelConfig kwargs, LlamaConfig kwargs
CASES = [
    ("cp_dp2_sp2", [2, 2], ["dp", "sp"], {}, CP),
    ("cp_sp4", [4], ["sp"], {}, dict(CP, cp_batch_axis=None)),
    ("cp_dp2_sp2_zero1", [2, 2], ["dp", "sp"], {"sharding_stage": 1}, CP),
]
# (a)'s masked call: layers, each sequence's valid keys, bound
MASKED_LAYERS = 2
MASKED_LENS = [2048, 1701, 1250, 731]
MASKED_REL = 1e-4


def masked_case() -> dict:
    """The masked call's case (``testing.cp_ranks.masked_call``)."""
    from dataclasses import asdict, replace

    cfg = replace(H._config(), num_hidden_layers=MASKED_LAYERS,
                  dtype="float32", **CP)
    b, s = H._shrink.get("batch", (4, 2048))
    return {"name": "cp_dp2_sp2_masked", "spec": asdict(cfg),
            "mesh": [2, 2], "dims": ["dp", "sp"], "batch": (b, s),
            "lens": [max(1, n * s // 2048) for n in MASKED_LENS],
            "seed": 30}


def _masked(dev, rank):
    """(a)'s masked call on this rank against the one-rank reference,
    which the ranks run one at a time."""
    import time

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.testing import cp_ranks

    case = masked_case()
    H._reset_peak(dev)
    t0 = time.perf_counter()
    got = cp_ranks.masked_call(rank, case, device=str(dev))
    H._sync(dev)
    seconds = time.perf_counter() - t0
    errs = None
    for r in range(WORLD):
        if r == rank:
            ref = cp_ranks.masked_reference(case, device=str(dev))
            errs = cp_ranks.masked_errors(got, ref)
            del ref
            H._free(dev)
        dist.barrier()
    worst = max(errs, key=errs.get)
    return {"lens": case["lens"], "dp": got["dp"], "sp": got["cp"],
            "seconds": seconds, "max_rel_err": errs[worst],
            "worst": worst, "logits_rel_err": errs["logits"],
            "within": all(v <= MASKED_REL for v in errs.values()),
            "max_memory_allocated": H._peak(dev)}


# (b): the full model
FULL = ([2, 2], ["dp", "sp"], {"sharding_stage": 1}, CP)


def reckoned_launches(sp_index: int, layers: int, steps: int) -> dict:
    """K2, K3 and K4 launches of ``steps`` steps on the rank at sp index
    ``sp_index``: its diagonal chunk and the ``sp_index`` earlier ones, a
    layer, once in the forward and once in the backward."""
    n = (sp_index + 1) * layers * steps
    return {"flash_attention_fwd": n, "flash_attention_bwd_dq": n,
            "flash_attention_bwd_dkv": n}


def rank_parts(dev, rank, warm, parts=("a", "b"), shrink=None,
               moe_shrink=None) -> dict:
    """This tool's ``parts`` ("a", "b" and "moe") on a rank of a joined
    world (a job of ``gpt_1b_hybrid_train.run_jobs``)."""
    import paddle_tpu_torch.distributed as dist

    H._shrink.clear()
    H._shrink.update(shrink or {})
    res = {"backend": dist.get_backend(), "device": str(dev), "cases": {}}
    if "a" in parts:
        x, y = H._batch(dev)
        ref = H._reference(dev, x, y)
        res["reference_losses"] = ref[0]
        warm.join()
        for case in CASES:
            res["cases"][case[0]] = H._case(dev, rank, case, 0, x, y, ref)
            dist.barrier()
        del ref, x, y
        H._free(dev)
        res["masked"] = _masked(dev, rank)
    if "b" in parts:
        res["full"] = H._full(dev, rank, FULL, phases=False)
        res["full"]["sp_index"] = rank % 2
    if "moe" in parts:
        from paddle_tpu_torch.tools import moe_train

        res["moe"] = moe_train.rank_part(dev, rank, moe_shrink)
    return res


def run(parts=("a", "b"), timeout_s: float = 600.0, shrink: dict = None,
        moe_shrink: dict = None) -> dict:
    """Start the world on the card, run ``parts`` ("a", "b" and "moe")
    and return each rank's results; raises with a rank's traceback if one
    failed or after ``timeout_s``; leaves no process behind. ``shrink``
    and ``moe_shrink`` make the models smaller for a dry run on the CPU
    (``gpt_1b_hybrid_train.run``'s and ``moe_train.rank_part``'s)."""
    out = H.run_jobs([("paddle_tpu_torch.tools.gpt_1b_cp_train",
                       {"parts": tuple(parts), "shrink": shrink,
                        "moe_shrink": moe_shrink})], timeout_s, "cp_train")
    return {"ranks": out["jobs"][0], "alive_after": out["alive_after"]}


if __name__ == "__main__":
    print(json.dumps(run(parts=("a", "b", "moe"))))
