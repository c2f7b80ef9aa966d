"""The training script the launcher runs for ``chip_smoke.py`` phase 32
(``gang``): ``bench.py``'s ``bench_gpt_1b`` at its full widths (hidden
2048, MLP 5632, 16 heads, vocab 32000, batch 4 x 2048), :data:`LAYERS`
of its 16 layers, bf16 with f32 master weights (AdamW
``multi_precision``), through a
:class:`~paddle_tpu_torch.distributed.ParallelTrainStep` at dp 2 x mp 2
with ZeRO 1 and sequence parallelism. Every rank runs::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
        paddle_tpu_torch/tools/gpt_1b_gang_train.py --ckpt DIR --out DIR

(four ranks on one card need ``PADDLE_TORCH_RANKS_SHARE_DEVICE=1``;
the repository root on ``PYTHONPATH``). The loop has the shape of a
fault-tolerant trainer: ``init_parallel_env``; a
:class:`~paddle_tpu_torch.distributed.checkpoint.CheckpointManager`
(async saves every step, the last two kept) with the preemption handler
and ``restore_or_initialize``; the batch of step k is drawn from seed k,
so a resumed run sees the batches the unbroken one saw. Once restored,
and after each step's save, the rank rewrites ``progress.rank<r>.json``
(its step and the launcher's attempt). After each step it saves and polls
``reached_preemption`` (a preempted gang takes its final blocking save
at one step and exits 0). At a clean exit it writes
``result.attempt<a>.rank<r>.json``: the losses by step, a sha256 of
every parameter shard and optimizer slot, the flash kernels' launches
(K2-K4), device, backend, peak memory, start-up (with its marks:
imports, ``init_parallel_env``, the model and step built) and restore
seconds, each step's seconds, each save's wait for the previous write,
snapshot ms, write seconds and bytes.

One switch belongs to this script, not to the library: ``GANG_HANG=
"<rank>:<step>"`` makes that rank, on the gang's first attempt only
(``PADDLE_RESTART_COUNT`` 0), wait for its previous save to be
committed (so that the restart has that step to restore), then arm the
default watchdog with the tag ``all_reduce@ranks[<every rank>]`` in
place of the step and never finish it. It arms with a quarter of the
timeout, so that its deadline passes before those of its peers, which
armed the step with the whole timeout and block in its first
collective: it exits 6, and they read its abort record and exit 7.

``--tiny`` runs ``LlamaConfig.tiny()`` in f32 with a batch of 4 x 32
(the CPU tests and the card test); ``--dp``/``--mp`` set the mesh
(their product is the world).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

_T0 = time.time()

import numpy as np  # noqa: E402
import torch  # noqa: E402

LAYERS = 2
LR = 3e-4
HANG_ENV = "GANG_HANG"
HANG_FACTOR = 0.25   # the hang's deadline, in timeouts


def _write_json(path: str, obj) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def _config(tiny: bool):
    from dataclasses import replace

    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.tools import gpt_1b_train

    if tiny:
        return LlamaConfig.tiny(dtype="float32", sequence_parallel=True)
    return replace(gpt_1b_train.config(), num_hidden_layers=LAYERS,
                   sequence_parallel=True)


def _batch(step: int, cfg, tiny: bool, dev):
    from paddle_tpu_torch.tools import gpt_1b_train

    shape = (4, 32) if tiny else (gpt_1b_train.BATCH, gpt_1b_train.SEQ)
    rng = np.random.RandomState(step)
    x = rng.randint(0, cfg.vocab_size, shape).astype(np.int32)
    y = rng.randint(0, cfg.vocab_size, shape).astype(np.int32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def _sha(t: torch.Tensor) -> str:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def _hang(rank: int, world: int, mgr):
    """The hang switch: let the previous step's save land, then arm a
    collective's tag with a quarter of the timeout and never finish
    it."""
    from paddle_tpu_torch.distributed.watchdog import default_watchdog

    mgr.wait()
    wd = default_watchdog()
    armed = time.time()
    wd.arm(f"all_reduce@ranks{list(range(world))}", factor=HANG_FACTOR)
    print(f"GANG_HANG rank={rank} armed={armed:.3f} "
          f"deadline={armed + HANG_FACTOR * wd.timeout:.3f}", flush=True)
    while True:
        time.sleep(60)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--mp", type=int, default=2)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import (ParallelConfig,
                                              ParallelTrainStep,
                                              ProcessMesh)
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.env import current_device
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    marks = {"imports": time.time() - _T0}
    dist.init_parallel_env()
    marks["init"] = time.time() - _T0
    rank, world = dist.get_rank(), dist.get_world_size()
    attempt = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
    dev = current_device()
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        torch.set_num_threads(1)
    if args.dp * args.mp != world:
        raise SystemExit(f"dp {args.dp} x mp {args.mp} is not the world "
                         f"of {world} ranks")
    cfg = _config(args.tiny)
    model = LlamaForCausalLM(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                multi_precision=True)
    mesh = ProcessMesh(np.arange(world).reshape(args.dp, args.mp),
                       ["dp", "mp"])
    step_fn = ParallelTrainStep(model, model.criterion(cfg), opt, mesh,
                                ParallelConfig(sharding_stage=1))
    marks["build"] = time.time() - _T0

    saves = []

    class Manager(CheckpointManager):
        """Times each save's write (the writer thread's work)."""

        def _write_and_commit(self, step, *a):
            t = time.perf_counter()
            super()._write_and_commit(step, *a)
            saves.append({"step": step,
                          "write_s": time.perf_counter() - t})

    mgr = Manager(args.ckpt, keep_last_n=2, async_save=True,
                  save_interval_steps=1)
    mgr.install_preemption_handler()

    def state():
        return {"model": model.state_dict(), "opt": opt.state_dict()}

    st = state()
    t = time.perf_counter()
    resumed = mgr.restore_or_initialize(st)
    restore_s = time.perf_counter() - t
    if resumed is not None:
        opt.set_state_dict(st["opt"])
    if cuda:
        torch.cuda.synchronize(dev)
    startup_s = time.time() - _T0
    start = resumed or 0
    progress = os.path.join(args.out, f"progress.rank{rank}.json")
    _write_json(progress, {"step": start, "attempt": attempt})
    hang = os.environ.get(HANG_ENV)
    for name in fa.launches:
        fa.launches[name] = 0
    losses, preempted_at = {}, None
    step_s, wait_ms, snapshot_ms = {}, {}, {}
    for step in range(start + 1, args.steps + 1):
        if hang and attempt == 0 and \
                [int(v) for v in hang.split(":")] == [rank, step]:
            _hang(rank, world, mgr)
        x, y = _batch(step, cfg, args.tiny, dev)
        t = time.perf_counter()
        losses[step] = float(step_fn(x, y))
        step_s[step] = time.perf_counter() - t
        # the previous save's write, if still running, then the snapshot
        mgr.wait()
        wait_ms[step] = (time.perf_counter() - t) * 1e3 - step_s[step] * 1e3
        t = time.perf_counter()
        mgr.save(step, state())
        snapshot_ms[step] = (time.perf_counter() - t) * 1e3
        _write_json(progress, {"step": step, "attempt": attempt})
        if mgr.reached_preemption(step):
            mgr.save(step, state(), block=True, force=True)
            preempted_at = step
            break
    marks["loop"] = time.time() - _T0
    mgr.wait()
    marks["last_write"] = time.time() - _T0
    shards = {f"param/{n}": _sha(p) for n, p in model.named_parameters()}
    for key, v in opt.state_dict().items():
        if isinstance(v, torch.Tensor):
            shards[f"opt/{key}"] = _sha(v)
    data = os.path.join(args.ckpt, f"step_{mgr.latest_step()}",
                        f"data_{rank}.npz")
    _write_json(os.path.join(args.out,
                             f"result.attempt{attempt}.rank{rank}.json"), {
        "rank": rank, "world": world, "attempt": attempt,
        "device": str(dev), "backend": dist.get_backend(),
        "resumed_from": resumed, "preempted_at": preempted_at,
        "final_step": preempted_at or args.steps,
        "losses": {str(k): v for k, v in losses.items()},
        "sha256": shards, "kernel_launches": dict(fa.launches),
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if cuda else None),
        "startup_s": startup_s, "restore_s": restore_s,
        "marks_s": dict(marks, hashed=time.time() - _T0),
        "started_at": _T0,
        "step_s": {str(k): v for k, v in step_s.items()},
        "wait_ms": {str(k): v for k, v in wait_ms.items()},
        "snapshot_ms": {str(k): v for k, v in snapshot_ms.items()},
        "saves": saves, "slot_bytes": step_fn.slot_bytes(),
        "bytes_saved_last": (os.path.getsize(data)
                             if os.path.exists(data) else 0),
        "committed": mgr.all_steps()})
    print(f"GANG_DONE rank={rank} attempt={attempt} "
          f"final_step={preempted_at or args.steps}", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
