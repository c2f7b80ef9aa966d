"""Where a training step's time goes on the card.

    python -m paddle_tpu_torch.tools.profile_train [--eager] [--out DIR]

Trains the configuration of ``chip_smoke.py`` phase ``train``
(:mod:`paddle_tpu_torch.tools.gpt_1b_train`: the 0.95B Llama at full
width and depth, bf16, batch 4 x 2048, AdamW) for one warm-up step, then
profiles 2 steps with ``torch.profiler``; with ``--eager``, phase
``eager_train``'s loop over the same model (``tools/eager_train.py``:
AdamW with f32 master weights, the clip, a scheduler and a scaler). It prints one JSON line: host
wall time per step, device kernels per step, device busy time (the sum
of kernel times; this path runs one stream), its share of the wall time,
device time per step by group (the flash kernels, GEMMs, the rest), and
the top kernels. The profiler's own host overhead lengthens the wall
time; ``chip_smoke.py`` gives the unprofiled step times. With ``--out
DIR`` the full profiler table goes to ``DIR/profile_train.txt``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from paddle_tpu_torch.tools.profile_serve import _device_us, _is_kernel

STEPS = 2
# device-time groups, by kernel name (first match wins; the bf16
# tensor-core kernels flash_fwd_kernel_tc and flash_bwd_dkv_kernel_tc
# match the same substrings as the f32-FMA ones)
GROUPS = (("flash_fwd (K2)", ("flash_fwd_kernel",)),
          ("flash_bwd_dq (K3)", ("flash_bwd_dq_kernel",)),
          ("flash_bwd_dkv (K4)", ("flash_bwd_dkv_kernel",)),
          ("gemm", ("nvjet", "gemm", "xmma", "cutlass")))


def _group(name: str) -> str:
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the full profiler table")
    ap.add_argument("--eager", action="store_true",
                    help="profile the eager loop instead of TrainStep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.tools import eager_train, gpt_1b_train

    dev = torch.device("cuda", 0)
    if args.eager:
        run = eager_train.build(gpt_1b_train.config(), dev,
                                (gpt_1b_train.BATCH, gpt_1b_train.SEQ))

        def step(*_):
            return eager_train.step(run)
        x = y = None
    else:
        model, step, x, y = gpt_1b_train.build(dev)
    step(x, y)                       # warm-up: cuBLAS heuristics, allocator
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            t0 = time.perf_counter()
            step(x, y)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    kernels = [e for e in prof.key_averages() if _is_kernel(e)]
    busy_us = sum(_device_us(e) for e in kernels)
    groups = {}
    for e in kernels:
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + _device_us(e) / 1e3 / STEPS
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "steps": STEPS,
        "loop": "eager" if args.eager else "TrainStep",
        "wall_ms_per_step": walls,
        "kernels_per_step": sum(e.count for e in kernels) / STEPS,
        "device_busy_ms_per_step": busy_us / 1e3 / STEPS,
        "device_busy_share": busy_us / 1e3 / sum(walls),
        "device_ms_per_step_by_group": {k: round(v, 3)
                                        for k, v in sorted(groups.items())},
        "top_device_ms_per_step": [
            [e.key[:60], e.count // STEPS,
             round(_device_us(e) / 1e3 / STEPS, 4)] for e in top]}),
        flush=True)
    if args.out is not None:
        os.makedirs(args.out, exist_ok=True)
        name = "profile_train_eager.txt" if args.eager else \
            "profile_train.txt"
        with open(os.path.join(args.out, name), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                              row_limit=50))


if __name__ == "__main__":
    main()
