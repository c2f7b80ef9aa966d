"""Where a training step's time goes on the card.

    python -m paddle_tpu_torch.tools.profile_train [--eager | --run-steps]
        [--out DIR]

Trains the configuration of ``chip_smoke.py`` phase ``train``
(:mod:`paddle_tpu_torch.tools.gpt_1b_train`: the 0.95B Llama at full
width and depth, bf16, batch 4 x 2048, AdamW) for one warm-up step, then
profiles 2 steps with ``torch.profiler``; with ``--eager``, phase
``eager_train``'s loop over the same model (``tools/eager_train.py``:
AdamW with f32 master weights, the clip, a scheduler and a scaler); with
``--run-steps``, one ``TrainStep.run_steps(4)`` dispatch (4 replays of
the step's CUDA graph, captured in the warm-up dispatch) on the same
batch. It prints one JSON line: host wall time per step, device kernels
per step, device busy time (the sum of device event times; this path
runs one stream), its share of the wall time, device time per step by
phase (compute, collective, copy: :func:`paddle_tpu_torch.profiler.
classify_phase`, the classifier of ``device_phases``), and the top
kernels. The profiler's own host overhead lengthens the wall time;
``chip_smoke.py`` gives the unprofiled step times. With ``--out DIR``
the full profiler table goes to ``DIR/profile_train*.txt``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from paddle_tpu_torch.profiler import classify_phase
from paddle_tpu_torch.tools.profile_serve import _device_us, _is_kernel

STEPS = 2
RUN_STEPS = 4      # steps of the one profiled run_steps dispatch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the full profiler table")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--eager", action="store_true",
                      help="profile the eager loop instead of TrainStep")
    mode.add_argument("--run-steps", action="store_true",
                      help="profile one TrainStep.run_steps(4) dispatch")
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
        model, train_step, x, y = gpt_1b_train.build(dev)
        step = train_step
        if args.run_steps:
            def step(x, y):
                return train_step.run_steps(RUN_STEPS, x, y)
    step(x, y)        # warm-up: cuBLAS heuristics, allocator, the capture
    torch.cuda.synchronize()
    dispatch_ms = []
    dispatches = 1 if args.run_steps else STEPS
    steps = RUN_STEPS if args.run_steps else STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(dispatches):
            t0 = time.perf_counter()
            step(x, y)
            torch.cuda.synchronize()
            dispatch_ms.append((time.perf_counter() - t0) * 1e3)
    kernels = [e for e in prof.key_averages() if _is_kernel(e)]
    busy_us = sum(_device_us(e) for e in kernels)
    phases = {}
    for e in kernels:
        ph = classify_phase(e.key)
        phases[ph] = phases.get(ph, 0.0) + _device_us(e) / 1e3 / steps
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "steps": steps,
        "loop": ("eager" if args.eager else "TrainStep.run_steps"
                 if args.run_steps else "TrainStep"),
        "wall_ms_per_step": [ms * dispatches / steps for ms in dispatch_ms],
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": busy_us / 1e3 / sum(dispatch_ms),
        "device_ms_per_step_by_phase": {k: round(v, 3)
                                        for k, v in sorted(phases.items())},
        "top_device_ms_per_step": [
            [e.key[:60], e.count // steps,
             round(_device_us(e) / 1e3 / steps, 4)] for e in top]}),
        flush=True)
    if args.out is not None:
        os.makedirs(args.out, exist_ok=True)
        name = ("profile_train_eager.txt" if args.eager else
                "profile_train_run_steps.txt" if args.run_steps else
                "profile_train.txt")
        with open(os.path.join(args.out, name), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                              row_limit=50))


if __name__ == "__main__":
    main()
