"""Where a serving step's time goes on the card.

    python -m paddle_tpu_torch.tools.profile_serve [--spec | --bucketed]
        [--out DIR]

Serves the configuration of ``chip_smoke.py`` phase 4
(:mod:`paddle_tpu_torch.tools.llama3_8b_serve`: Llama-3-8B at full width
and depth, 8 requests, 32 new tokens each), or with ``--spec`` that of
phase 9 (:mod:`paddle_tpu_torch.tools.llama3_8b_spec_serve`: the same
with a Llama-3.2-1B-width draft proposing 4 tokens per decode row, whose
proposals fall inside each decode step), or with ``--bucketed`` phase
4's model and workload through the bucketed path (``ragged=False``,
``chip_smoke.py`` phase 13; warmed up by serving the workload once, so
every ``(kind, B, S)`` key is captured), and profiles two windows with
``torch.profiler``: the first step (a prefill: 2048 tokens, or 2 x 1024
padded on the bucketed path) and 4 steps once every request decodes.
Each step replays the CUDA graph of its bucket (the warm-up captured the
buckets these windows take), and the draft's proposals replay theirs. For each window it prints one JSON
line: host wall time per step, device kernels run per step (those inside
graph replays included, as the profiler reports them), graph launches
per step, device busy time (the sum of kernel times; overlapping kernels
would be counted twice, and this path runs one stream), the busy share
of the wall time, the top kernels by device time, and the window's
captures and replays per bucket. The profiler's
own host overhead lengthens the wall time; ``chip_smoke.py`` gives the
unprofiled step times. With ``--out DIR`` the full profiler tables go to
``DIR/profile_serve.txt``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

DECODE_STEPS = 4


def _is_kernel(evt) -> bool:
    """A device-side event (kernel, memcpy, memset), not a host operator
    whose device time merely repeats its kernels'."""
    from torch.autograd import DeviceType

    return evt.device_type == DeviceType.CUDA


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _window(eng, n_steps, label, out_dir):
    from torch.profiler import ProfilerActivity, profile

    graphs = {"step": eng._graphs}
    if eng._spec is not None:
        graphs["draft"] = eng._spec.graphs
    snaps = {name: g.snapshot() for name, g in graphs.items()}
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    avgs = prof.key_averages()
    kernels = [e for e in avgs if _is_kernel(e)]
    graph_launches = sum(e.count for e in avgs
                         if not _is_kernel(e) and e.key == "cudaGraphLaunch")
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    wall_ms = sum(walls)
    res = {"window": label, "steps": n_steps, "wall_ms_per_step": walls,
           "kernels_per_step": sum(e.count for e in kernels) / n_steps,
           "graph_launches_per_step": graph_launches / n_steps,
           "device_busy_ms_per_step": busy_us / 1e3 / n_steps,
           "device_busy_share": busy_us / 1e3 / wall_ms,
           "top_device_ms_per_step": [
               [e.key[:60], e.count // n_steps,
                round(_device_us(e) / 1e3 / n_steps, 4)] for e in top],
           "graphs": {name: {k: v for k, v in g.since(snaps[name]).items()
                             if k in ("capture_s", "replays")}
                      for name, g in graphs.items()}}
    print(json.dumps(res), flush=True)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "profile_serve.txt"), "a") as f:
            f.write(f"== {label} ({n_steps} steps, {wall_ms:.3f} ms "
                    f"wall)\n")
            f.write(avgs.table(sort_by="self_cuda_time_total",
                               row_limit=40))
            f.write("\n")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for the full profiler tables")
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--spec", action="store_true",
                      help="profile the speculative configuration")
    kind.add_argument("--bucketed", action="store_true",
                      help="profile the bucketed path (ragged=False)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: no CUDA device")

    from paddle_tpu_torch.serving import EngineConfig, LLMEngine
    from paddle_tpu_torch.tools import llama3_8b_serve, llama3_8b_spec_serve

    dev = torch.device("cuda", 0)
    if args.bucketed:
        eng = LLMEngine(llama3_8b_serve.target_model(dev),
                        EngineConfig(**llama3_8b_serve.ENGINE,
                                     ragged=False))
        rids, _ = llama3_8b_serve.add_requests(eng)   # the warm-up
        eng.run()
        for rid in rids:
            eng.release_request(rid)
        eng.reset_metrics()
    else:
        cfg = llama3_8b_spec_serve if args.spec else llama3_8b_serve
        eng = cfg.build_engine(dev)
    _, lens = llama3_8b_serve.add_requests(eng)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "spec": args.spec, "bucketed": args.bucketed,
                      "prompt_lens": [int(x) for x in lens]}), flush=True)
    _window(eng, 1, "prefill", args.out)
    while any(r.num_generated == 0 for r in eng.scheduler.running) \
            or eng.scheduler.waiting:
        eng.step()
    _window(eng, DECODE_STEPS, "decode", args.out)
    eng.run()


if __name__ == "__main__":
    main()
