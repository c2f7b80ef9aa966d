"""Hold the bf16 flash kernels (forward, dQ, dK/dV) against their plain
versions over several random draws at one shape, with the check of
``chip_smoke.py``'s flash phase (:func:`paddle_tpu_torch.testing.
flash_check.check`: ``TOL[bfloat16]`` element-wise, plus an allowance
for the P and dS entries that lie near a bf16 rounding boundary), and
report each draw.

    python -m paddle_tpu_torch.tools.flash_check_draws \\
        --shape 8 2048 32 64 --draws 16 --seed 2

Prints one JSON line per draw (the check's report, or the elements out
of bounds) and one summary line; exits 1 if any draw failed. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.testing import flash_check

__all__ = ["draw", "run"]


def draw(gen, b, s, h, d, causal=True) -> dict:
    """One draw of (q, k, v, dO) at (b, s, h, d) in bf16 from ``gen``
    through the three kernels and the check. Returns the check's report
    with ``"passed"``; a failure's message is under ``"failure"``."""
    dev = gen.device

    def randn():
        return torch.randn((b, s, h, d), generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    q, k, v, do = randn(), randn(), randn(), randn()
    scale = d ** -0.5
    o, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    delta = fa._delta(o, do)
    got = {"o": o, "lse": lse,
           "dq": fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale,
                                       causal)}
    got["dk"], got["dv"] = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                  scale, causal)
    try:
        rep = flash_check.check(q, k, v, do, got, scale, causal)
        rep["passed"] = True
    except AssertionError as e:
        rep = {"passed": False, "failure": str(e)[:2000]}
    torch.cuda.empty_cache()
    return rep


def run(shape, draws, seed=2) -> dict:
    """``draws`` draws at ``shape`` (B, S, H, D) from a generator seeded
    with ``seed``; the per-draw reports and a summary."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    reports = [draw(gen, *shape) for _ in range(draws)]
    ok = [r for r in reports if r["passed"]]
    summary = {"shape": list(shape), "draws": draws, "seed": seed,
               "tolerance": {k: v for k, v in
                             flash_check.TOL[torch.bfloat16].items()},
               "passed": len(ok), "elements_per_tensor": math.prod(shape)}
    if ok:
        summary["max_abs_err"] = {
            n: max(r["max_abs_err"][n] for r in ok)
            for n in ok[0]["max_abs_err"]}
        summary["outside_plain_tol"] = {
            n: sum(r["outside_plain_tol"][n] for r in ok)
            for n in ok[0]["outside_plain_tol"]}
        summary["draws_outside_plain_tol"] = sum(
            any(v > 0 for v in r["outside_plain_tol"].values()) for r in ok)
        summary["max_extra_over_atol"] = max(r["extra_over_atol"]
                                             for r in ok)
        summary["elements_loosened"] = {
            n: sum(r["elements_loosened"][n] for r in ok) / len(ok)
            for n in ok[0]["elements_loosened"]}
    return {"reports": reports, "summary": summary}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=4, default=[8, 2048, 32, 64],
                    metavar=("B", "S", "H", "D"))
    ap.add_argument("--draws", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_check_draws: needs a CUDA device")
    res = run(args.shape, args.draws, args.seed)
    for i, r in enumerate(res["reports"]):
        print(json.dumps({"draw": i, **r}), flush=True)
    print(json.dumps(res["summary"]), flush=True)
    return 0 if res["summary"]["passed"] == args.draws else 1


if __name__ == "__main__":
    sys.exit(main())
