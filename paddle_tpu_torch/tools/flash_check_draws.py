"""Hold the bf16 flash kernels (forward, dQ, dK/dV) against their plain
versions over several random draws at one shape, with the check and
tolerance of ``chip_smoke.py``'s flash phase (the plain versions round P
and dS to bf16 where the kernels do: ``round_to``), and report how often
an element falls outside that tolerance.

    python -m paddle_tpu_torch.tools.flash_check_draws \\
        --shape 8 2048 32 64 --draws 8 --seed 2

Prints one JSON line per draw (each tensor's largest error and the
elements out of tolerance) and one summary line. At each element out of
tolerance it also gives the plain version without the bf16 rounding of
P and dS: where the kernel lies nearer to that one, its difference is a
rounding decision taken the other way (an f32 P or dS within an ulp of a
bf16 rounding midpoint), not a wrong sum. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from paddle_tpu_torch.ops import flash_attention as fa

__all__ = ["TOL", "draw"]

TOL = dict(rtol=1e-2, atol=2e-3)   # chip_smoke.py's bf16 FLASH_TOL
MAX_LISTED = 8                     # elements listed per tensor and draw


def _outside(got, want):
    """Indices where ``got`` is outside TOL of ``want`` (f32)."""
    bad = (got - want).abs() > TOL["atol"] + TOL["rtol"] * want.abs()
    return bad.nonzero()


def draw(gen, b, s, h, d, causal=True):
    """One draw of (q, k, v, dO) at (b, s, h, d) in bf16 from ``gen``:
    per tensor (o, dq, dk, dv) its largest error against the round_to
    plain version, the count of elements out of TOL, and the first few
    of them with the unrounded plain value beside."""
    dev = gen.device

    def randn():
        return torch.randn((b, s, h, d), generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    q, k, v, do = randn(), randn(), randn(), randn()
    scale = d ** -0.5
    o, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    delta = fa._delta(o, do)
    got = {"o": o,
           "dq": fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale,
                                       causal)}
    got["dk"], got["dv"] = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                  scale, causal)
    f = [x.float() for x in (q, k, v, do)]
    out = {}
    for rounded in (torch.bfloat16, None):
        want = {"o": fa._flash_fwd_ref(f[0], f[1], f[2], scale, causal,
                                       round_to=rounded)[0]}
        want["dq"], want["dk"], want["dv"] = fa._flash_bwd_ref(
            f[0], f[1], f[2], o.float(), lse, f[3], scale, causal,
            round_to=rounded)
        for name, w in want.items():
            g, w = got[name].float(), w.float()
            if rounded is not None:
                bad = _outside(g, w)
                listed = [tuple(i) for i in bad[:MAX_LISTED].tolist()]
                out[name] = {"max_abs_err": float((g - w).abs().max()),
                             "outside": int(bad.shape[0]),
                             "elements": [{"index": list(i),
                                           "got": float(g[i]),
                                           "want": float(w[i])}
                                          for i in listed]}
            else:
                for e in out[name]["elements"]:
                    e["want_unrounded"] = float(w[tuple(e["index"])])
        del want
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=4, default=[8, 2048, 32, 64],
                    metavar=("B", "S", "H", "D"))
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_check_draws: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    total = {}
    for i in range(args.draws):
        res = draw(gen, *args.shape)
        print(json.dumps({"draw": i, **res}), flush=True)
        for name, r in res.items():
            t = total.setdefault(name, {"outside": 0, "draws_outside": 0,
                                        "max_abs_err": 0.0})
            t["outside"] += r["outside"]
            t["draws_outside"] += int(r["outside"] > 0)
            t["max_abs_err"] = max(t["max_abs_err"], r["max_abs_err"])
    print(json.dumps({"shape": args.shape, "draws": args.draws,
                      "seed": args.seed, "tolerance": TOL,
                      "elements_per_tensor": math.prod(args.shape),
                      "by_tensor": total}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
