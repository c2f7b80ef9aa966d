"""Hold the flash attention kernels' outputs (O, lse, dQ, dK, dV) against
their plain versions, in a way that stays exact where a bf16 kernel
rounds one P or dS entry the other way from the plain version.

    report = check(q, k, v, do, got, scale, causal)

``got`` holds the kernels' ``o``, ``lse``, ``dq``, ``dk`` and ``dv`` for
the inputs ``q, k, v, do`` ([B, S, H, D]); the function raises
``AssertionError`` naming the first elements out of bounds and else
returns a report. ``chip_smoke.py`` (phase ``flash``),
``tests/test_torch_card.py`` and ``tools/flash_check_draws.py`` call it.

Float32 inputs are held element-wise against the plain versions at
``TOL[float32]``. In bf16 the kernels round P (for P V and P^T dO) and
dS (for dS K and dS^T Q) to bf16, and so do the plain versions
(``round_to``). Both compute those entries in f32, but not in the same
way, so an f32 entry lying near a bf16 rounding boundary can round up on
one side and down on the other. Every output element is then allowed

    atol + rtol * |ref| + sum over the near-boundary entries e feeding it
                          of flip(e) * |multiplier(e)|

where ``flip(e)`` is the distance between the bf16 values of ``e - d``
and ``e + d`` (one bf16 ulp where a boundary lies inside, else 0), ``d``
is the bound below, and the multipliers are V for O (with the online
softmax's rescaling and 1/l), dO for dV, K for dQ (times the scale; a P
flip reaches dQ only through dS: its multiplier carries |dP - delta|)
and Q for dK (times the scale). Away from a boundary the check is the
element-wise one at ``TOL[bfloat16]``.

The bound ``d``. The check knows the plain version's P and dS exactly:
it computes them with the plain version's own operations. It computes
the true values too, in f64 (the products of bf16 inputs are exact, and
an f64 sum of D of them is exact to 2^-50 relative). The kernel's f32
value lies within ``d`` of the true one, and the flip of an entry is
the largest distance between the bf16 rounding of a value in
[true - d, true + d] and the plain version's rounding (0 where the
whole interval rounds as the plain version did). ``d``, with
u = 2^-24 the f32 unit roundoff:

* S = scale * q . k: the kernels take it from ``wgmma``, whose bf16
  products are exact and whose f32 accumulator takes the D products in
  chunks of 16 (K per instruction): each chunk's sum and its addition
  to the accumulator round (or truncate) at most once each, under 2u of
  the magnitudes so far, so ``e_S = scale (ceil(D / 16) + 1) 2u
  (|q| . |k|)``.
* P = exp(S - m): the kernels take ``exp2f(fma(s, scale log2 e,
  -m log2 e))``. The argument carries e_S, the error of the subtracted
  running maximum (forward: at most the row's largest e_S; backward:
  none, both sides take the kernel's own lse), and its own roundings,
  under 4u (|S| + |m|) in natural-log units; exp2f errs by under 2^-21
  relative. An absolute error x in the exponent is a relative error x
  in P: ``d_P / P = e_S + e_m + 4u (|S| + |m|) + 2^-20`` (2^-20: twice
  the exp2f bound).
* dS = P (dP - delta): dP = dO . V from ``wgmma`` as S is, ``e_dP =
  (ceil(D / 16) + 1) 2u (|dO| . |V|)``; delta is an input of both sides
  (``_delta``). So ``d_dS = P (d_P/P |dP - delta| + e_dP (1 + d_P/P))
  + 2u P (|dP| + |delta|) + 2u |dS|`` (the subtraction and the
  product).

The kernels compute dS from the f32 P (``csrc/flash_attention.cu``,
``flash_bwd_dq_kernel_tc``): a P rounding reaches dV only, a dS rounding
dQ and dK. The report gives, per tensor, the largest error, the largest
extra allowance and that allowance over atol, the count of
near-boundary P and dS entries, and the elements whose allowance grew by
more than a tenth of atol (``elements_loosened``) out of all. ``loose``
is set when an extra allowance reaches half of atol, so a reader sees
at once where the check allows more than the element-wise tolerance.
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.ops import flash_attention as fa

__all__ = ["TOL", "LSE_TOL", "check"]

# In f32 the FMA kernels compute from the same inputs as the f32 plain
# version (only the summation order differs; TF32 off). In bf16 every
# kernel rounds its output to bf16 once (half a relative step of 2^-8,
# which rtol covers) and atol stays under the outputs' typical size
# (~0.1-1). The tensor-core forward and dK/dV also round P and dS to bf16
# before their P V-type products, as the TPU kernels do, and so do the
# plain versions they are held against (``round_to``: the forward's
# online softmax over KEY_BLOCK keys, dS for dQ, P and dS for dK and dV);
# without it that rounding alone exceeds this atol near zero (2.4e-3 in O
# on an H100, about 5e-3 in dK and dV as estimated on the CPU from the
# same inputs).
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1e-2, atol=2e-3)}
LSE_TOL = dict(rtol=1e-5, atol=1e-4)
U = 2.0 ** -24
EXP_REL = 2.0 ** -20
CHUNK = 16           # wgmma's K per bf16 instruction
LOOSE_SHARE = 0.5
LOOSENED = 0.1       # an extra allowance over 0.1 atol counts
MAX_LISTED = 8


def _heads(x):
    """[1, S, H, D] -> [H, S, D] in f32."""
    return x[0].float().transpose(0, 1)


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _flip(true, d, plain):
    """The most a bf16 rounding of a value within ``d`` of ``true`` can
    differ from the bf16 rounding of ``plain`` (in f32)."""
    r = _bf16(plain.double())
    return torch.maximum((_bf16(true - d) - r).abs(),
                         (_bf16(true + d) - r).abs()).float()


def _sum_err(a, b):
    """The bound on the kernels' f32 dot products of a's and b's rows
    (chunked wgmma accumulation), as a matrix."""
    n = a.shape[-1]
    return (math.ceil(n / CHUNK) + 1) * 2 * U * torch.matmul(
        a.abs(), b.abs().transpose(-1, -2))


def _visible(sq, sk, causal, device):
    vis = fa._visible(sq, sk, causal, device)
    return torch.ones((sq, sk), dtype=torch.bool, device=device) \
        if vis is None else vis


def _true_scores(q, k, scale, vis):
    """S in f64 ([H, Sq, Sk], -inf where masked)."""
    s = torch.matmul(q[0].double().transpose(0, 1),
                     k[0].double().transpose(0, 1).transpose(-1, -2)) * scale
    return s.masked_fill(~vis, float("-inf"))


def forward_flips(q, k, scale, causal):
    """The forward's near-boundary P entries for one batch element
    (inputs [1, S, H, D]): the flips ([H, Sq, Sk]) and each entry's
    weight in O (the online softmax's rescaling exp(m_blk - m) over l)."""
    sq, sk = q.shape[1], k.shape[1]
    vis = _visible(sq, sk, causal, q.device)
    # the plain version's P, block by block, as _flash_fwd_ref takes it
    s = fa._scores(q.float(), k.float(), scale).masked_fill(~vis,
                                                          float("-inf"))[0]
    m = torch.full(s.shape[:-1], float("-inf"), device=s.device)
    plain, bases = [], []
    for k0 in range(0, sk, fa.KEY_BLOCK):
        sb = s[..., k0:k0 + fa.KEY_BLOCK]
        m_new = torch.maximum(m, sb.amax(-1))
        base = torch.where(torch.isfinite(m_new), m_new, 0.0)
        plain.append(torch.exp(sb - base[..., None]))
        bases.append(base[..., None].expand_as(sb))
        m = m_new
    plain = torch.cat(plain, -1)
    base = torch.cat(bases, -1).double()
    del bases
    # the true values, and the kernel's distance from them
    s64 = _true_scores(q, k, scale, vis)
    e_s = torch.where(vis, scale * _sum_err(_heads(q), _heads(k)), 0.0)
    e_m = e_s.amax(-1, keepdim=True)   # bounds the running max's error
    p64 = torch.where(vis, torch.exp(s64 - base), 0.0)
    rel = (e_s + e_m).double() + 4 * U * (
        torch.where(vis, s64, 0.0).abs() + base.abs()) + EXP_REL
    flip = torch.where(vis, _flip(p64, p64 * rel, plain), 0.0)
    del plain, rel, e_s, e_m
    m_fin = torch.where(vis, s64, float("-inf")).amax(-1, keepdim=True)
    mf = torch.where(torch.isfinite(m_fin), m_fin, 0.0)
    l = torch.where(vis, torch.exp(s64 - mf), 0.0).sum(-1, keepdim=True)
    w = torch.where(vis & (l > 0),
                    torch.exp(base - mf) / torch.where(l > 0, l, 1.0), 0.0)
    return flip, w.float()


def backward_flips(q, k, v, do, o, lse, scale, causal):
    """The backward's near-boundary entries for one batch element
    (inputs [1, S, H, D], the kernel's ``o`` and ``lse`` [H, Sq]): a dict
    of [H, Sq, Sk] tensors: ``flip_p``, ``flip_ds``, the plain version's
    ``ds``, and ``ds_other``, the rounding of dS farthest from the plain
    version's within the bound."""
    sq, sk = q.shape[1], k.shape[1]
    vis = _visible(sq, sk, causal, q.device)
    f = [x.float() for x in (q, k, v, do)]
    # the plain version's P and dS, as _flash_bwd_ref takes them
    p = fa._probs(f[0], f[1], lse, scale, causal)
    dof = f[3].transpose(1, 2)
    dp = torch.matmul(dof, f[2].transpose(1, 2).transpose(-1, -2))
    delta = fa._delta(o.float(), f[3]).reshape(1, -1, sq, 1)
    ds = (p * (dp - delta))[0]
    p, dp, delta = p[0], dp[0], delta[0].double()
    # the true values, and the kernel's distance from them
    lse64 = lse.reshape(-1, sq, 1).double()
    lf = torch.where(torch.isfinite(lse64), lse64, 0.0)
    s64 = _true_scores(q, k, scale, vis)
    p64 = torch.where(vis, torch.exp(s64 - lf), 0.0)
    rel = torch.where(vis, scale * _sum_err(_heads(q), _heads(k)),
                      0.0).double() + 4 * U * (
        torch.where(vis, s64, 0.0).abs() + lf.abs()) + EXP_REL
    del s64
    flip_p = torch.where(vis, _flip(p64, p64 * rel, p), 0.0)
    dp64 = torch.matmul(_heads(do).double(),
                        _heads(v).double().transpose(-1, -2))
    e_dp = _sum_err(_heads(do), _heads(v)).double()
    diff = dp64 - delta
    ds64 = p64 * diff
    d_ds = (p64 * (rel * diff.abs() + e_dp * (1 + rel))
            + 2 * U * p64 * (dp64.abs() + delta.abs())
            + 2 * U * ds64.abs())
    del dp64, e_dp, diff, rel
    flip_ds = torch.where(vis, _flip(ds64, d_ds, ds), 0.0)
    r = _bf16(ds.double())
    lo, hi = _bf16(ds64 - d_ds), _bf16(ds64 + d_ds)
    other = torch.where((lo - r).abs() >= (hi - r).abs(), lo, hi).float()
    return {"flip_p": flip_p, "flip_ds": flip_ds, "ds": ds,
            "ds_other": torch.where(vis, other, ds)}


def allowances(q, k, v, do, o, lse, scale, causal):
    """Extra allowances for one batch element (inputs [1, S, H, D]; the
    kernel's own ``o`` and ``lse`` [H, Sq]): a dict of [H, S, D] tensors
    for ``o``, ``dq``, ``dk`` and ``dv``, and the counts of near-boundary
    P entries (forward and backward) and dS entries."""
    qh, kh, vh, doh = (_heads(x) for x in (q, k, v, do))
    flip, w = forward_flips(q, k, scale, causal)
    out = {"o": torch.matmul(flip * w, vh.abs())}
    counts = {"p_fwd": int((flip > 0).sum())}
    del flip, w
    b = backward_flips(q, k, v, do, o, lse, scale, causal)
    out["dv"] = torch.matmul(b["flip_p"].transpose(-1, -2), doh.abs())
    out["dk"] = scale * torch.matmul(b["flip_ds"].transpose(-1, -2),
                                     qh.abs())
    out["dq"] = scale * torch.matmul(b["flip_ds"], kh.abs())
    counts["p_bwd"] = int((b["flip_p"] > 0).sum())
    counts["ds"] = int((b["flip_ds"] > 0).sum())
    return out, counts


def _refs(q, k, v, do, o, lse, scale, causal, round_to):
    f = [x.float() for x in (q, k, v, do)]
    o_ref, lse_ref = fa._flash_fwd_ref(f[0], f[1], f[2], scale, causal,
                                       round_to=round_to)
    # the backward's reference takes the kernel's own O and lse
    dq, dk, dv = fa._flash_bwd_ref(f[0], f[1], f[2], o.float(), lse, f[3],
                                   scale, causal, round_to=round_to)
    return {"o": o_ref, "dq": dq, "dk": dk, "dv": dv}, lse_ref


def check(q, k, v, do, got, scale, causal) -> dict:
    """Hold ``got`` (the kernels' ``o``, ``lse``, ``dq``, ``dk``, ``dv``
    for ``q, k, v, do`` [B, S, H, D]) against the plain versions; raise
    ``AssertionError`` on any element out of bounds, else return the
    report. Works one batch element at a time to bound the memory of
    its [H, Sq, Sk] matrices."""
    dtype = q.dtype
    tol = TOL[dtype]
    bf16 = dtype == torch.bfloat16
    b, sq, h, _ = q.shape
    names = ("o", "dq", "dk", "dv")
    rep = {"dtype": str(dtype).split(".")[-1], "tolerance": dict(tol),
           "max_abs_err": {n: 0.0 for n in names},
           "max_extra": {n: 0.0 for n in names},
           "outside_plain_tol": {n: 0 for n in names},
           "elements_loosened": {n: 0 for n in names},
           "elements": {n: got[n].numel() for n in names},
           "near_boundary": {"p_fwd": 0, "p_bwd": 0, "ds": 0}}
    bad = []
    lse_all = got["lse"].view(b, h, sq)
    for i in range(b):
        sl = slice(i, i + 1)
        xs = [x[sl] for x in (q, k, v, do)]
        o_i, lse_i = got["o"][sl], lse_all[i]
        refs, lse_ref = _refs(*xs, o_i, lse_i, scale, causal,
                              torch.bfloat16 if bf16 else None)
        torch.testing.assert_close(lse_i, lse_ref.view(h, sq), **LSE_TOL)
        extra = (allowances(*xs, o_i, lse_i, scale, causal)
                 if bf16 else (None, None))
        if bf16:
            for key, n in extra[1].items():
                rep["near_boundary"][key] += n
        for n in names:
            g = _heads(got[n][sl])
            want = _heads(refs[n])
            err = (g - want).abs()
            plain = tol["atol"] + tol["rtol"] * want.abs()
            allowed = plain if not bf16 else plain + extra[0][n]
            rep["max_abs_err"][n] = max(rep["max_abs_err"][n],
                                        float(err.max()) if err.numel()
                                        else 0.0)
            rep["outside_plain_tol"][n] += int((err > plain).sum())
            if bf16 and extra[0][n].numel():
                rep["max_extra"][n] = max(rep["max_extra"][n],
                                          float(extra[0][n].max()))
                rep["elements_loosened"][n] += int(
                    (extra[0][n] > LOOSENED * tol["atol"]).sum())
            out = (err > allowed) | ~torch.isfinite(g)
            for idx in out.nonzero()[:MAX_LISTED].tolist():
                hh, ss, dd = idx
                bad.append({"tensor": n, "index": [i, ss, hh, dd],
                            "got": float(g[hh, ss, dd]),
                            "want": float(want[hh, ss, dd]),
                            "allowed": float(allowed[hh, ss, dd])})
        del refs, extra
    worst = max(rep["max_extra"].values())
    rep["extra_over_atol"] = worst / tol["atol"]
    rep["loose"] = rep["extra_over_atol"] >= LOOSE_SHARE
    if bad:
        raise AssertionError(
            f"flash check: elements out of bounds (first {len(bad)}): "
            f"{bad[:MAX_LISTED]}; report {rep}")
    if not math.isfinite(worst):
        raise AssertionError(f"flash check: allowance not finite: {rep}")
    return rep
