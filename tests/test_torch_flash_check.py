"""The bf16 flash check (``paddle_tpu_torch/testing/flash_check.py``) on
the CPU, with the plain versions standing in for the kernels: it passes
on the plain versions' own outputs and where one P or dS entry at a
bf16 rounding boundary is rounded the other way, and it fails on one
element off by 4 x atol and on a row whose sum is wrong."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.testing import flash_check as fc

BF16 = torch.bfloat16
ATOL = fc.TOL[BF16]["atol"]


def _outputs(q, k, v, do, scale, causal, round_to=BF16):
    """The plain versions' outputs, as a kernel would return them."""
    f = [x.float() for x in (q, k, v, do)]
    o, lse = fa._flash_fwd_ref(f[0], f[1], f[2], scale, causal,
                               round_to=round_to)
    dq, dk, dv = fa._flash_bwd_ref(f[0], f[1], f[2], o, lse, f[3], scale,
                                   causal, round_to=round_to)
    return {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def _random(seed, b=1, s=96, h=2, d=32, dtype=BF16):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).to(dtype) for _ in range(4)]


def _tie_inputs():
    """S = 2, causal, scale 1: row 1 sees keys 0 and 1, and
    P[1, 0] = 1 / (1 + exp(S[1, 1])) is placed on the bf16 rounding
    midpoint 0.375 + 2^-10 (S[1, 1] built from three bf16 parts, so the
    f32 P lies within a few f32 ulps of it). dO[0] = -bf16(P[1, 0]) dO[1]
    makes dV[0] = 0, so the other rounding of P[1, 0] moves dV[0] by
    2^-9 * 4, over atol."""
    mid = 0.375 + 2.0 ** -10
    target = float(np.log(1.0 / mid - 1.0))
    parts, rest = [], target
    for sh in (0, 8, 16):
        x = float(torch.tensor(rest * 2.0 ** sh).to(BF16))
        parts.append(x)
        rest -= x * 2.0 ** -sh
    d = 16
    q = torch.zeros(1, 2, 1, d)
    k = torch.zeros(1, 2, 1, d)
    q[0, 1, 0, :3] = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -16])
    k[0, 1, 0, :3] = torch.tensor(parts)
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 2, 1, d)).astype(np.float32))
    do = torch.zeros(1, 2, 1, d)
    do[0, 1, 0] = 4.0
    q, k, v, do = (x.to(BF16) for x in (q, k, v, do))
    got = _outputs(q, k, v, do, 1.0, True)
    p10 = float(torch.exp(-got["lse"][0, 1]))
    assert abs(p10 - mid) < 2.0 ** -20
    do[0, 0, 0] = -float(torch.tensor(p10).to(BF16)) * 4.0
    return q, k, v, do, p10


def test_plain_outputs_pass():
    q, k, v, do = _random(0)
    got = _outputs(q, k, v, do, 32 ** -0.5, True)
    rep = fc.check(q, k, v, do, got, 32 ** -0.5, True)
    assert all(n == 0 for n in rep["outside_plain_tol"].values())
    # an allowance grows by more than atol / 10 at a few elements only
    for name, n in rep["elements_loosened"].items():
        assert n < 0.1 * rep["elements"][name], (name, rep)


def test_p_entry_at_a_tie_rounded_the_other_way_passes():
    q, k, v, do, p10 = _tie_inputs()
    got = _outputs(q, k, v, do, 1.0, True)
    here = float(torch.tensor(p10).to(BF16))
    other = here + 2.0 ** -9 if here < p10 else here - 2.0 ** -9
    # the kernel rounding P[1, 0] up where the plain version rounds down
    # (or the reverse): dV[0] += (other - here) * dO[1]
    got["dv"] = got["dv"].clone()
    got["dv"][0, 0, 0] += (other - here) * do[0, 1, 0].float()
    err = float((got["dv"][0, 0, 0]).abs().max())
    assert err > ATOL                # an element-wise check would fail
    rep = fc.check(q, k, v, do, got, 1.0, True)
    assert rep["outside_plain_tol"]["dv"] > 0
    assert rep["near_boundary"]["p_bwd"] >= 1
    assert rep["max_extra"]["dv"] >= err


def test_ds_entry_near_a_boundary_rounded_the_other_way_passes():
    scale = 32 ** -0.5
    for seed in range(20):
        q, k, v, do = _random(seed, s=64)
        got = _outputs(q, k, v, do, scale, True)
        b = fc.backward_flips(q, k, v, do, got["o"], got["lse"], scale, True)
        if not bool((b["flip_ds"] > 0).any()):
            continue
        # the near-boundary dS entry whose flip moves dK the most: the
        # kernel rounds it the other way
        qh = fc._heads(q)
        effect = b["flip_ds"] * qh.abs().sum(-1)[:, :, None]
        hh, i, j = np.unravel_index(int(effect.argmax()), effect.shape)
        step = float(b["ds_other"][hh, i, j]
                     - b["ds"][hh, i, j].to(BF16).float())
        assert step != 0.0
        got["dk"] = got["dk"].clone()
        got["dk"][0, j, hh] += scale * step * qh[hh, i]
        rep = fc.check(q, k, v, do, got, scale, True)
        assert rep["near_boundary"]["ds"] >= 1
        return
    pytest.fail("no dS entry near a bf16 boundary in 20 draws")


def test_one_element_off_by_4_atol_fails():
    q, k, v, do = _random(1)
    got = _outputs(q, k, v, do, 32 ** -0.5, True)
    for name in ("o", "dq", "dk", "dv"):
        bad = dict(got)
        bad[name] = got[name].clone()
        bad[name][0, 50, 1, 7] += 4 * ATOL * (1 + 0.01 * float(
            got[name][0, 50, 1, 7].abs()) / ATOL)
        with pytest.raises(AssertionError, match=name):
            fc.check(q, k, v, do, bad, 32 ** -0.5, True)


def test_a_row_with_a_wrong_sum_fails():
    q, k, v, do = _random(2)
    got = _outputs(q, k, v, do, 32 ** -0.5, True)
    bad = dict(got, o=got["o"].clone())
    bad["o"][0, 40] *= 1.03          # l off by 3% in one row
    with pytest.raises(AssertionError, match="'o'"):
        fc.check(q, k, v, do, bad, 32 ** -0.5, True)
    bad = dict(got, dv=got["dv"].clone())
    bad["dv"][0, 10] *= 1.03
    with pytest.raises(AssertionError, match="'dv'"):
        fc.check(q, k, v, do, bad, 32 ** -0.5, True)


def test_float32_is_held_element_wise():
    q, k, v, do = _random(3, dtype=torch.float32)
    got = _outputs(q, k, v, do, 32 ** -0.5, True, round_to=None)
    rep = fc.check(q, k, v, do, got, 32 ** -0.5, True)
    assert rep["max_extra"] == {n: 0.0 for n in ("o", "dq", "dk", "dv")}
    bad = dict(got, dq=got["dq"].clone())
    bad["dq"][0, 5, 0, 0] += 1e-3
    with pytest.raises(AssertionError, match="dq"):
        fc.check(q, k, v, do, bad, 32 ** -0.5, True)
