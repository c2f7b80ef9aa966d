"""Ring attention: the port's ``ring_attention_data`` and the
``ring_attention`` op against the JAX package's.

The JAX ring runs in this process inside ``shard_map`` on conftest's
virtual CPU devices; the port's ranks are one gloo world of 4 processes
(``paddle_tpu_torch.testing.cp_ranks``), each passing the global view and
getting the global output back. Same seeded inputs on both sides; the
gradients are those of ``sum(out * cotangent)``. Bounds: rtol / atol
1e-5 in f32 (output and gradients)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from paddle_tpu.distributed.mesh import ProcessMesh
from paddle_tpu.ops import ring_attention as ra

RTOL = ATOL = 1e-5


def _case(name, shape, causal, mesh=(4,), dims=("sp",), batch_axis=None,
          seed=0):
    return dict(name=name, shape=shape, causal=causal, mesh=list(mesh),
                dims=list(dims), batch_axis=batch_axis, seed=seed)


CASES = [
    _case("causal", (2, 32, 4, 4, 16), True),
    _case("full", (2, 32, 4, 4, 16), False, seed=1),
    _case("gqa_causal", (1, 32, 8, 2, 16), True, seed=2),
    _case("gqa_full", (1, 32, 8, 2, 16), False, seed=3),
    _case("dp2_sp2", (2, 32, 4, 2, 8), True, mesh=(2, 2), dims=("dp", "sp"),
          batch_axis="dp", seed=4),
]
NAMES = [c["name"] for c in CASES]


def _jax_case(case):
    from paddle_tpu_torch.testing.cp_ranks import ring_inputs

    q, k, v, w = (jnp.asarray(a) for a in ring_inputs(case))
    n = int(np.prod(case["mesh"]))
    mesh = ProcessMesh(np.arange(n).reshape(case["mesh"]),
                       dim_names=case["dims"])

    def f(q, k, v):
        o = ra.ring_attention_data(q, k, v, mesh, axis_name="sp",
                                   causal=case["causal"],
                                   batch_axis=case["batch_axis"])
        return jnp.sum(o * w), o

    (_, o), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    return {"o": np.asarray(o), "dq": np.asarray(grads[0]),
            "dk": np.asarray(grads[1]), "dv": np.asarray(grads[2])}


def _jax_tensor_op():
    import paddle_tpu as paddle
    from paddle_tpu.distributed.mesh import init_mesh, set_mesh

    init_mesh([4], ["sp"])
    try:
        paddle.seed(0)
        q, k, v = (paddle.randn([1, 32, 2, 8]) for _ in range(3))
        for t in (q, k, v):
            t.stop_gradient = False
        out = ra.ring_attention(q, k, v, axis_name="sp", causal=True)
        out.sum().backward()
        return {"o": out.numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                "dv": v.grad.numpy()}
    finally:
        set_mesh(None)


@pytest.fixture(scope="module")
def runs():
    from paddle_tpu_torch.testing import cp_ranks, gloo_ranks

    world = gloo_ranks.start(cp_ranks.ring_cases, 4, CASES)
    refs = {c["name"]: _jax_case(c) for c in CASES}
    op = _jax_tensor_op()
    got = world.results()
    return refs, got, op, [g["tensor_op"] for g in got]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("what", ["o", "dq", "dk", "dv"])
def test_matches_the_jax_ring(runs, name, what):
    """Every rank's global output, and the gradients of q, k and v (dK and
    dV come home over the ring), at the JAX ring's values."""
    refs, got, _, _ = runs
    for r in range(4):
        np.testing.assert_allclose(got[r][name][what], refs[name][what],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"rank {r}")


def test_tensor_op_matches_the_jax_op(runs):
    """``ring_attention`` on Tensors from the port's generator: the JAX
    op's values and gradients (the generators draw the same q, k, v)."""
    _, _, ref, op = runs
    for r in range(4):
        assert op[r]["shape"] == [1, 32, 2, 8]
        for what in ("o", "dq", "dk", "dv"):
            np.testing.assert_allclose(op[r][what], ref[what], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{what} rank {r}")


def test_plain_recurrence_and_simulated_ring_match_dense_attention():
    """One process: the reference's recurrence (``ring_attention_plain``)
    and the ring's own rank bodies driven for every rank
    (``ring_attention_simulated``: the hops, the accumulation and the
    hop home of ``_Ring``; the card checks' two sides) against dense
    attention and its autograd, GQA, causal and not (f32, 1e-5)."""
    import torch

    from paddle_tpu_torch.ops.ring_attention import (
        ring_attention_plain, ring_attention_simulated)

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 32, 8, 16, generator=g)
    k = torch.randn(2, 32, 2, 16, generator=g)
    v = torch.randn(2, 32, 2, 16, generator=g)
    w = torch.randn(2, 32, 8, 16, generator=g)
    for causal in (True, False):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        dense = torch.nn.functional.scaled_dot_product_attention(
            qq.transpose(1, 2), kk.repeat_interleave(4, 2).transpose(1, 2),
            vv.repeat_interleave(4, 2).transpose(1, 2),
            is_causal=causal).transpose(1, 2)
        (dense * w).sum().backward()
        plain = ring_attention_plain(q, k, v, 4, causal)
        sim = ring_attention_simulated(q, k, v, w, 4, causal)
        for got, want in ((plain, dense), (sim["o"], dense),
                          (sim["dq"], qq.grad), (sim["dk"], kk.grad),
                          (sim["dv"], vv.grad)):
            torch.testing.assert_close(got, want.detach(), rtol=RTOL,
                                       atol=ATOL)


def test_future_chunks_are_skipped():
    """Causal: rank r computes r + 1 chunks (its diagonal and the r
    earlier ones), not the P of the reference's masked ring; without
    causality every rank computes all P."""
    from paddle_tpu_torch.ops.ring_attention import _visits

    for n in (1, 2, 4):
        for r in range(n):
            seen = list(_visits(r, n, True))
            assert [src for _, src, _ in seen] == list(range(r, -1, -1))
            assert [c for _, _, c in seen] == [True] + [False] * r
            assert len(list(_visits(r, n, False))) == n
