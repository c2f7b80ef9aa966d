"""The port's Megatron sequence parallelism against the reference's
three tests (``tests/test_sequence_parallel.py``): the SP ops are the
identity without a mesh; the column -> row SP linear pair equals the
dense computation under a 2 x 2 mesh; and the SP Llama trains as the
TP-only Llama does (and as the JAX ``ParallelTrainStep`` does), with the
norms' weights equal across the mp ranks after 3 steps. One gloo world
of 4 ranks runs the port's parts."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.utils import (
    AllGatherOp, ColumnSequenceParallelLinear, GatherOp, ReduceScatterOp,
    RowSequenceParallelLinear, ScatterOp)
from paddle_tpu_torch.testing import gloo_ranks, hybrid_ranks

import _hybrid_jax as hj

D, M, S, B = 16, 32, 8, 4
DPMP = ([2, 2], ["dp", "mp"])


def _llama(name, sp):
    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, 128, (8, 32)).astype(np.int32),
                rng.randint(0, 128, (8, 32)).astype(np.int32))
               for _ in range(3)]
    return dict(hj.llama_case(name, *DPMP, spec=dict(
        num_key_value_heads=4, sequence_parallel=sp)), batches=batches)


@pytest.fixture(scope="module")
def runs():
    paddle.seed(7)
    col = ColumnSequenceParallelLinear(D, M, has_bias=True, seq_axis=0)
    row = RowSequenceParallelLinear(M, D, has_bias=True, seq_axis=0)
    state = {"col.weight": col.weight.numpy(), "col.bias": col.bias.numpy(),
             "row.weight": row.weight.numpy(), "row.bias": row.bias.numpy()}
    x = np.random.RandomState(0).randn(S, B, D).astype(np.float32)
    cases = [_llama("tp_only", False), _llama("sp", True)]
    finish = [hj.prepare(c) for c in cases]
    world = gloo_ranks.start(hybrid_ranks.several, 4, [
        ("sequence_parallel", (state, x)), ("train_cases", (cases,))],
        timeout_s=180)
    refs = {c["name"]: f() for c, f in zip(cases, finish)}
    return state, x, {c["name"]: c for c in cases}, refs, world.results()


def test_sp_ops_identity_without_mesh(runs):
    """Outside a mesh the SP ops are the identity on values (both
    packages)."""
    _, x, _, _, results = runs
    assert all(all(r[0]["identity"]) for r in results)
    xt = paddle.to_tensor(x)
    for op in (ScatterOp, GatherOp, AllGatherOp, ReduceScatterOp):
        np.testing.assert_array_equal(op.apply(xt, axis=1).numpy(), x)


def test_sp_linears_match_dense_on_mesh(runs):
    """Each mp rank's output is its slice of the sequence of the dense
    relu(x Wc + bc) Wr + br (the reference's tolerance)."""
    state, x, _, _, results = runs
    ref = np.maximum(x @ state["col.weight"] + state["col.bias"], 0.0) \
        @ state["row.weight"] + state["row.bias"]
    halves = np.split(ref, 2, axis=0)
    for r in results:
        got = r[0]
        np.testing.assert_allclose(got["out"], halves[got["mp_rank"]],
                                   rtol=2e-5, atol=2e-5)


def test_llama_sp_matches_tp_only(runs):
    """SP losses align with TP-only (the reference's rtol 5e-4 / atol
    1e-5), both match the JAX step's, and the norms' weights (whose
    gradients are summed over mp) stay equal across the mp ranks."""
    _, _, cases, refs, results = runs
    tp = [r[1]["tp_only"] for r in results]
    sp = [r[1]["sp"] for r in results]
    for a, b in zip(tp, sp):
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=5e-4,
                                   atol=1e-5)
    for name in ("tp_only", "sp"):
        hj.check_case([r[1] for r in results], cases[name], refs[name])
    norms = [n for n in sp[0]["shards"] if n.endswith("norm.weight")]
    assert len(norms) == 5
    for n in norms:
        for dp in (0, 2):     # ranks dp*2 + {0, 1} share a dp coordinate
            np.testing.assert_array_equal(sp[dp]["shards"][n],
                                          sp[dp + 1]["shards"][n])
