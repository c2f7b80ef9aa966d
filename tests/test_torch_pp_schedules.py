"""The port's pipeline schedules ("gpipe", "zero_bubble", "interleave"
and "1f1b") against the JAX package's, and its schedule arithmetic
(``_vpp_schedule``, ``_layer_perm``, ``bubble_fraction``) against the
JAX package's exactly.

The parity cases run as in ``test_torch_pipeline.py``: the JAX step in
this process at the port's mesh, the port's ranks in one gloo world of
4, losses rtol 1e-4 on every rank, parameters rtol 2e-3 / atol 2e-5.
Here every case of the JAX package's ``tests/test_pp_schedules.py`` at pp
4 with 8 layers and 16 rows; the interleaved pipeline is cut for its V
(``num_virtual_pipeline_stages``) on each rank."""
import types

import numpy as np
import pytest

import _pipeline_jax as pj

PP4 = dict(mesh=[4], dims=["pp"])


def _sched(name, schedule, M=8, steps=3, **kw):
    case = dict(name=name, spec=dict(model="block", layers=8),
                schedule=schedule, M=M, opt="adamw",
                opt_kw=dict(learning_rate=1e-2), loss="mse", seed=3,
                batches=pj.block_batches(steps, b=16, seed=0), **PP4)
    case.update(kw)
    return case


def _cases():
    return [
        _sched("1f1b", "1f1b"),
        _sched("gpipe", "gpipe"),
        _sched("zero_bubble", "zero_bubble"),
        _sched("interleave", "interleave", V=2),
        _sched("interleave_lr0", "interleave", V=2, steps=1, opt="sgd",
               opt_kw=dict(learning_rate=0.0)),
        _sched("interleave_dp2_pp2", "interleave", V=2, M=4,
               mesh=[2, 2], dims=["dp", "pp"]),
    ]


@pytest.fixture(scope="module")
def runs():
    from paddle_tpu_torch.testing import gloo_ranks, pipeline_ranks

    cases = _cases()
    finish = [pj.prepare(c) for c in cases]
    x = np.arange(8 * 2 * 3, dtype=np.float32).reshape(8, 2, 3)
    world = gloo_ranks.start(pipeline_ranks.several, 4, [
        ("rotations", (x,)), ("pipeline_cases", (cases,))],
        timeout_s=300)
    refs = {c["name"]: f() for c, f in zip(cases, finish)}
    res = world.results()
    return ({c["name"]: c for c in cases}, refs, [r[1] for r in res],
            [r[0] for r in res], x)


@pytest.mark.parametrize("name", ["1f1b", "gpipe", "zero_bubble",
                                  "interleave", "interleave_dp2_pp2"])
def test_schedule_matches_the_jax_pipeline(runs, name):
    cases, refs, results, _, _ = runs
    pj.check_case(results, cases[name], refs[name])


def test_all_schedules_agree(runs):
    """The schedules are re-orderings of one computation: their losses
    agree (the JAX package's bound)."""
    cases, refs, results, _, _ = runs
    a = results[0]["1f1b"]["losses"]
    for name in ("gpipe", "interleave", "zero_bubble"):
        np.testing.assert_allclose(a, results[0][name]["losses"],
                                   rtol=2e-3, atol=5e-5)


def test_rotations_give_back_their_input(runs):
    """Identity stages through pipeline_forward, the VPP rotation and the
    conveyor reproduce the input on every rank; a stage that adds its
    rank shows the ring's order (rank 0 first)."""
    _, _, _, rot, x = runs
    for r in range(4):
        for key in ("forward", "vpp", "interleaved"):
            np.testing.assert_array_equal(rot[r][key], x, err_msg=key)
        want = x[:, :1, :1]
        for k in range(4):
            want = want * 10.0 + (k + 1)
        np.testing.assert_allclose(rot[r]["order"], want)


def test_bubble_fraction_and_layer_perm_of_the_runs(runs):
    cases, refs, results, _, _ = runs
    for name in ("1f1b", "gpipe", "zero_bubble", "interleave"):
        for r in range(4):
            got = results[r][name]
            assert got["bubble_fraction"] == refs[name]["bubble_fraction"]
            assert got["layer_perm"] == refs[name]["layer_perm"]
    assert results[0]["1f1b"]["bubble_fraction"] == pytest.approx(3 / 7)
    assert results[0]["gpipe"]["bubble_fraction"] == pytest.approx(3 / 11)
    assert results[0]["interleave"]["bubble_fraction"] == \
        pytest.approx(3 / 19)


def test_interleave_owns_the_layer_perm_chunks(runs):
    """Rank r of an interleaved pipeline holds its V chunks of the JAX
    step's ``_layer_perm`` (8 layers, S 4, V 2: rank r holds r and
    r + 4)."""
    cases, refs, results, _, _ = runs
    perm = refs["interleave"]["layer_perm"]
    for r in range(4):
        assert results[r]["interleave"]["owned"] == perm[2 * r:2 * r + 2]
        assert results[r]["interleave"]["owned"] == [r, r + 4]


def test_interleave_lr0_keeps_every_parameter(runs):
    """After a step at lr 0 the state assembled from the ranks equals the
    initial weights (the de-permuted layers are the JAX package's)."""
    cases, refs, results, _, _ = runs
    c = cases["interleave_lr0"]
    got = pj.assemble(results, c)
    for k, want in c["state"].items():
        np.testing.assert_allclose(got[k], want, rtol=1e-6, atol=1e-6,
                                   err_msg=f"lr=0 must not move {k}")


# ---------------------------------------------------------------------------
# the schedule arithmetic, exactly
# ---------------------------------------------------------------------------
GRID = [(S, M, V) for S in (1, 2, 3, 4) for M in (1, 2, 4, 6, 8)
        for V in (1, 2, 3)]


@pytest.mark.parametrize("S,M,V", GRID)
def test_vpp_schedule_arrays_equal_the_jax_package(S, M, V):
    from paddle_tpu.distributed.fleet import pipeline_parallel as jpp
    from paddle_tpu_torch.distributed.fleet import pipeline_parallel as tpp

    try:
        want = jpp._vpp_schedule(M, S, V)
    except AssertionError:
        with pytest.raises(AssertionError):
            tpp._vpp_schedule(M, S, V)
        return
    got = tpp._vpp_schedule(M, S, V)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe", "interleave",
                                      "zero_bubble"])
def test_bubble_fraction_equals_the_jax_package(schedule):
    from paddle_tpu.distributed.fleet.pp_engine import (
        PipelineTrainStep as JaxStep)
    from paddle_tpu_torch.distributed.fleet.pp_engine import (
        PipelineTrainStep as TorchStep)

    for S, M, V in GRID:
        v = V if schedule == "interleave" else 1
        cm = M if schedule != "1f1b" else S * v
        ns = types.SimpleNamespace(schedule=schedule, S=S, V=v,
                                   _chunk_mb=cm)
        assert TorchStep.bubble_fraction.fget(ns) == \
            JaxStep.bubble_fraction.fget(ns), (S, M, V)


@pytest.mark.parametrize("L,S,V", [(8, 4, 2), (8, 2, 2), (12, 2, 3),
                                   (8, 4, 1), (16, 4, 4), (6, 3, 2)])
def test_layer_perm_equals_the_jax_step(L, S, V):
    """The port's ``layer_perm`` is the JAX step's ``_layer_perm``, and
    each rank's PipelineLayer owns its slice of it."""
    import paddle_tpu as paddle
    from paddle_tpu import nn as jnn, optimizer as jopt
    from paddle_tpu.distributed.fleet.pp_engine import (
        PipelineTrainStep as JaxStep)
    from paddle_tpu.distributed.mesh import ProcessMesh
    from paddle_tpu_torch.distributed.fleet.pipeline_parallel import (
        layer_perm)
    from paddle_tpu_torch.testing.pipeline_ranks import build_pipe

    paddle.seed(0)
    pipe = pj.jax_pipe(dict(model="block", layers=L), S)
    step = JaxStep(pipe, jnn.MSELoss(),
                   jopt.SGD(0.1, parameters=pipe.parameters()),
                   ProcessMesh(np.arange(S), ["pp"]), n_microbatches=S * V,
                   schedule="interleave" if V > 1 else "1f1b",
                   interleave_degree=V)
    assert layer_perm(L, S, V) == list(step._layer_perm)
    per = L // S
    for r in range(S):
        mine = build_pipe(dict(model="block", layers=L), S, r, V)
        assert mine._owned == list(step._layer_perm)[r * per:(r + 1) * per]
        assert list(mine.body_layers.keys()) == [str(k) for k in mine._owned]


# ---------------------------------------------------------------------------
# the errors
# ---------------------------------------------------------------------------
def _port_step(schedule="1f1b", M=None, V=2, layers=8, stage_v=1):
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.distributed.fleet.pp_engine import (
        PipelineTrainStep)
    from paddle_tpu_torch.testing.pipeline_ranks import build_pipe

    pipe = build_pipe(dict(model="block", layers=layers), 4, 0, stage_v)
    return PipelineTrainStep(
        pipe, nn.MSELoss(), optimizer.SGD(0.1, parameters=pipe.parameters()),
        ProcessMesh(np.arange(4), ["pp"]), n_microbatches=M,
        schedule=schedule, interleave_degree=V)


def test_invalid_schedule_and_degree():
    with pytest.raises(ValueError, match="schedule"):
        _port_step(schedule="wavelike")
    with pytest.raises(ValueError, match="divisible"):
        _port_step(schedule="interleave", M=12, V=3)
    with pytest.raises(ValueError, match="interleave_degree"):
        _port_step(schedule="interleave", V=0)


def test_rejects_ragged_microbatches():
    with pytest.raises(ValueError, match="multiple"):
        _port_step(M=6, layers=4)


def test_interleave_needs_a_layer_cut_for_it():
    """A rank's PipelineLayer is cut for one V; a step of another V is
    refused (the JAX package restacks its layers in the step)."""
    with pytest.raises(ValueError, match="num_virtual_pipeline_stages"):
        _port_step(schedule="interleave", M=8, V=2, stage_v=1)
