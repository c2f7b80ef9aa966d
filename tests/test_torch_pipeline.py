"""The port's pipeline parallelism (``PipelineLayer``, the rotation,
``PipelineTrainStep`` at "1f1b", ``PipelineParallel``) against the JAX
package's.

The JAX step runs in this process on conftest's virtual CPU devices over
a mesh of the port's shape; the port's ranks run in one gloo world of 4
processes (``paddle_tpu_torch.testing.pipeline_ranks``), every case in
it. Both start from the JAX pipeline's weights and take the same
batches; the port's parameters are assembled from the ranks' stages and
slices. Bounds: losses rtol 1e-4 on every rank, parameters rtol 2e-3 /
atol 2e-5 (``tests/_pipeline_jax.py``). Each case of the JAX package's
``tests/test_pipeline.py`` is here at pp 4 or dp 2 x pp 2, with the
GradScaler, the clip, ``skip_nonfinite``, a dropout body and
``eval_batch`` beside them."""
import numpy as np
import pytest

import _pipeline_jax as pj

PP4 = dict(mesh=[4], dims=["pp"])
DP2PP2 = dict(mesh=[2, 2], dims=["dp", "pp"])


def _block(name, steps=5, seed=11, b=8, M=4, **kw):
    return dict(dict(name=name, spec=dict(model="block"), M=M, opt="adam",
                     opt_kw=dict(learning_rate=0.01), loss="mse", seed=seed,
                     batches=pj.block_batches(steps, b=b, seed=seed)),
                **kw)


def _cases():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 32, (8,)).astype(np.int64)
    labels = np.random.RandomState(1).randint(0, 32, (8,)).astype(np.int64)
    xp = np.random.RandomState(1).randn(8, 8).astype(np.float32)
    # rows 0-2 and 6 ignored: chunk 0's dp shares hold 0 and 1 of their
    # labels, chunk 1's 2 and 1
    ignored = np.where(np.isin(np.arange(8), [0, 1, 2, 6]), -100, labels)
    return [
        _block("pp4", **PP4),
        _block("chunked", b=16, M=8, steps=4, seed=17, **PP4),
        dict(name="tied", spec=dict(model="tied", vocab=32), M=4,
             opt="sgd", opt_kw=dict(learning_rate=0.1), loss="ce",
             remat=False, seed=33, batches=[(ids, labels)] * 4, **PP4),
        _block("plain_sgd", steps=4, seed=29, opt="sgd",
               opt_kw=dict(learning_rate=0.05), **PP4),
        _block("scaled", steps=4, seed=29, opt="sgd",
               opt_kw=dict(learning_rate=0.05),
               scaler=dict(init_loss_scaling=256.0), **PP4),
        _block("predict_after", steps=5, seed=22,
               opt_kw=dict(learning_rate=0.05), predict_before=xp,
               predict_after=xp,
               batches=[(xp, np.zeros((8, 8), np.float32))] * 5, **PP4),
        _block("other", steps=2, seed=5, spec=dict(model="other"), **PP4),
        _block("dp2_pp2", steps=4, seed=7, M=4, **DP2PP2),
        _block("skip_nonfinite", steps=4, seed=9, skip_nonfinite=True,
               batches=pj.block_batches(4, seed=9, bad_step=1), **PP4),
        _block("dropout", steps=3, seed=13, spec=dict(model="drop", p=0.3),
               **PP4),
        _block("dropout_dp2_pp2", steps=3, seed=14, b=16,
               spec=dict(model="drop", p=0.3), **DP2PP2),
        # the same fed by mesh-placed prefetch: each rank holds its
        # contiguous block of the batch, and the two chunks take a share
        # of each rank's block
        _block("placed_dropout_dp2_pp2", steps=3, seed=14, b=16,
               spec=dict(model="drop", p=0.3), placed=True, **DP2PP2),
        dict(name="placed_ignore_dp2_pp2", spec=dict(model="tied", vocab=32),
             M=4, opt="sgd", opt_kw=dict(learning_rate=0.1), loss="ce",
             remat=False, seed=34, batches=[(ids, ignored)] * 3,
             placed=True, **DP2PP2),
        _block("replicated_pre_post", steps=3, seed=15,
               shard_pre_post=False, **PP4),
        _block("clip", steps=3, seed=16, clip=0.05, **PP4),
        _block("eval_batch", steps=2, seed=21, eval_batch=(xp, xp), **PP4),
    ]


@pytest.fixture(scope="module")
def world_runs():
    """The cases, and the fleet facade over the pp4 case, in one world."""
    from paddle_tpu_torch.testing import gloo_ranks, pipeline_ranks

    cases = _cases()
    finish = [pj.prepare(c) for c in cases]
    world = gloo_ranks.start(pipeline_ranks.several, 4, [
        ("pipeline_cases", (cases,)), ("fleet_pipeline", (cases[0],))],
        timeout_s=300)
    refs = {c["name"]: f() for c, f in zip(cases, finish)}
    res = world.results()
    return ({c["name"]: c for c in cases}, refs, [r[0] for r in res],
            [r[1] for r in res])


@pytest.fixture(scope="module")
def runs(world_runs):
    return world_runs[:3]


@pytest.mark.parametrize("name", [
    "pp4", "chunked", "tied", "plain_sgd", "scaled", "predict_after",
    "other", "dp2_pp2", "skip_nonfinite", "dropout", "dropout_dp2_pp2",
    "placed_dropout_dp2_pp2", "placed_ignore_dp2_pp2",
    "replicated_pre_post", "clip", "eval_batch"])
def test_matches_the_jax_pipeline(runs, name):
    cases, refs, results = runs
    pj.check_case(results, cases[name], refs[name])


def test_mesh_placed_batch_is_the_ranks_block(runs):
    """The placed cases' steps took DistTensor batches holding each dp
    rank's half of the rows (not the global batch), in two chunks."""
    cases, refs, results = runs
    for name, rows in (("placed_dropout_dp2_pp2", 8),
                       ("placed_ignore_dp2_pp2", 4)):
        for r in range(4):
            res = results[r][name]
            assert res["placed_rows"] == [rows] * 3
            assert res["n_chunks"] == refs[name]["n_chunks"] == 2


def test_segmentation_and_stage_ownership(runs):
    """Each pp rank holds pre 1, its L/S body layers and post 1, with the
    JAX package's ``_body_range``; seg_method "layer:Block" skips the
    leading Other LayerDesc as the JAX package does."""
    cases, refs, results = runs
    for name in ("pp4", "other"):
        c = cases[name]
        for r in range(4):
            got = results[r][name]
            assert got["body_range"] == c["jax_body_range"]
            pre, body, post = c["jax_sections"]
            assert got["sections"] == [pre, body // 4, post]
            assert got["owned"] == [r]


def test_chunked_accumulation_runs_two_chunks(runs):
    cases, refs, results = runs
    assert refs["chunked"]["n_chunks"] == 2
    assert all(results[r]["chunked"]["n_chunks"] == 2 for r in range(4))


def test_pre_post_storage_sharded_over_pp(runs):
    """Every pp rank holds 1/4 of the pre and post weights and of their
    slots (the JAX step's pp-sharded storage: its shard shape)."""
    cases, refs, results = runs
    full = cases["pp4"]["state"]["pre_layers.0.weight"].shape
    jax_shard = tuple(refs["pp4"]["pre_shard_shapes"][0])
    for r in range(4):
        res = results[r]["pp4"]
        got = res["shards"]["pre_layers.0.weight"].shape
        assert got == jax_shard and got[0] * 4 == full[0]
        assert res["slot_shapes"]["pre_layers.0.weight"]["moment1"] == got
        assert res["shards"]["post_layers.0.weight"].shape[0] * 4 == full[0]
    rep = results[0]["replicated_pre_post"]["shards"]["pre_layers.0.weight"]
    assert rep.shape == full


def test_tied_weight_is_one_parameter(runs):
    """The tied embedding and head are one parameter: the head's use
    reads the embedding's slice on every rank (no second copy, no
    second set of slots), so the two uses never differ."""
    cases, refs, results = runs
    for r in range(4):
        res = results[r]["tied"]
        assert "post_layers.0.inner.weight" not in res["shards"]
        assert list(res["slot_shapes"]) == [
            n for n in res["shards"] if not n.startswith("post_layers")]


def test_scaler_cancels_in_the_update(runs):
    """GradScaler inside the step: the scaled run's losses equal the
    unscaled run's (scaling cancels on the finite path)."""
    cases, refs, results = runs
    np.testing.assert_allclose(results[0]["scaled"]["losses"],
                               results[0]["plain_sgd"]["losses"],
                               rtol=5e-4, atol=1e-6)


def test_skip_nonfinite_skips_the_nan_step(runs):
    cases, refs, results = runs
    assert refs["skip_nonfinite"]["skipped_steps"] == 1
    for r in range(4):
        assert results[r]["skip_nonfinite"]["skipped_steps"] == 1


def test_predict_matches_and_sees_training(runs):
    """predict() over the pp ranks equals the JAX step's predict before
    and after training, on every rank; training toward zero shrinks
    the outputs."""
    cases, refs, results = runs
    ref = refs["predict_after"]
    for r in range(4):
        res = results[r]["predict_after"]
        np.testing.assert_allclose(res["predict_before"],
                                   ref["predict_before"], rtol=5e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(res["predict_after"],
                                   ref["predict_after"], rtol=5e-4,
                                   atol=1e-5)
    assert np.abs(ref["predict_after"]).mean() < \
        np.abs(ref["predict_before"]).mean()


def test_eval_batch_runs_the_pipeline_forward(runs):
    """A port rank holds only its stage: ``PipelineParallel.eval_batch``
    runs the pipeline forward (every rank gets the outputs) and the loss
    on them, where the JAX package runs the whole model in its global
    view. Both are held against the JAX pipeline's forward after the
    same training."""
    cases, refs, results = runs
    import paddle_tpu as paddle
    from paddle_tpu import nn

    c = cases["eval_batch"]
    x, y = c["eval_batch"]
    pipe = pj.jax_pipe(c["spec"], 4)
    pipe.set_state_dict({k: paddle.to_tensor(v)
                         for k, v in refs["eval_batch"]["final"].items()})
    pipe.eval()
    want = np.asarray(pipe(paddle.to_tensor(x)).numpy())
    want_loss = float(nn.MSELoss()(pipe(paddle.to_tensor(x)),
                                   paddle.to_tensor(y)).item())
    for r in range(4):
        res = results[r]["eval_batch"]
        np.testing.assert_allclose(res["eval_out"], want, rtol=5e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(res["eval_loss"], want_loss, rtol=5e-4)


def test_fleet_distributed_model_returns_pipeline_parallel(world_runs):
    """At pp_degree 4 ``fleet.distributed_model`` wraps the PipelineLayer
    in a PipelineParallel (each rank's stage from the hybrid group);
    ``eval_batch`` before any step gives the untrained loss (the JAX
    pipeline's first loss: the batch is the first step's); then
    ``train_batch`` trains the JAX pipeline's losses (accumulate_steps
    4: M 4, the pp4 case) on the slices the first forward cut."""
    cases, refs, _, fleet = world_runs
    for r in range(4):
        assert fleet[r]["type"] == "PipelineParallel"
        assert fleet[r]["stage"] == r
        np.testing.assert_allclose(fleet[r]["eval_before"],
                                   refs["pp4"]["losses"][0], rtol=1e-5)
        np.testing.assert_allclose(fleet[r]["losses"], refs["pp4"]["losses"],
                                   rtol=pj.LOSS_RTOL)
        assert np.isfinite(fleet[r]["eval_loss"])


@pytest.mark.slow
def test_dp2_pp4_eight_ranks():
    """dp 2 x pp 4 on 8 ranks against the JAX step on 8 devices."""
    case = _block("dp2_pp4", steps=3, seed=19, b=16, M=4, mesh=[2, 4],
                  dims=["dp", "pp"])
    cases, refs, results = pj.parity_runs([case], world=8)
    pj.check_case(results, cases["dp2_pp4"], refs["dp2_pp4"])
