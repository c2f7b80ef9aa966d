"""The port's ``ParallelTrainStep`` against the JAX package's.

The JAX step runs in this process on conftest's virtual CPU devices (its
jnp attention path, ``use_flash_attention=False``, the function of the
flash kernels); the port's ranks run in one gloo world of 4 processes
(``paddle_tpu_torch.testing.hybrid_ranks``), every case in it. Both
start from the JAX model's weights and take the same global batches;
the port's parameters are assembled from the ranks' shards. Bounds:
losses rtol 1e-4 on every rank, parameters rtol 2e-3 / atol 2e-5 (the
reference's own ``tests/test_distributed_engine.py``).

Here: the tiny Llama (2 layers, hidden 64, 4 heads, 2 kv heads) at dp 2,
mp 2 and dp 2 x mp 2, with sequence parallelism, a GradScaler and the
global-norm clip, and the reference's MLP and TinyLM cases, the
``skip_nonfinite`` guard with a NaN batch, a sum-reduced loss, and the
BatchNorm statistics (the ZeRO stages and recompute are in
``test_torch_parallel_zero.py``)."""
import numpy as np
import pytest

import _hybrid_jax as hj

DPMP = ([2, 2], ["dp", "mp"])


def _mlp_batches(rng, n, bad_step=None, d=16, b=8):
    out = []
    for i in range(n):
        x = rng.standard_normal((b, d)).astype(np.float32)
        y = rng.standard_normal((b, d)).astype(np.float32)
        if i == bad_step:
            x[0, 0] = np.nan
        out.append((x, y))
    return out


def _cases():
    rs = np.random.RandomState
    cases = [
        hj.llama_case("llama_dp2", [2], ["dp"]),
        hj.llama_case("llama_mp2", [2], ["mp"]),
        hj.llama_case("llama_dp2_mp2", *DPMP),
        hj.llama_case("llama_sp", *DPMP, spec=dict(sequence_parallel=True)),
        hj.llama_case("llama_scaler", *DPMP,
                      scaler=dict(init_loss_scaling=1024.0)),
        hj.llama_case("llama_clip", *DPMP, clip=0.5),
        dict(name="tp_mlp", model="tp_mlp", opt="sgd",
             opt_kw=dict(learning_rate=0.1), loss="mse", seed=123,
             mesh=[2, 2], dims=["dp", "mp"],
             batches=[(x, y) for x, y in [(
                 rs(0).randn(16, 16).astype(np.float32),
                 rs(1).randn(16, 16).astype(np.float32))] * 5]),
        dict(name="tinylm", model="tinylm", opt="adam",
             opt_kw=dict(learning_rate=0.01), loss="pce", seed=3,
             mesh=[2, 2], dims=["dp", "mp"],
             batches=[(rs(4).randint(0, 64, (8, 12)).astype(np.int32),
                       rs(5).randint(0, 64, (8, 12)).astype(np.int32))] * 8),
        dict(name="skip_nonfinite", model="seq_mlp", opt="adamw",
             opt_kw=dict(learning_rate=0.01), loss="mse", seed=7,
             mesh=[2], dims=["dp"], skip_nonfinite=True, snapshot_before=1,
             batches=_mlp_batches(np.random.default_rng(0), 3, bad_step=1)),
        dict(name="mse_sum", model="seq_mlp", opt="sgd",
             opt_kw=dict(learning_rate=0.01), loss="mse_sum", seed=5,
             mesh=[2], dims=["dp"],
             batches=_mlp_batches(np.random.default_rng(1), 3)),
        # a mean over the labels not ignored: rank 0's share holds 1 of
        # them, rank 1's 3, so the batch's loss is not the ranks' mean
        dict(name="ce_ignore", model="seq_mlp", opt="sgd",
             opt_kw=dict(learning_rate=0.1), loss="ce", seed=6,
             mesh=[2], dims=["dp"],
             batches=[(x, np.where(np.isin(np.arange(8), [0, 1, 2, 7]),
                                   -100, rs(8).randint(0, 16, 8))
                       .astype(np.int64))
                      for x, _ in _mlp_batches(np.random.default_rng(4),
                                               3)]),
        dict(name="batchnorm", model="bn", opt="sgd",
             opt_kw=dict(learning_rate=0.1), loss="mse", seed=9,
             mesh=[2], dims=["dp"],
             batches=_mlp_batches(np.random.default_rng(2), 3, d=8)),
        dict(name="syncbatchnorm", model="syncbn", opt="sgd",
             opt_kw=dict(learning_rate=0.1), loss="mse", seed=9,
             mesh=[2], dims=["dp"],
             batches=_mlp_batches(np.random.default_rng(2), 3, d=8)),
        dict(name="dropout", model="dropout", spec=dict(p=0.3), opt="sgd",
             opt_kw=dict(learning_rate=0.1), loss="mse", seed=11,
             mesh=[2], dims=["dp"],
             batches=_mlp_batches(np.random.default_rng(3), 3)),
    ]
    return cases


@pytest.fixture(scope="module")
def runs():
    return hj.parity_runs(_cases())


@pytest.mark.parametrize("name", [
    "llama_dp2", "llama_mp2", "llama_dp2_mp2", "llama_sp", "llama_scaler",
    "llama_clip", "tp_mlp", "tinylm", "mse_sum", "ce_ignore", "batchnorm",
    "syncbatchnorm", "dropout"])
def test_matches_the_jax_parallel_step(runs, name):
    cases, refs, results = runs
    hj.check_case(results, cases[name], refs[name])


@pytest.mark.parametrize("name,pname", [
    ("tp_mlp", "fc1.weight"), ("tp_mlp", "fc2.weight"),
    ("tinylm", "emb.weight"), ("tinylm", "proj.weight")])
def test_slot_shapes_are_the_jax_shards(runs, name, pname):
    """Each rank's slots have the shape of the JAX slot's addressable
    shard (mp-sharded parameters keep mp-sharded slots)."""
    cases, refs, results = runs
    for i in range(4):
        assert results[i][name]["slot_shapes"][pname] == \
            refs[name]["slot_shapes"][pname]


def test_the_tensor_parallel_weights_are_shards(runs):
    """The reference's ``test_tp_param_sharding_applied`` at mp 2: the
    column weight [16, 32] is split on its out dim, the row weight
    [32, 16] on its in dim."""
    _, _, results = runs
    shards = results[0]["tp_mlp"]["shards"]
    assert shards["fc1.weight"].shape == (16, 16)
    assert shards["fc2.weight"].shape == (16, 16)
    assert shards["fc1.bias"].shape == (16,)
    assert shards["fc2.bias"].shape == (16,)


def test_skip_nonfinite_skips_on_every_rank(runs):
    """A NaN in one rank's share of the batch at step 2: every rank skips
    the update (params and slots bit for bit), counts one skip, and the
    clean steps around it match the JAX step."""
    cases, refs, results = runs
    ref = refs["skip_nonfinite"]
    assert ref["skipped_steps"] == 1
    for i in range(2):
        r = results[i]["skip_nonfinite"]
        assert r["skipped_steps"] == 1
        assert r["skip_kept"]
        assert np.isnan(r["losses"][1]) and np.isnan(ref["losses"][1])
        np.testing.assert_allclose(
            [r["losses"][0], r["losses"][2]],
            [ref["losses"][0], ref["losses"][2]], rtol=hj.LOSS_RTOL)
    got = hj.assemble(results, "skip_nonfinite", 2)
    for pname, want in ref["final"].items():
        np.testing.assert_allclose(got[pname], want, rtol=hj.PARAM_RTOL,
                                   atol=hj.PARAM_ATOL, err_msg=pname)
