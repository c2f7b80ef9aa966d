"""The port's ZeRO stages and recompute against the JAX
``ParallelTrainStep``, at dp 2 (the dp 2 x mp 2 grid is in
``test_torch_parallel_zero_mp.py``). Same setup and bounds as
``test_torch_parallel_train.py``: the JAX step in this process on
conftest's virtual devices, the port's ranks in one gloo world of 4,
losses rtol 1e-4 on every rank, parameters assembled from the shards
rtol 2e-3 / atol 2e-5; each rank's slots have the shape of the JAX
slot's addressable shard (the reference's ``addressable_shards``
check)."""
import numpy as np
import pytest

import _hybrid_jax as hj

DP2 = ([2], ["dp"])


def _cases():
    rng = np.random.RandomState(1)
    x = rng.randn(8, 16).astype(np.float32)
    y = rng.randn(8, 16).astype(np.float32)
    mlp = dict(model="seq_mlp", opt="adamw", opt_kw=dict(learning_rate=0.01),
               loss="mse", seed=7, mesh=[4], dims=["dp"],
               batches=[(x, y)] * 6)
    return [
        hj.llama_case("z1_dp2", *DP2, config=dict(sharding_stage=1)),
        hj.llama_case("z2_dp2", *DP2, config=dict(sharding_stage=2)),
        hj.llama_case("z3_dp2", *DP2, config=dict(sharding_stage=3)),
        hj.llama_case("z3_remat_dp2", *DP2,
                      config=dict(sharding_stage=3, remat=True)),
        dict(name="mlp_z1", config=dict(sharding_stage=1), **mlp),
        dict(name="mlp_z3", config=dict(sharding_stage=3), **mlp),
    ]


@pytest.fixture(scope="module")
def runs():
    return hj.parity_runs(_cases())


@pytest.mark.parametrize("name", ["z1_dp2", "z2_dp2", "z3_dp2",
                                  "z3_remat_dp2", "mlp_z1", "mlp_z3"])
def test_matches_the_jax_parallel_step(runs, name):
    cases, refs, results = runs
    hj.check_case(results, cases[name], refs[name])


@pytest.mark.parametrize("name", ["z1_dp2", "z2_dp2", "z3_dp2", "mlp_z1",
                                  "mlp_z3"])
def test_slot_shapes_are_the_jax_shards(runs, name):
    """Stage >= 1 slices the slots over dp on the first dim the axis
    divides (the JAX ``_pspec_from_hints``); the shapes are the JAX
    slots' addressable shards (Linear weights transposed to torch's
    [out, in] for the Llama)."""
    cases, refs, results = runs
    n = int(np.prod(cases[name]["mesh"]))
    llama = cases[name]["model"] == "llama"
    for pname, want in refs[name]["slot_shapes"].items():
        if llama and (pname.endswith("_proj.weight")
                      or pname == "lm_head.weight"):
            want = {k: v[::-1] for k, v in want.items()}
        for i in range(n):
            assert results[i][name]["slot_shapes"][pname] == want, \
                (pname, i)


def test_slot_bytes_are_the_share(runs):
    """Each rank's optimizer state is the reckoned share: two f32
    moments over the parameters, halved over dp 2 at stage >= 1 for
    every parameter with a dim dp divides (all of the tiny Llama's)."""
    cases, refs, results = runs
    total = sum(v.size for v in cases["z1_dp2"]["state"].values())
    for name in ("z1_dp2", "z2_dp2", "z3_dp2"):
        for i in range(2):
            assert results[i][name]["slot_bytes"] == 2 * 4 * total // 2


def test_stage3_keeps_shards_at_rest(runs):
    """Stage 3 leaves each parameter cut over dp after the steps; stages 1
    and 2 leave them whole."""
    cases, refs, results = runs
    full = cases["z1_dp2"]["state"]["llama.embed_tokens.weight"].shape
    for name, rows in (("z1_dp2", full[0]), ("z2_dp2", full[0]),
                       ("z3_dp2", full[0] // 2)):
        got = results[0][name]["shards"]["llama.embed_tokens.weight"]
        assert got.shape == (rows, full[1]), name
