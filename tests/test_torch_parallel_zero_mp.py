"""The port's ZeRO stages over a dp 2 x mp 2 grid, recompute, and Lamb's
trust ratio over sharded parameters, against the JAX
``ParallelTrainStep``. Same setup and bounds as
``test_torch_parallel_train.py``."""
import pytest

import _hybrid_jax as hj

DPMP = ([2, 2], ["dp", "mp"])


def _cases():
    return [
        hj.llama_case("z1_dpmp", *DPMP, config=dict(sharding_stage=1)),
        hj.llama_case("z2_dpmp", *DPMP, config=dict(sharding_stage=2)),
        hj.llama_case("z3_dpmp", *DPMP, config=dict(sharding_stage=3)),
        hj.llama_case("z1_recompute_dpmp", *DPMP,
                      config=dict(sharding_stage=1),
                      spec=dict(recompute=True)),
        hj.llama_case("remat_sp_dpmp", *DPMP, config=dict(remat=True),
                      spec=dict(sequence_parallel=True)),
        dict(hj.llama_case("lamb_z1_dpmp", *DPMP,
                           config=dict(sharding_stage=1)),
             opt="lamb", opt_kw=dict(learning_rate=1e-3)),
        # a second ParallelTrainStep (and optimizer) over the model the
        # first one sharded: the heads stay the rank's share
        hj.llama_case("restart_dpmp", *DPMP, restart_at=1),
    ]


@pytest.fixture(scope="module")
def runs():
    return hj.parity_runs(_cases())


@pytest.mark.parametrize("name", ["z1_dpmp", "z2_dpmp", "z3_dpmp",
                                  "z1_recompute_dpmp", "remat_sp_dpmp",
                                  "lamb_z1_dpmp", "restart_dpmp"])
def test_matches_the_jax_parallel_step(runs, name):
    cases, refs, results = runs
    hj.check_case(results, cases[name], refs[name])


def test_slots_are_cut_over_both_axes(runs):
    """At stage >= 1 over dp 2 x mp 2 a column weight's slots are cut
    over mp on its out dim and over dp on its in dim: a quarter each."""
    cases, refs, results = runs
    q = cases["z1_dpmp"]["state"]["llama.layers.0.self_attn.q_proj.weight"]
    for i in range(4):
        got = results[i]["z1_dpmp"]["slot_shapes"][
            "llama.layers.0.self_attn.q_proj.weight"]
        assert got["moment1"] == (q.shape[1] // 2, q.shape[0] // 2)
