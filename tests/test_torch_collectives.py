"""The port's collectives (``paddle_tpu_torch.distributed.communication``
and ``compat``) on gloo ranks: every assertion of the reference's
``tests/mp_scripts/collectives_worker.py`` at 2 ranks (plus the object
collectives, ``alltoall_single`` and ``shift``); each collective and
each differentiable pair over the dp and the mp group of a 2 x 2 mesh
at 4 ranks, against numpy; the hybrid group's groups of a 4-rank world;
and a rank killed mid-collective, which fails the others within the
group's timeout and leaves no process. The three worlds run at once."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.testing import gloo_ranks, hybrid_ranks

SEED = 3


@pytest.fixture(scope="module")
def worlds():
    two = gloo_ranks.start(hybrid_ranks.collectives, 2, SEED, timeout_s=120)
    four = gloo_ranks.start(hybrid_ranks.several, 4, [
        ("collectives", (SEED,)),
        ("topology_groups", ([2, 1, 1, 1, 2],)),
        ("topology_groups", ([1, 1, 2, 1, 2],))], timeout_s=120)
    dies = gloo_ranks.start(hybrid_ranks.rank_dies, 3, 10.0, timeout_s=10.0)
    got = {"two": two.results(), "four": four.results(),
           "dies": dies.results(ranks=[0, 2])}
    got["dies_alive"] = dies.alive()
    return got


def test_the_reference_worker_checks(worlds):
    r0, r1 = worlds["two"]
    for rank, r in enumerate(worlds["two"]):
        np.testing.assert_array_equal(r["all_reduce"], np.full(4, 3.0))
        np.testing.assert_array_equal(r["all_reduce_max"], np.full(3, 2.0))
        np.testing.assert_array_equal(r["broadcast"], np.full(4, 8.0))
        np.testing.assert_array_equal(r["all_gather"][0], np.zeros(2))
        np.testing.assert_array_equal(r["all_gather"][1], np.ones(2))
        np.testing.assert_array_equal(
            r["reduce_scatter"], np.full(3, 3.0 if rank == 0 else 21.0))
        np.testing.assert_array_equal(r["all_to_all"][0],
                                      np.full(2, float(rank)))
        np.testing.assert_array_equal(r["all_to_all"][1],
                                      np.full(2, float(10 + rank)))
        np.testing.assert_array_equal(
            r["scatter"], np.full(2, 5.0 if rank == 0 else 9.0))
    np.testing.assert_array_equal(r1["recv"], np.arange(4.0))


def test_object_collectives_alltoall_single_and_shift(worlds):
    for rank, r in enumerate(worlds["two"]):
        assert r["all_gather_object"] == [{"rank": 0}, {"rank": 1}]
        assert r["broadcast_object_list"] == [3, "x"]
        assert r["scatter_object_list"] == [[["a"], ["b"]][rank]]
        np.testing.assert_array_equal(
            r["alltoall_single"],
            np.array([0.0, 1.0, 10.0, 11.0]) + 2 * rank)
        np.testing.assert_array_equal(r["shift"],
                                      np.full(2, float(1 - rank)))
        assert r["backend"] == "gloo"


@pytest.mark.parametrize("axis", ["dp", "mp"])
def test_each_collective_over_a_mesh_axis(worlds, axis):
    data = np.random.RandomState(SEED).randn(4, 6).astype(np.float32)
    for rank, res in enumerate(worlds["four"]):
        r = res[0][axis]
        ranks = r["ranks"]
        assert rank in ranks and len(ranks) == 2
        rows = data[ranks]
        me = ranks.index(rank)
        np.testing.assert_allclose(r["sum"], rows.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(r["max"], rows.max(0))
        np.testing.assert_allclose(r["avg"], rows.mean(0), rtol=1e-6)
        # bf16 inputs summed in f32 and rounded once
        bf = torch.from_numpy(rows).bfloat16().float().sum(0).bfloat16()
        np.testing.assert_array_equal(r["sum_bf16"], bf.float().numpy())
        for i in range(2):
            np.testing.assert_array_equal(r["gather"][i], rows[i])
        halves = rows.reshape(2, 2, 3)
        np.testing.assert_allclose(r["reduce_scatter"],
                                   halves.sum(0)[me], rtol=1e-6)
        for j in range(2):
            np.testing.assert_array_equal(r["all_to_all"][j],
                                          halves[j][me])
        np.testing.assert_array_equal(r["broadcast"], rows[1])
        np.testing.assert_array_equal(r["shift"], rows[1 - me])
        # all-gather forward / reduce-scatter backward: y is the two rows
        # stacked, the loss sum(y * w) with w = 1..12; each member's
        # gradient is its row of w, summed over the two members
        w = np.arange(1.0, 13.0).reshape(2, 6)
        np.testing.assert_allclose(r["ag_grad"], 2 * w[me], rtol=1e-6)
        # reduce-scatter forward / all-gather backward: y = the sum of my
        # half; loss sum(y^2): d/dx = 2 y at my half, 2 y' at the other
        s = rows.reshape(2, 2, 3).sum(0)
        np.testing.assert_allclose(r["rs_val"], s[me], rtol=1e-6)
        np.testing.assert_allclose(r["rs_grad"], 2 * s.reshape(-1),
                                   rtol=1e-6)


@pytest.mark.parametrize("which,dims,want", [
    (1, [2, 1, 1, 1, 2], {"dp": [[0, 2], [1, 3]], "mp": [[0, 1], [2, 3]]}),
    (2, [1, 1, 2, 1, 2],
     {"sharding": [[0, 2], [1, 3]], "mp": [[0, 1], [2, 3]]})])
def test_the_hybrid_groups_reduce_over_their_ranks(worlds, which, dims,
                                                   want):
    for rank, res in enumerate(worlds["four"]):
        got = res[which]
        for axis, lists in want.items():
            ranks, total = got[axis]
            mine = [g for g in lists if rank in g][0]
            assert ranks == mine
            assert total == float(sum(mine))


def test_a_dead_rank_fails_the_others_within_the_timeout(worlds):
    for r in worlds["dies"]:
        assert r["error"] is not None
        assert r["seconds"] < 10.0
    assert worlds["dies_alive"] == []
