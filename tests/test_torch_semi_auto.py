"""The port's semi-auto parallel API (``shard_tensor``, ``reshard``,
``dtensor_from_local``, ``shard_optimizer`` with ShardingStage1/3,
``shard_dataloader``, ``to_static`` / ``DistModel``, eager placement
propagation) against the JAX package's, on a 2 x 2 ``["dp", "mp"]``
mesh.

The JAX side runs in this process on conftest's virtual devices over a
2 x 2 mesh; the port's side on 4 gloo ranks
(``paddle_tpu_torch.testing.semi_auto_ranks``), one process a rank, each
holding its shard of a DistTensor (a DTensor). Each case of the JAX
package's ``tests/test_semi_auto.py`` is here: values equal the JAX
package's global views (optimizer results at rtol 1e-5, DistModel
losses against the JAX ``TrainStep`` at rtol 5e-4), and placements equal
the JAX package's after every eager op."""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn, optimizer
from paddle_tpu.distributed.mesh import ProcessMesh, Replicate, Shard


def _mesh():
    return ProcessMesh(np.arange(4).reshape(2, 2), dim_names=["dp", "mp"])


def _state(m):
    return {k: np.asarray(v.numpy()).copy()
            for k, v in m.state_dict().items()}


def _jax_opt_case(mode, state, x):
    paddle.seed(0)
    m = nn.Linear(8, 16)
    m.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    mesh = _mesh()
    w = m.parameters()[0]
    if mode == "default":
        d = jdist.shard_tensor(w, mesh, [Shard(0), Replicate()])
        w._data = d._data
    opt = optimizer.AdamW(learning_rate=0.01, parameters=m.parameters())
    fn = {"stage1": lambda: jdist.ShardingStage1("dp", mesh),
          "stage3": lambda: jdist.ShardingStage3("dp", mesh),
          "default": lambda: None}[mode]()
    opt = jdist.shard_optimizer(opt, fn)
    loss = (m(paddle.to_tensor(x)) ** 2).mean()
    loss.backward()
    opt.step()
    w = m.parameters()[0]
    m1 = opt._slots[id(w)]["moment1"]
    return {"loss": float(loss.item()), "w": np.asarray(w.numpy()),
            "b": np.asarray(m.parameters()[1].numpy()),
            "moment1": np.asarray(m1),
            "moment1_shard": tuple(m1.addressable_shards[0].data.shape)}


def _jax_propagation():
    mesh = _mesh()
    x = jdist.shard_tensor(paddle.ones([8, 16]), mesh, [Shard(0), Shard(1)])
    w = jdist.shard_tensor(paddle.ones([16, 4]), mesh,
                           [Replicate(), Shard(0)])
    xr = jdist.shard_tensor(paddle.ones([8, 16]), mesh,
                            [Shard(0), Replicate()])
    c = (x * 2.0 + 1.0).sum(axis=1)
    vals = {"add": x + x, "chain": (x * 2.0 + 1.0) / 2.0,
            "matmul": paddle.matmul(x, w), "sum": x.sum(axis=1),
            "transpose": x.transpose([1, 0]),
            "reshape": x.reshape([8, 4, 4]),
            "mixed": xr + paddle.ones([8, 16]), "computed": c,
            "reshard": jdist.reshard(c, mesh, [Replicate(), Replicate()])}
    return {k: {"placements": [repr(p) for p in v.placements],
                "value": np.asarray(v.numpy())} for k, v in vals.items()}


@pytest.fixture(scope="module")
def runs():
    from paddle_tpu_torch.testing import gloo_ranks, semi_auto_ranks

    paddle.seed(0)
    lin = nn.Linear(8, 16)
    x = np.asarray(paddle.randn([4, 8]).numpy())
    paddle.seed(5)
    dml = nn.Linear(8, 4)
    inputs = {"linear": _state(lin), "x": x, "distmodel": _state(dml),
              "dm_x": np.random.RandomState(0).randn(8, 8).astype(
                  np.float32),
              "dm_y": np.random.RandomState(1).randn(8, 4).astype(
                  np.float32)}
    world = gloo_ranks.start(semi_auto_ranks.semi_auto, 4, inputs,
                             timeout_s=240)
    ref = {mode: _jax_opt_case(mode, inputs["linear"], x)
           for mode in ("stage1", "stage3", "default")}
    opt = optimizer.AdamW(learning_rate=0.01, parameters=dml.parameters())
    step = paddle.jit.TrainStep(dml, nn.MSELoss(), opt)
    ref["distmodel_losses"] = [
        float(step(paddle.to_tensor(inputs["dm_x"]),
                   paddle.to_tensor(inputs["dm_y"])).item())
        for _ in range(4)]
    ref["propagation"] = _jax_propagation()
    return inputs, ref, world.results()


@pytest.mark.parametrize("mode", ["stage1", "stage3", "default"])
def test_shard_optimizer_matches_the_jax_step(runs, mode):
    """One AdamW step under shard_optimizer: the weights and the first
    moment equal the JAX package's on every rank."""
    _, ref, res = runs
    for r in range(4):
        got = res[r][mode]
        np.testing.assert_allclose(got["loss"], ref[mode]["loss"],
                                   rtol=1e-5)
        for k in ("w", "b", "moment1"):
            np.testing.assert_allclose(got[k], ref[mode][k], rtol=1e-5,
                                       atol=1e-7, err_msg=(mode, k, r))


def test_shard_optimizer_stage1_places_slots(runs):
    """ShardingStage1: each rank's moment holds 1/2 of the elements
    (dim 0 over dp, the JAX slot's shard), and only their bytes: its
    block keeps no whole slot's storage alive. The parameter stays as the
    user placed it (whole)."""
    _, ref, res = runs
    for r in range(4):
        got = res[r]["stage1"]
        assert got["moment1_local"] == (4, 16) == \
            ref["stage1"]["moment1_shard"]
        assert got["moment1_storage_bytes"] == 4 * 16 * 4
        assert got["moment1_placements"][0].startswith("Shard(dim=0)")
        assert got["w_local"] == (8, 16) and got["w_placements"] is None


def test_shard_optimizer_stage3_shards_params(runs):
    _, ref, res = runs
    for r in range(4):
        got = res[r]["stage3"]
        assert got["w_local"] == (4, 16)
        assert got["w_storage_bytes"] == got["moment1_storage_bytes"] \
            == 4 * 16 * 4
        assert got["w_placements"] == ["Shard(dim=0)", "Replicate()"]
        assert got["moment1_local"] == (4, 16) == \
            ref["stage3"]["moment1_shard"]


def test_shard_optimizer_default_follows_param_placement(runs):
    _, ref, res = runs
    for r in range(4):
        got = res[r]["default"]
        assert got["moment1_placements"] == ["Shard(dim=0)", "Replicate()"]
        assert got["moment1_local"] == got["w_local"] == (4, 16)


def test_shard_dataloader_places_batches(runs):
    _, _, res = runs
    X = np.arange(64, dtype=np.float32).reshape(16, 4)
    for r in range(4):
        got = res[r]["dataloader"]
        assert got["len"] == got["loader_len"] == 2
        dp = r // 2
        for i, b in enumerate(got["batches"]):
            assert b["mesh_is"]
            assert b["placements"] == ["Shard(dim=0)", "Replicate()"]
            np.testing.assert_array_equal(b["global"], X[8 * i:8 * i + 8])
            np.testing.assert_array_equal(
                b["local"], X[8 * i + 4 * dp:8 * i + 4 * dp + 4])


def test_to_static_distmodel_matches_trainstep(runs):
    _, ref, res = runs
    for r in range(4):
        np.testing.assert_allclose(res[r]["distmodel_losses"],
                                   ref["distmodel_losses"], rtol=5e-4,
                                   atol=1e-6)


def test_distmodel_eval_and_predict_modes(runs):
    _, _, res = runs
    for r in range(4):
        got = res[r]["distmodel_modes"]
        assert got["eval_shape"] == []
        assert got["predict_shape"] == [4, 4]


def test_dtensor_from_local_assembles_each_ranks_block(runs):
    """Each rank contributes a distinct (2, 4) block; the global view is
    the four blocks in rank order, and each rank's local block is its
    own (the JAX package's single-process identity, one block a rank)."""
    _, _, res = runs
    blocks = [np.arange(8, dtype=np.float32).reshape(2, 4) + 100 * r
              for r in range(4)]
    for r in range(4):
        got = res[r]["from_local"]
        assert got["shape"] == [8, 4]
        np.testing.assert_array_equal(got["global"], np.concatenate(blocks))
        np.testing.assert_array_equal(got["local"], blocks[r])


def test_dtensor_from_local_distinct_blocks_gather(runs):
    """unshard_dtensor gathers the ranks' distinct blocks onto every
    rank (replicated)."""
    _, _, res = runs
    full = np.concatenate([np.arange(8, dtype=np.float32).reshape(2, 4)
                           + 100 * r for r in range(4)])
    for r in range(4):
        got = res[r]["unshard"]
        assert got["placements"] == ["Replicate()"]
        np.testing.assert_array_equal(got["local"], full)


def test_dtensor_from_local_rejects_bad_shape(runs):
    _, _, res = runs
    for r in range(4):
        assert "differ in shape" in res[r]["bad_shape"]
        assert "cannot Shard" in res[r]["indivisible"]


@pytest.mark.parametrize("name", ["add", "chain", "matmul", "sum",
                                  "transpose", "reshape", "mixed",
                                  "computed", "reshard"])
def test_eager_placements_and_values_equal_the_jax_package(runs, name):
    """After each eager op the output is a DistTensor on the same mesh
    with the JAX package's placements and values."""
    _, ref, res = runs
    want = ref["propagation"][name]
    for r in range(4):
        got = res[r]["propagation"][name]
        assert got["is_dist"] and got["mesh_is"]
        assert got["placements"] == want["placements"], (name, r)
        np.testing.assert_allclose(got["value"], want["value"], rtol=1e-6)


def test_grad_flow_keeps_values(runs):
    _, _, res = runs
    for r in range(4):
        np.testing.assert_allclose(res[r]["propagation"]["grad"]["value"],
                                   2 * np.ones((8, 16)))


@pytest.mark.parametrize("path", ["trainstep", "parallel"])
def test_slot_seam_holds_in_the_step_paths(runs, path):
    """``shard_optimizer``'s slot placement reaches the slots a
    ``TrainStep`` and a ``ParallelTrainStep`` make: each rank holds 1/2
    of the first moment, and the losses are the JAX ``TrainStep``'s
    (ZeRO-1 changes no number; the JAX package's own ``TrainStep`` does
    not run with a ShardingStage1 slot on this jax: its jitted step
    gets the slot on the mesh's four devices and its carry on one)."""
    _, ref, res = runs
    for r in range(4):
        got = res[r]["seam_" + path]
        assert got["moment1_local"] == (4, 4)
        assert got["moment1_storage_bytes"] == 4 * 4 * 4
        np.testing.assert_allclose(got["losses"],
                                   ref["distmodel_losses"][:3], rtol=5e-4,
                                   atol=1e-6)
