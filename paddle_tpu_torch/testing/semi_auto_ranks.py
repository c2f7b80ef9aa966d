"""The rank body of the semi-auto API tests: it runs in a process of a
gloo world of 4 (:func:`paddle_tpu_torch.testing.gloo_ranks.start`),
imports only the port, and drives the JAX package's
``tests/test_semi_auto.py`` cases over a 2 x 2 ``["dp", "mp"]`` mesh of
the world. Each case's inputs (the JAX run's initial weights and
batches) come in ``inputs``; it returns the values (global views, as
numpy), the placements and this rank's local shapes."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["semi_auto", "prefetch_mesh"]


def _pl(placements):
    return [repr(p) for p in placements]


def _linear(state):
    from paddle_tpu_torch import nn

    m = nn.Linear(*state["weight"].shape)
    m.set_state_dict({k: np.asarray(v) for k, v in state.items()})
    return m


def _train_one(m, opt, x):
    import paddle_tpu_torch as paddle

    loss = (m(paddle.to_tensor(x)) ** 2).mean()
    loss.backward()
    opt.step()
    return float(loss.numpy())


def _storage_bytes(t) -> int:
    """Bytes of the storage behind a DTensor's local block (or a
    tensor): what the rank really keeps alive."""
    t = t.to_local() if hasattr(t, "to_local") else t
    return t.untyped_storage().nbytes()


def semi_auto(rank: int, world: int, inputs: dict) -> dict:
    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle

    paddle.set_device("cpu")
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import (ProcessMesh, Replicate,
                                              Shard)

    mesh = ProcessMesh(np.arange(4).reshape(2, 2), dim_names=["dp", "mp"])
    out: dict = {}

    # shard_optimizer: ShardingStage1 / 3 and the default
    for name, make in (("stage1", lambda: dist.ShardingStage1("dp", mesh)),
                       ("stage3", lambda: dist.ShardingStage3("dp", mesh)),
                       ("default", None)):
        m = _linear(inputs["linear"])
        w = m.parameters()[0]
        if name == "default":
            d = dist.shard_tensor(w, mesh, [Shard(0), Replicate()])
            w._data = d._data
            w._process_mesh, w._placements = mesh, d.placements
        opt = optimizer.AdamW(learning_rate=0.01,
                              parameters=m.parameters())
        opt = dist.shard_optimizer(opt, make() if make else None)
        w = m.parameters()[0]
        loss = _train_one(m, opt, inputs["x"])
        slots = opt._slots[id(w._data)]
        m1 = slots["moment1"]
        out[name] = {
            "loss": loss,
            "w": w.numpy(), "b": m.parameters()[1].numpy(),
            "moment1": m1.full_tensor().numpy()
            if hasattr(m1, "full_tensor") else m1.numpy(),
            "moment1_local": tuple(m1.to_local().shape)
            if hasattr(m1, "to_local") else tuple(m1.shape),
            "moment1_placements": _pl(getattr(m1, "placements", [])),
            "moment1_storage_bytes": _storage_bytes(m1),
            "w_storage_bytes": _storage_bytes(w._data),
            "w_local": tuple(w._data.to_local().shape)
            if hasattr(w._data, "to_local") else tuple(w._data.shape),
            "w_placements": None if w.placements is None
            else _pl(w.placements)}

    # the slot seam in the compiled step paths: TrainStep, and
    # ParallelTrainStep over the dp axis
    from paddle_tpu_torch.distributed import ParallelTrainStep
    from paddle_tpu_torch.jit import TrainStep

    X2, Y2 = inputs["dm_x"], inputs["dm_y"]
    for name in ("trainstep", "parallel"):
        m = _linear(inputs["distmodel"])
        opt = dist.shard_optimizer(
            optimizer.AdamW(learning_rate=0.01, parameters=m.parameters()),
            dist.ShardingStage1("dp", mesh))
        step = TrainStep(m, nn.MSELoss(), opt) if name == "trainstep" \
            else ParallelTrainStep(m, nn.MSELoss(), opt, mesh)
        losses = [float(step(paddle.to_tensor(X2), paddle.to_tensor(Y2)))
                  for _ in range(3)]
        w = m.parameters()[0]
        m1 = opt._slots[id(w._data)]["moment1"]
        out["seam_" + name] = {"losses": losses,
                               "moment1_local": tuple(m1.to_local().shape),
                               "moment1_storage_bytes": _storage_bytes(m1)}

    # shard_dataloader
    from paddle_tpu_torch.io import DataLoader, TensorDataset

    X = paddle.to_tensor(np.arange(64, dtype=np.float32).reshape(16, 4))
    Y = paddle.to_tensor(np.arange(16, dtype=np.int64))
    loader = DataLoader(TensorDataset([X, Y]), batch_size=8, places="cpu")
    sharded = dist.shard_dataloader(loader, [mesh], shard_dims="dp")
    batches = []
    for xb, yb in sharded:
        batches.append({"placements": _pl(xb.placements),
                        "mesh_is": xb.process_mesh is mesh,
                        "local": xb._data.to_local().numpy(),
                        "global": xb.numpy(), "y": yb.numpy()})
    out["dataloader"] = {"len": len(sharded), "loader_len": len(loader),
                         "batches": batches}

    # to_static / DistModel against the JAX TrainStep
    m = _linear(inputs["distmodel"])
    opt = optimizer.AdamW(learning_rate=0.01, parameters=m.parameters())
    dm = dist.to_static(m, None, nn.MSELoss(), opt, mesh=mesh)
    dm.train()
    X2, Y2 = inputs["dm_x"], inputs["dm_y"]
    out["distmodel_losses"] = [
        float(dm(paddle.to_tensor(X2), paddle.to_tensor(Y2)).numpy())
        for _ in range(4)]
    m = _linear(inputs["distmodel"])
    dm = dist.to_static(m, None, nn.MSELoss(),
                        optimizer.SGD(0.1, parameters=m.parameters()),
                        mesh=mesh)
    dm.eval()
    ev = dm(paddle.to_tensor(X2[:4]), paddle.to_tensor(Y2[:4]))
    dm.predict()
    pr = dm(paddle.to_tensor(X2[:4]))
    out["distmodel_modes"] = {"eval_shape": list(ev.shape),
                              "predict_shape": list(pr.shape),
                              "eval": float(ev.numpy()),
                              "predict": pr.numpy()}

    # dtensor_from_local: each rank its block
    mesh_x = ProcessMesh(np.arange(4), dim_names=["x"])
    local = np.arange(8, dtype=np.float32).reshape(2, 4) + 100 * rank
    d = dist.dtensor_from_local(paddle.to_tensor(local), mesh_x, [Shard(0)])
    out["from_local"] = {"shape": list(d.shape), "global": d.numpy(),
                         "local": dist.dtensor_to_local(d).numpy()}
    g = dist.unshard_dtensor(d)
    out["unshard"] = {"placements": _pl(g.placements),
                      "local": g._data.to_local().numpy()}
    try:
        bad = np.zeros((5 if rank == 0 else 4, 4), np.float32)
        dist.dtensor_from_local(paddle.to_tensor(bad), mesh_x, [Shard(0)])
        out["bad_shape"] = None
    except ValueError as e:
        out["bad_shape"] = str(e)
    try:
        dist.shard_tensor(paddle.ones([5, 4]), mesh, [Shard(0), Replicate()])
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)

    # eager dist-attr propagation
    x = dist.shard_tensor(paddle.ones([8, 16]), mesh, [Shard(0), Shard(1)])
    y = x + x
    z = (x * 2.0 + 1.0) / 2.0
    w = dist.shard_tensor(paddle.ones([16, 4]), mesh, [Replicate(), Shard(0)])
    mm = paddle.matmul(x, w)
    r = x.sum(axis=1)
    t = x.transpose([1, 0])
    rs = x.reshape([8, 4, 4])
    xr = dist.shard_tensor(paddle.ones([8, 16]), mesh,
                           [Shard(0), Replicate()])
    mixed = xr + paddle.ones([8, 16])
    c = (x * 2.0 + 1.0).sum(axis=1)
    rsh = dist.reshard(c, mesh, [Replicate(), Replicate()])
    gx = dist.shard_tensor(paddle.ones([8, 16]), mesh,
                           [Shard(0), Replicate()], stop_gradient=False)
    (gx * gx).sum().backward()
    prop = {}
    for name, v in (("add", y), ("chain", z), ("matmul", mm), ("sum", r),
                    ("transpose", t), ("reshape", rs), ("mixed", mixed),
                    ("computed", c), ("reshard", rsh)):
        prop[name] = {"is_dist": v.is_dist(),
                      "mesh_is": v.process_mesh is mesh,
                      "placements": _pl(v.placements), "value": v.numpy()}
    prop["grad"] = {"value": gx.grad.numpy()}
    out["propagation"] = prop
    return out


def prefetch_mesh(rank: int, world: int, cases: dict, state: dict,
                  xy) -> dict:
    """The JAX package's mesh-placed prefetch cases over a mesh of the
    world (``cases``: name -> (batches, mesh dims, placements as
    ``("shard", d)`` / ``("replicate",)``)): each leaf's placements,
    local block and global value; the transfers a batch. Then a
    ``DataLoader(prefetch_mesh=)`` feeding a dp ``ParallelTrainStep``
    the rank's share (``xy``: the global batch), beside the same step
    fed the global batch."""
    torch.set_num_threads(1)
    import paddle_tpu_torch as paddle

    paddle.set_device("cpu")
    from paddle_tpu_torch.distributed import (ParallelTrainStep,
                                              ProcessMesh, Replicate,
                                              Shard)
    from paddle_tpu_torch.io.prefetch import prefetch_to_device

    def pl(spec):
        return Shard(spec[1]) if spec[0] == "shard" else Replicate()

    out = {}
    for name, (batches, dims, pls) in cases.items():
        mesh = ProcessMesh(np.arange(world), dims)
        pf = prefetch_to_device(batches, depth=1, mesh=mesh,
                                placements=[pl(p) for p in pls],
                                device="cpu")
        got = []
        for b in pf:
            leaves = [b[k] for k in sorted(b)] if isinstance(b, dict) \
            else list(b)
            got.append([{"placements": _pl(t.placements),
                         "local": t._data.to_local().numpy(),
                         "global": t.numpy(),
                         "mesh_is": t.process_mesh is mesh}
                        for t in leaves])
        out[name] = {"batches": got, "transfers": pf.transfers}

    # a DataLoader placing batches over dp, feeding ParallelTrainStep
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.io import DataLoader, TensorDataset

    mesh = ProcessMesh(np.arange(world), ["dp"])
    X, Y = xy
    losses = {}
    for how in ("placed", "global"):
        paddle.seed(0)
        m = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 2))
        m.set_state_dict({k: np.asarray(v) for k, v in state.items()})
        step = ParallelTrainStep(m, nn.MSELoss(), optimizer.SGD(
            0.1, parameters=m.parameters()), mesh)
        loader = DataLoader(TensorDataset([paddle.to_tensor(X),
                                           paddle.to_tensor(Y)]),
                            batch_size=8, places="cpu",
                            use_device_prefetch=how == "placed",
                            prefetch_mesh=mesh if how == "placed" else None,
                            prefetch_placements=[Shard(0)]
                            if how == "placed" else None)
        losses[how] = [float(step(xb, yb)) for xb, yb in loader]
        losses[how + "_params"] = {n: p.numpy() for n, p in
                                   m.named_parameters()}
    out["train"] = losses
    return out
