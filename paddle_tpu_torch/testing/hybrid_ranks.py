"""Rank bodies of the hybrid-parallel tests: each runs in a process of a
gloo world started by :func:`paddle_tpu_torch.testing.gloo_ranks.run`
and imports only the port.

:func:`train_cases` trains each case's model with
:class:`~paddle_tpu_torch.distributed.ParallelTrainStep` (or the one-rank
``TrainStep``) from the global weights it is given and returns the
losses, this rank's shards with their layouts (the caller assembles the
global view with ``Layout.assemble``) and the slot shapes. The models
are the JAX package's test models rebuilt on the port (the same layer
names, so a JAX state dict loads as it is) and the tiny Llama (a JAX
state dict goes through ``models.convert.llama_state_from_jax``).
"""
from __future__ import annotations

import os
import time
import traceback
from typing import Dict, List

import numpy as np
import torch

__all__ = ["build_model", "train_cases", "collectives", "data_parallel",
           "sequence_parallel", "rank_dies", "topology_groups", "mp_layers",
           "several"]


def _cpu():
    import paddle_tpu_torch as paddle

    paddle.set_device("cpu")
    return paddle


def build_model(kind: str, spec: dict):
    """A port model of ``kind`` from ``spec`` (its sizes), with the
    JAX package's layer names."""
    paddle = _cpu()
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet

    if kind == "llama":
        from paddle_tpu_torch.models.llama import (LlamaConfig,
                                                   LlamaForCausalLM)

        return LlamaForCausalLM(LlamaConfig(**spec), device="cpu")
    if kind == "tp_mlp":
        class MLP(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc1 = fleet.ColumnParallelLinear(16, 32,
                                                      gather_output=False)
                self.act = nn.GELU()
                self.fc2 = fleet.RowParallelLinear(32, 16,
                                                   input_is_parallel=True)

            def forward(self, x):
                return self.fc2(self.act(self.fc1(x)))

        return MLP()
    if kind == "tinylm":
        class TinyLM(nn.Layer):
            def __init__(self):
                super().__init__()
                self.emb = fleet.VocabParallelEmbedding(64, 16)
                self.proj = fleet.ColumnParallelLinear(16, 64,
                                                       gather_output=False)

            def forward(self, x):
                return self.proj(self.emb(x))

        return TinyLM()
    if kind == "seq_mlp":
        d, h = spec.get("d", 16), spec.get("h", 32)
        return nn.Sequential(nn.Linear(d, h), nn.Tanh(), nn.Linear(h, d))
    if kind in ("bn", "syncbn"):
        bn = nn.BatchNorm1D(16) if kind == "bn" else nn.SyncBatchNorm(16)
        return nn.Sequential(nn.Linear(8, 16), bn, nn.Linear(16, 8))
    if kind == "dropout":
        return nn.Sequential(nn.Linear(16, 32), nn.Dropout(spec["p"]),
                             nn.Linear(32, 16))
    if kind == "sp_pair":
        from paddle_tpu_torch.distributed.fleet.utils import (
            ColumnSequenceParallelLinear, RowSequenceParallelLinear,
            ScatterOp)

        class Net(nn.Layer):
            def __init__(self):
                super().__init__()
                self.col = ColumnSequenceParallelLinear(
                    spec["d"], spec["m"], has_bias=True, seq_axis=0)
                self.row = RowSequenceParallelLinear(
                    spec["m"], spec["d"], has_bias=True, seq_axis=0)

            def forward(self, x):
                h = ScatterOp.apply(x, axis=0)
                h = paddle.nn.functional.relu(self.col(h))
                return self.row(h)

        return Net()
    raise ValueError(kind)


def _load(model, kind: str, state: Dict[str, np.ndarray]):
    if kind == "llama":
        from paddle_tpu_torch.models.convert import llama_state_from_jax

        model.load_state_dict(llama_state_from_jax(state))
    else:
        model.set_state_dict({k: np.asarray(v) for k, v in state.items()})


def _params(model):
    """(name, torch tensor) of every parameter."""
    return [(n, p if isinstance(p, torch.Tensor) else p._data)
            for n, p in model.named_parameters()]


def _loss_fn(case):
    from paddle_tpu_torch import nn, ops
    from paddle_tpu_torch.distributed import fleet

    kind = case.get("loss", "mse")
    if kind == "llama":
        from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion

        return LlamaPretrainingCriterion(None)
    if kind == "mse":
        return nn.MSELoss()
    if kind == "mse_sum":
        return nn.MSELoss(reduction="sum")
    if kind == "pce":
        ce = fleet.ParallelCrossEntropy()
        return lambda logits, labels: ops.mean(ce(logits, labels))
    raise ValueError(kind)


def _optimizer(case, params):
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    kw = dict(case.get("opt_kw", {}))
    if case.get("clip") is not None:
        kw["grad_clip"] = ClipGradByGlobalNorm(case["clip"])
    cls = {"adamw": opt.AdamW, "adam": opt.Adam, "sgd": opt.SGD,
           "lamb": opt.Lamb}[case.get("opt", "adamw")]
    return cls(parameters=params, **kw)


def _run_case(rank: int, case: dict) -> dict:
    paddle = _cpu()
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed import (ParallelConfig,
                                              ParallelTrainStep,
                                              ProcessMesh)
    from paddle_tpu_torch.jit import TrainStep

    paddle.seed(case.get("seed", 0))
    model = build_model(case["model"], case.get("spec", {}))
    _load(model, case["model"], case["state"])
    optim = _optimizer(case, model.parameters())
    scaler = GradScaler(**case["scaler"]) if case.get("scaler") else None
    loss_fn = _loss_fn(case)
    shape = case.get("mesh")

    def make_step(optim):
        if shape is None:
            return TrainStep(model, loss_fn, optim, scaler=scaler,
                             skip_nonfinite=case.get("skip_nonfinite",
                                                     False))
        mesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                           case["dims"])
        return ParallelTrainStep(
            model, loss_fn, optim, mesh,
            ParallelConfig(**case.get("config", {})), scaler=scaler,
            skip_nonfinite=case.get("skip_nonfinite", False))

    step = make_step(optim)
    out: dict = {"losses": []}
    snapshot = {}
    for i, (x, y) in enumerate(case["batches"]):
        # a restart: a new optimizer and step over the trained model
        if case.get("restart_at") == i:
            optim = _optimizer(case, model.parameters())
            step = make_step(optim)
        if case.get("snapshot_before") == i:
            snapshot = {n: {k: v.clone().numpy() for k, v in
                            optim._slots[id(t)].items()}
                        for n, t in _params(model)}
            snapshot["__params__"] = {n: t.detach().clone().numpy()
                                      for n, t in _params(model)}
        loss = step(torch.from_numpy(np.asarray(x)),
                    torch.from_numpy(np.asarray(y)))
        out["losses"].append(float(loss))
        if case.get("snapshot_before") == i:
            out["skip_kept"] = all(
                np.array_equal(snapshot["__params__"][n],
                               t.detach().numpy()) and all(
                    np.array_equal(snapshot[n][k], v.numpy())
                    for k, v in optim._slots[id(t)].items())
                for n, t in _params(model))
    out["shards"] = {n: t.detach().clone().numpy()
                     for n, t in _params(model)}
    if shape is not None:
        out["layouts"] = {n: lay.to_meta()
                          for n, lay in step.layouts().items()}
        out["slot_bytes"] = step.slot_bytes()
    out["slot_shapes"] = {n: {k: tuple(v.shape) for k, v in
                              optim._slots[id(t)].items()}
                          for n, t in _params(model)}
    if case.get("skip_nonfinite"):
        out["skipped_steps"] = step.skipped_steps
    return out


def train_cases(rank: int, world: int, cases: List[dict]) -> dict:
    """Each case on the ranks of its mesh (all ranks for a one-rank
    case): ``{name: result}``; a case that failed gives its traceback
    under ``"error"`` and ends the run on this rank."""
    torch.set_num_threads(1)
    results = {}
    for case in cases:
        shape = case.get("mesh")
        if shape is not None and rank >= int(np.prod(shape)):
            continue
        t0 = time.perf_counter()
        try:
            results[case["name"]] = _run_case(rank, case)
        except Exception:
            results[case["name"]] = {"error": traceback.format_exc()}
            break
        results[case["name"]]["seconds"] = time.perf_counter() - t0
    return results


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def collectives(rank: int, world: int, seed: int) -> dict:
    """The reference's ``collectives_worker.py`` checks at world 2 (on
    the world group), then each collective over the dp and the mp group
    of a 2 x 2 mesh at world 4. Returns what each produced (numpy), for
    the caller to hold against numpy."""
    paddle = _cpu()
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import communication as comm

    out: dict = {}
    if world == 2:
        t = paddle.to_tensor(np.full((4,), float(rank + 1), np.float32))
        dist.all_reduce(t)
        out["all_reduce"] = t.numpy()
        t = paddle.to_tensor(np.full((3,), float(rank + 1), np.float32))
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        out["all_reduce_max"] = t.numpy()
        t = paddle.to_tensor(np.full((4,), float(rank * 7 + 1), np.float32))
        dist.broadcast(t, src=1)
        out["broadcast"] = t.numpy()
        lst = []
        dist.all_gather(lst, paddle.to_tensor(
            np.full((2,), float(rank), np.float32)))
        out["all_gather"] = [x.numpy() for x in lst]
        src = paddle.to_tensor(np.stack([
            np.full((3,), float(rank + 1), np.float32),
            np.full((3,), float(rank + 10), np.float32)]))
        dst = paddle.zeros([3])
        dist.reduce_scatter(dst, src)
        out["reduce_scatter"] = dst.numpy()
        ins = [paddle.to_tensor(np.full((2,), float(rank * 10 + j),
                                        np.float32)) for j in range(2)]
        outs = []
        dist.all_to_all(outs, ins)
        out["all_to_all"] = [x.numpy() for x in outs]
        parts = [paddle.to_tensor(np.full((2,), 5.0, np.float32)),
                 paddle.to_tensor(np.full((2,), 9.0, np.float32))] \
            if rank == 0 else None
        t = paddle.zeros([2])
        dist.scatter(t, parts, src=0)
        out["scatter"] = t.numpy()
        if rank == 0:
            dist.send(paddle.to_tensor(np.arange(4, dtype=np.float32)),
                      dst=1)
        else:
            r = paddle.zeros([4])
            dist.recv(r, src=0)
            out["recv"] = r.numpy()
        dist.barrier()
        objs = []
        dist.all_gather_object(objs, {"rank": rank})
        out["all_gather_object"] = objs
        bl = [rank * 3, "x"]
        dist.broadcast_object_list(bl, src=1)
        out["broadcast_object_list"] = bl
        so = []
        dist.scatter_object_list(so, [["a"], ["b"]] if rank == 0 else None,
                                 src=0)
        out["scatter_object_list"] = so
        single = dist.alltoall_single(None, torch.arange(4.0) + 10 * rank)
        out["alltoall_single"] = single.numpy()
        out["shift"] = comm.shift(torch.full((2,), float(rank)),
                                  comm.get_group(0)).numpy()
        out["backend"] = dist.get_backend()
        return out
    # world 4: a 2 x 2 mesh, each collective over its dp and mp groups
    mesh = dist.ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"])
    rng = np.random.RandomState(seed)
    data = rng.randn(4, 6).astype(np.float32)   # row r is rank r's
    mine = torch.from_numpy(data[rank].copy())
    for axis in ("dp", "mp"):
        g = mesh.group(axis)
        res = {"ranks": g.ranks}
        t = mine.clone()
        comm.all_reduce_(t, comm.ReduceOp.SUM, g)
        res["sum"] = t.numpy()
        t = mine.clone()
        comm.all_reduce_(t, comm.ReduceOp.MAX, g)
        res["max"] = t.numpy()
        t = mine.clone()
        comm.all_reduce_(t, comm.ReduceOp.AVG, g)
        res["avg"] = t.numpy()
        t = mine.to(torch.bfloat16)
        comm.all_reduce_(t, comm.ReduceOp.SUM, g)
        res["sum_bf16"] = t.float().numpy()
        res["gather"] = [x.numpy() for x in comm.all_gather_list(mine, g)]
        res["reduce_scatter"] = comm.reduce_scatter_list(
            list(mine.chunk(2)), comm.ReduceOp.SUM, g).numpy()
        res["all_to_all"] = [x.numpy() for x in
                             comm.all_to_all_list(list(mine.chunk(2)), g)]
        t = mine.clone()
        comm.broadcast_(t, g.ranks[1], g)
        res["broadcast"] = t.numpy()
        res["shift"] = comm.shift(mine, g).numpy()
        # the differentiable pairs: value and gradient
        x = mine.clone().requires_grad_(True)
        y = comm.all_gather_along(x[None], g, 0)
        (y * torch.arange(1.0, 1.0 + y.numel()).view(y.shape)).sum() \
            .backward()
        res["ag_grad"] = x.grad.numpy()
        x = mine.clone().requires_grad_(True)
        y = comm.reduce_scatter_along(x, g, 0)
        (y * y).sum().backward()
        res["rs_val"] = y.detach().numpy()
        res["rs_grad"] = x.grad.numpy()
        out[axis] = res
    return out


def rank_dies(rank: int, world: int, timeout_s: float) -> dict:
    """Rank 1 is killed (SIGKILL) once its all-reduce is under way; the
    others must fail the collective within the group's timeout. Returns
    (on the survivors) the error's type and the seconds it took."""
    import signal

    import torch.distributed as dist

    from paddle_tpu_torch.distributed import communication as comm

    if rank == 1:
        dist.all_reduce(torch.ones(1 << 20), async_op=True)
        os.kill(os.getpid(), signal.SIGKILL)
    t0 = time.perf_counter()
    try:
        comm.all_reduce_(torch.ones(4), comm.ReduceOp.SUM,
                         comm.get_group(0))
    except Exception as e:   # the collective's failure is the result
        return {"error": type(e).__name__,
                "seconds": time.perf_counter() - t0}
    return {"error": None, "seconds": time.perf_counter() - t0}


def topology_groups(rank: int, world: int, dims) -> dict:
    """The hybrid group's ranks of each axis for ``dims`` (data, pipe,
    sharding, sep, model) over the world, as this rank sees them, and
    one all-reduce over each group."""
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.distributed.topology import (
        CommunicateTopology, HybridCommunicateGroup)

    hcg = HybridCommunicateGroup(CommunicateTopology(dims=dims))
    out = {}
    for name, g in (("dp", hcg.get_data_parallel_group()),
                    ("mp", hcg.get_model_parallel_group()),
                    ("pp", hcg.get_pipe_parallel_group()),
                    ("sharding", hcg.get_sharding_parallel_group())):
        t = torch.full((1,), float(rank))
        comm.all_reduce_(t, comm.ReduceOp.SUM, g)
        out[name] = (g.ranks, float(t[0]))
    return out


# ---------------------------------------------------------------------------
# DataParallel
# ---------------------------------------------------------------------------
def data_parallel(rank: int, world: int, state: dict, X, Y) -> dict:
    """The reference's ``eager_dp_worker.py``: a DataParallel MLP on this
    rank's half of the batch (rank 1 starts desynchronised, the wrap-time
    broadcast aligns it), four SGD steps; then ``no_sync`` accumulation;
    then ``fused_allreduce_gradients`` and ``broadcast_dp_parameters``
    through the hybrid group. Returns what the checks read."""
    paddle = _cpu()
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed.fleet.utils import (
        broadcast_dp_parameters, fused_allreduce_gradients)

    def make():
        m = nn.Sequential(nn.Linear(8, 32), nn.ReLU(), nn.Linear(32, 1))
        m.set_state_dict({k: np.asarray(v) for k, v in state.items()})
        return m

    out = {}
    model = make()
    if rank == 1:
        for p in model.parameters():
            p.set_value(p.numpy() + 1.0)
    dp = dist.DataParallel(model)
    opt = optimizer.SGD(learning_rate=0.1, parameters=dp.parameters())
    loss_fn = nn.MSELoss()
    half = X.shape[0] // world
    xs = paddle.to_tensor(X[rank * half:(rank + 1) * half])
    ys = paddle.to_tensor(Y[rank * half:(rank + 1) * half])
    losses = []
    for _ in range(4):
        loss = loss_fn(dp(xs), ys)
        loss.backward()
        opt.step()
        opt.clear_grad()
        lt = paddle.to_tensor(np.float32(loss.item()))
        dist.all_reduce(lt, op=dist.ReduceOp.AVG)
        losses.append(float(lt.numpy()))
    out["dp_losses"] = losses
    out["params"] = {n: p.numpy() for n, p in model.named_parameters()}
    with dp.no_sync():
        loss_fn(dp(xs), ys).backward()
    g_local = model[0].weight.grad.numpy().copy()
    loss_fn(dp(xs), ys).backward()
    out["g_synced"] = model[0].weight.grad.numpy().copy()
    gathered = []
    dist.all_gather(gathered, paddle.to_tensor(g_local))
    out["g_local_sum"] = sum(g.numpy() for g in gathered)
    opt.clear_grad()
    # fused_allreduce_gradients / broadcast_dp_parameters over the hcg
    strategy = dist.fleet.DistributedStrategy()
    strategy.hybrid_configs["dp_degree"] = world
    dist.fleet.init(is_collective=True, strategy=strategy)
    hcg = dist.fleet.get_hybrid_communicate_group()
    plain = make()
    for p in plain.parameters():
        p.set_value(p.numpy() * (rank + 1))
    broadcast_dp_parameters(plain, hcg)
    out["broadcast"] = {n: p.numpy() for n, p in plain.named_parameters()}
    loss_fn(plain(xs), ys).backward()
    out["local_grads"] = {n: p.grad.numpy().copy()
                          for n, p in plain.named_parameters()}
    fused_allreduce_gradients(list(plain.parameters()), hcg)
    out["fused_grads"] = {n: p.grad.numpy()
                          for n, p in plain.named_parameters()}
    return out


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------
def sequence_parallel(rank: int, world: int, state: dict, x) -> dict:
    """The SP linear pair (ScatterOp, column, relu, row) under a 2 x 2
    mesh's current mesh: this rank's output slice of the sequence, and
    the ops' identity without a mesh."""
    _cpu()
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.distributed.engine import (set_current_mesh,
                                                     shard_model_parameters)
    from paddle_tpu_torch.distributed.fleet.utils import (
        AllGatherOp, GatherOp, ReduceScatterOp, ScatterOp)

    xt = Tensor(np.asarray(x))
    ident = [np.array_equal(op.apply(xt, axis=1).numpy(), np.asarray(x))
             for op in (ScatterOp, GatherOp, AllGatherOp, ReduceScatterOp)]
    net = build_model("sp_pair", {"d": state["col.weight"].shape[0],
                                  "m": state["col.weight"].shape[1]})
    _load(net, "sp_pair", state)
    mesh = ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"])
    shard_model_parameters(net, mesh)
    set_current_mesh(mesh)
    try:
        out = net(xt).numpy()
    finally:
        set_current_mesh(None)
    return {"identity": ident, "out": out,
            "mp_rank": mesh.coord(rank)[1]}


# ---------------------------------------------------------------------------
# the tensor-parallel layers at degree k
# ---------------------------------------------------------------------------
def mp_layers(rank: int, world: int, weights: dict, x, ids, labels) -> dict:
    """Each tensor-parallel layer built whole from ``weights``, cut to
    this rank's shard by ``shard_model_parameters`` over an ``"mp"`` mesh
    of the world, run forward and backward: the outputs, the input's
    gradient and this rank's weight-shard gradients (the caller holds
    them against the unsharded computation)."""
    paddle = _cpu()
    from paddle_tpu_torch import nn, ops
    from paddle_tpu_torch.distributed import ProcessMesh, fleet
    from paddle_tpu_torch.distributed.engine import shard_model_parameters

    mesh = ProcessMesh(np.arange(world), ["mp"])

    def run(layer, state, inp, fwd):
        holder = nn.Sequential(layer)
        holder.set_state_dict({f"0.{k}": v for k, v in state.items()})
        shard_model_parameters(holder, mesh)
        xin = paddle.to_tensor(inp)
        if np.asarray(inp).dtype.kind == "f":
            xin.stop_gradient = False
        out = fwd(layer, xin)
        ops.sum(out * out).backward()
        grads = {n: p.grad.numpy() for n, p in layer.named_parameters()}
        return {"out": out.numpy(), "grads": grads,
                "x_grad": None if xin.grad is None else xin.grad.numpy()}

    res = {}
    for gather in (False, True):
        res[f"column_gather{int(gather)}"] = run(
            fleet.ColumnParallelLinear(8, 12, gather_output=gather),
            weights["column"], x, lambda m, t: m(t))
    # a row layer takes the whole input, or (input_is_parallel) this
    # rank's slice of its last dim
    res["row_parallel0"] = run(
        fleet.RowParallelLinear(8, 6, input_is_parallel=False),
        weights["row8"], x, lambda m, t: m(t))
    res["row_parallel1"] = run(
        fleet.RowParallelLinear(12, 6, input_is_parallel=True),
        weights["row12"], np.ascontiguousarray(
            np.split(weights["row_in"], world, axis=-1)[rank]),
        lambda m, t: m(t))
    res["vocab_embedding"] = run(
        fleet.VocabParallelEmbedding(16, 6), weights["embedding"], ids,
        lambda m, t: m(t))
    # the vocab-parallel cross entropy over this rank's logits shard
    logits = np.ascontiguousarray(
        np.split(weights["logits"], world, axis=-1)[rank])
    lt = paddle.to_tensor(logits)
    lt.stop_gradient = False
    ce = fleet.ParallelCrossEntropy(mp_group=mesh.group("mp"))
    loss = ce(lt, paddle.to_tensor(labels))
    ops.sum(loss).backward()
    res["cross_entropy"] = {"out": loss.numpy(), "x_grad": lt.grad.numpy()}
    return res


def several(rank: int, world: int, jobs) -> list:
    """Run each ``(body name, args)`` of ``jobs`` in turn in this world
    (one spawn for a test file's bodies)."""
    return [globals()[name](rank, world, *args) for name, args in jobs]
