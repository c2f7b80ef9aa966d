"""Rank bodies of the mixture-of-experts tests: each runs in a process of
a gloo world started by :func:`paddle_tpu_torch.testing.gloo_ranks.run`
and imports only the port.

:func:`train_cases` trains the reference test's ``MoEModel`` (Linear ->
``MoELayer`` -> Linear, rebuilt on the port's layers with the same names,
so a JAX state dict loads through ``models.convert.moe_state_from_jax``)
with :class:`~paddle_tpu_torch.distributed.ParallelTrainStep` (or the
one-rank ``TrainStep``) and returns the losses, this rank's shards with
their layouts, as ``hybrid_ranks.train_cases`` does, and the tokens each
step dropped. :func:`clip_pair` runs ``ClipGradForMOEByGlobalNorm`` on an
ep rank, and :func:`card_pair` the card tests' ep 2 pair.
"""
from __future__ import annotations

import time
import traceback
from typing import List

import numpy as np
import torch

from paddle_tpu_torch import nn, ops
from paddle_tpu_torch.incubate.moe import MoELayer

__all__ = ["Expert", "MoEModel", "moe_loss", "DropWatch", "train_cases",
           "clip_pair", "CARD_PAIR", "card_pair"]


class Expert(nn.Layer):
    """The reference test's expert: Linear(d, h) -> gelu -> Linear(h, d)."""

    def __init__(self, d, h):
        super().__init__()
        self.fc1 = nn.Linear(d, h)
        self.fc2 = nn.Linear(h, d)

    def forward(self, x):
        return self.fc2(ops.gelu(self.fc1(x)))


class MoEModel(nn.Layer):
    """The reference test's ``MoEModel`` on the port's layers (``hidden``
    the experts' width, 2 d by default)."""

    def __init__(self, d=16, n_experts=8, gate="gshard", ep_axis=None,
                 hidden=None, capacity_factor=2.0):
        super().__init__()
        self.inp = nn.Linear(d, d)
        self.moe = MoELayer(
            d, [Expert(d, hidden or 2 * d) for _ in range(n_experts)],
            gate=gate, capacity_factor=capacity_factor, ep_axis=ep_axis)
        self.out = nn.Linear(d, d)

    def forward(self, x):
        return self.out(self.moe(self.inp(x)))


def moe_loss(model, aux_weight: float = 0.01):
    """MSE + ``aux_weight`` x the layer's aux loss (the reference test's
    loss)."""
    mse = nn.MSELoss()

    def loss_fn(out, y):
        return mse(out, y) + aux_weight * model.moe.aux_loss

    return loss_fn


class DropWatch:
    """While open, the choices dropped by each routing call (a token's
    choice that found its expert full), in order: the port's
    ``_top1_dispatch`` / ``_top2_dispatch`` wrapped, put back by
    :meth:`close`."""

    def __init__(self):
        from paddle_tpu_torch.incubate.moe import moe_layer

        self.dropped: List[int] = []
        self._mod = moe_layer
        self._fns = (moe_layer._top1_dispatch, moe_layer._top2_dispatch)
        moe_layer._top1_dispatch = self._wrap(self._fns[0])
        moe_layer._top2_dispatch = self._wrap(self._fns[1])

    def _wrap(self, fn):
        def inner(*a, **kw):
            r = fn(*a, **kw)
            self.dropped.append(sum(int((~r.kept(k)).sum())
                                    for k in range(len(r.experts))))
            return r
        return inner

    def close(self):
        self._mod._top1_dispatch, self._mod._top2_dispatch = self._fns


def _run_case(rank: int, case: dict) -> dict:
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import (ParallelConfig,
                                              ParallelTrainStep,
                                              ProcessMesh)
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.convert import moe_state_from_jax
    from paddle_tpu_torch.optimizer import SGD, AdamW

    paddle.set_device("cpu")
    model = MoEModel(**case["spec"])
    model.set_state_dict(moe_state_from_jax(case["state"]))
    paddle.set_rng_state(case["rng_state"])
    cls = {"adamw": AdamW, "sgd": SGD}[case.get("opt", "adamw")]
    optim = cls(parameters=model.parameters(), **case["opt_kw"])
    shape = case.get("mesh")
    if shape is None:
        step = TrainStep(model, moe_loss(model), optim)
    else:
        mesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                           case["dims"])
        step = ParallelTrainStep(model, moe_loss(model), optim, mesh,
                                 ParallelConfig(**case.get("config", {})),
                                 n_model_inputs=1)
    out: dict = {"losses": []}
    for x, y in case["batches"]:
        out["losses"].append(float(step(torch.from_numpy(x),
                                        torch.from_numpy(y))))
    out["shards"] = {n: p._data.detach().clone().numpy()
                     for n, p in model.named_parameters()}
    if shape is not None:
        out["layouts"] = {n: lay.to_meta()
                          for n, lay in step.layouts().items()}
    return out


def train_cases(rank: int, world: int, cases: List[dict]) -> dict:
    """Each case on the ranks of its mesh (all ranks for a one-rank
    case): ``{name: result}``, and under ``"dropped"`` the dropped
    choices of each routing call, in order; a case that failed gives its
    traceback under ``"error"`` and ends the run on this rank."""
    torch.set_num_threads(1)
    results = {}
    for case in cases:
        shape = case.get("mesh")
        if shape is not None and rank >= int(np.prod(shape)):
            continue
        t0 = time.perf_counter()
        watch = DropWatch()
        try:
            results[case["name"]] = _run_case(rank, case)
        except Exception:
            results[case["name"]] = {"error": traceback.format_exc()}
            break
        finally:
            watch.close()
        results[case["name"]]["seconds"] = time.perf_counter() - t0
        results[case["name"]]["dropped"] = watch.dropped
    return results


def clip_pair(rank: int, world: int, grads: List[np.ndarray],
              expert: List[bool], clip_norm: float) -> dict:
    """``ClipGradForMOEByGlobalNorm`` on ep rank ``rank`` of ``world``:
    the normal gradients (``expert[i]`` False) are the same on every rank,
    the expert ones are split over the ranks on dim 0 (each rank its
    experts). Returns this rank's clipped gradients and the two squared
    norms."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import communication as comm
    from paddle_tpu_torch.incubate.moe import ClipGradForMOEByGlobalNorm

    paddle.set_device("cpu")
    group = comm.new_group(list(range(world)))
    params, pairs = [], []
    for g, is_e in zip(grads, expert):
        p = paddle.to_tensor(np.zeros(1, np.float32))
        p.is_expert = is_e
        local = np.split(g, world)[rank] if is_e else g
        pairs.append((p, paddle.to_tensor(local.copy())))
    clip = ClipGradForMOEByGlobalNorm(
        clip_norm, is_expert_param_func=lambda p: p.is_expert,
        moe_group=group)
    norm_sq, expert_sq = clip.norms(pairs)
    out = clip(pairs)
    return {"grads": [g.numpy() for _, g in out],
            "norm_sq": float(norm_sq), "expert_sq": float(expert_sq)}


# the card tests' ep 2 pair: a small MoEModel (8 experts), f32 placements
# with the batch replicated over ep and sharded over it, bf16 sharded
CARD_PAIR = dict(d=128, hidden=256, experts=8, batch=(4, 64))
CARD_PLACEMENTS = [("ep2_replicated", [2], ["ep"], {}),
                   ("ep2_sharded", [2], ["ep"], {"dp_axes": ("ep",)})]


def card_pair(rank: int, world: int, device: str = "cuda") -> dict:
    """``tools/moe_train.rank_part`` at :data:`CARD_PAIR` on an ep 2 pair
    (both ranks on the first card when started under
    ``tp_hooks.ranks_share_one_device``): each placement against the
    one-rank ``TrainStep`` on the same device."""
    from paddle_tpu_torch.tools import moe_train

    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return moe_train.rank_part(dev, rank, CARD_PAIR, CARD_PLACEMENTS,
                               CARD_PLACEMENTS[1])
