"""Mixture of experts with expert parallelism (port of
``paddle_tpu/incubate/moe/moe_layer.py``).

The gates are the reference's: top-1 (``SwitchGate``, with uniform logit
noise in [1 - eps, 1 + eps] while training) or top-2 (``GShardGate``,
with random second-expert routing: the second expert is kept where
2 g2 >= u), the per-expert capacity C = ceil(T / E * factor) over the
GLOBAL token count, a token's slot its position among the tokens routed
to that expert in the global token order (the second choices after all
first ones), the tokens past C dropped, and the aux loss E * sum_e
mean(gates_e) * mean(routed_e). The uniforms come from the port's
generator with the reference's splits, so the routing and the tokens
dropped are the JAX package's.

Dispatch and combine work by index (a token's expert and slot) where the
reference contracts a dense [T, E, C] one-hot; the numbers are the same.
The experts are one template layer applied with each expert's slice of
the stacked ``[E, ...]`` leaves, on a [C, M] slot buffer per expert, as
the reference's ``vmap`` does.

Expert parallelism. The leaves are marked ``{ep_axis: Shard(0)}``, so
``shard_model_parameters`` leaves each ep rank E/ep experts, and binds
the layer (``_bind_mesh``) to the ep group and to the group its tokens
are split over (the step's batch axes). The routing is global: each
expert's counts are prefixed over the token shares (one all-gather of
the counts), and the aux loss's means are sums over the shares (an
all-reduce whose backward all-reduces too). Two placements:

* **tokens replicated over ep** (ep not a batch axis): every rank routes
  every token of its share and fills the slots of its own experts; the
  experts' outputs are joined over ep (all-gather, whose backward takes
  the rank's slice), and every rank combines. The input of the local
  slots takes the Megatron ``f`` (identity, all-reduce backward): each
  rank's experts add their part of the input's gradient;
* **tokens sharded over ep** (``ParallelConfig(dp_axes=("ep", ...))``):
  the tokens go to the ranks that hold their experts by an all-to-all,
  come back by another, and are combined where they live (the
  reference's ``global_scatter`` / ``global_gather``).

Every collective's bytes count in ``communication.stats()``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from paddle_tpu_torch import nn
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.distributed import communication as comm
from paddle_tpu_torch.distributed.fleet.mp_layers import mark_placements
from paddle_tpu_torch.distributed.mesh import Shard
from paddle_tpu_torch.ops import registry as _registry
from paddle_tpu_torch.ops import threefry
from paddle_tpu_torch.ops.registry import register_emitter as _register

__all__ = ["MoELayer", "NaiveGate", "GShardGate", "SwitchGate", "Routing"]


# ---------------------------------------------------------------------------
# where this rank's tokens sit among all of them
# ---------------------------------------------------------------------------
class _Shares:
    """The tokens split over ``group`` (None: all here), share i on the
    group's member i: the prefix of the per-expert counts over the shares
    before this one, the global sums, this share's rows of a global
    draw."""

    def __init__(self, group=None):
        self.group = group if group is not None and group.nranks > 1 \
            else None
        self.n = 1 if self.group is None else self.group.nranks
        self.index = 0 if self.group is None else self.group.rank()

    def prefix_total(self, counts: torch.Tensor):
        """(the sum of ``counts`` over the shares before this one, over
        all of them)."""
        if self.group is None:
            return torch.zeros_like(counts), counts
        every = torch.stack(comm.all_gather_list(counts, self.group))
        return every[:self.index].sum(0), every.sum(0)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the shares; the backward sums too."""
        return comm.all_reduce_both(x, self.group)

    def rows(self, x: torch.Tensor, t: int) -> torch.Tensor:
        """This share's ``t`` rows of a draw over every share's tokens."""
        return x[self.index * t:(self.index + 1) * t]


class Routing:
    """A gate's decision by index: per choice (one for top-1, two for
    top-2) the token's expert, its slot and its combine weight (0 where
    the token is dropped), and the aux loss."""

    def __init__(self, experts, slots, weights, aux, capacity):
        self.experts: List[torch.Tensor] = experts
        self.slots: List[torch.Tensor] = slots
        self.weights: List[torch.Tensor] = weights
        self.aux = aux
        self.capacity = capacity

    def kept(self, k: int) -> torch.Tensor:
        """Whether each token's choice k takes a slot."""
        return self.weights[k] > 0

    def dense(self, num_experts: int):
        """The reference's (combine, dispatch) [T, E, C] of this
        routing."""
        t = self.experts[0].shape[0]
        combine = torch.zeros((t, num_experts, self.capacity),
                              device=self.aux.device)
        rows = torch.arange(t, device=combine.device)
        for k in range(len(self.experts)):
            keep = self.kept(k)
            combine[rows[keep], self.experts[k][keep],
                    self.slots[k][keep]] += self.weights[k][keep]
        return combine, combine > 0.0


def _positions(mask, prefix):
    """The slot of each routed token in its expert's column: its global
    position among them (0-based), -1 where not routed."""
    return (torch.cumsum(mask, 0) + prefix) * mask - 1.0


def _pick(x, idx):
    return x.gather(1, idx[:, None])[:, 0]


def _top1_dispatch(logits, capacity: int, shares: Optional[_Shares] = None
                   ) -> Routing:
    """Switch routing of this share's tokens (logits [T, E])."""
    shares = shares or _Shares()
    t, e = logits.shape
    gates = torch.softmax(logits.float(), -1)
    idx = gates.argmax(-1)
    mask = torch.nn.functional.one_hot(idx, e).float()
    prefix, total = shares.prefix_total(mask.sum(0))
    n_all = t * shares.n
    # aux: E * sum_e mean(gates_e) * mean(routed_e)   (Switch eq. 4)
    aux = e * torch.sum(shares.sum(gates.sum(0)) / n_all * (total / n_all))
    pos = _pick(_positions(mask, prefix), idx)
    keep = pos < capacity
    w = torch.where(keep, _pick(gates, idx), 0.0)
    return Routing([idx], [pos.long().clamp(0, capacity - 1)], [w], aux,
                   capacity)


def _top2_dispatch(logits, capacity: int, rand=None,
                   shares: Optional[_Shares] = None) -> Routing:
    """GShard top-2 routing of this share's tokens. ``rand`` (uniform [T],
    this share's rows) enables the random-routing rule: the second expert
    is used where 2 g2 >= rand."""
    shares = shares or _Shares()
    t, e = logits.shape
    gates = torch.softmax(logits.float(), -1)
    i1 = gates.argmax(-1)
    mask1 = torch.nn.functional.one_hot(i1, e).float()
    i2 = (gates * (1.0 - mask1)).argmax(-1)
    mask2 = torch.nn.functional.one_hot(i2, e).float()
    if rand is not None:
        mask2 = mask2 * (2.0 * _pick(gates, i2) >= rand)[:, None].float()
    prefix, total = shares.prefix_total(torch.stack([mask1.sum(0),
                                                     mask2.sum(0)]))
    n_all = t * shares.n
    aux = e * torch.sum(shares.sum(gates.sum(0)) / n_all * (total[0] / n_all))
    pos1 = _pick(_positions(mask1, prefix[0]), i1)
    # the second choices take the slots after every first choice
    pos2 = _pick(_positions(mask2, prefix[1] + total[0]), i2)
    keep1 = pos1 < capacity
    keep2 = (pos2 < capacity) & (pos2 >= 0)
    g1 = _pick(gates, i1)
    g2 = (gates * mask2).sum(-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom
    return Routing(
        [i1, i2], [pos1.long().clamp(0, capacity - 1),
                   pos2.long().clamp(0, capacity - 1)],
        [torch.where(keep1, g1, 0.0), torch.where(keep2, g2, 0.0)], aux,
        capacity)


# ---------------------------------------------------------------------------
# dispatch, the experts, combine
# ---------------------------------------------------------------------------
class _Placement:
    """The layer's groups: ``ep`` (None: every expert here), ``shares``
    (how the tokens are split), and whether they are split over ep."""

    def __init__(self, ep=None, shares: Optional[_Shares] = None,
                 tokens_over_ep: bool = False):
        self.ep = ep if ep is not None and ep.nranks > 1 else None
        self.shares = shares or _Shares()
        self.tokens_over_ep = bool(tokens_over_ep) and self.ep is not None


class _RowsAllToAll(torch.autograd.Function):
    """Rows to the group's members by counts; the backward sends the
    gradients back the same way."""

    @staticmethod
    def forward(ctx, x, sends, recvs, group):
        ctx.sends, ctx.recvs, ctx.group = sends, recvs, group
        return comm.all_to_all_rows(x, sends, recvs, group)

    @staticmethod
    def backward(ctx, dy):
        return comm.all_to_all_rows(dy.contiguous(), ctx.recvs, ctx.sends,
                                    ctx.group), None, None, None


def _chosen(routing: Routing, first: int, n_local: int):
    """(token, local expert, slot, weight) of the kept choices whose
    expert lies in [first, first + n_local), choice by choice."""
    rows, es, cs, ws = [], [], [], []
    for k in range(len(routing.experts)):
        e = routing.experts[k]
        sel = routing.kept(k) & (e >= first) & (e < first + n_local)
        tok = sel.nonzero()[:, 0]
        rows.append(tok)
        es.append(e[tok] - first)
        cs.append(routing.slots[k][tok])
        ws.append(routing.weights[k][tok])
    return (torch.cat(rows), torch.cat(es), torch.cat(cs), torch.cat(ws))


def _slot_outputs(apply_fn, leaves, rows, es, cs, capacity: int):
    """The local experts on their [C, M] slot buffers, ``rows`` [N, M] in
    slots (es, cs) and zeros elsewhere: [E_local * C, M_out]."""
    n_local = leaves[0].shape[0]
    m = rows.shape[-1]
    slots = rows.new_zeros((n_local * capacity, m)).index_copy(
        0, es * capacity + cs, rows)
    out = apply_fn(leaves, slots.view(n_local, capacity, m))
    return out.reshape(n_local * capacity, -1)


def _experts(x, routing: Routing, leaves, apply_fn, place: _Placement):
    """The experts' outputs combined per token, in f32: [T, M]."""
    c = routing.capacity
    n_local = leaves[0].shape[0]
    if not place.tokens_over_ep:
        first = n_local * (place.ep.rank() if place.ep is not None else 0)
        tok, es, cs, _ = _chosen(routing, first, n_local)
        xd = comm.copy_to_group(x, place.ep)
        out = _slot_outputs(apply_fn, leaves, xd[tok], es, cs, c)
        full = comm.gather_along(out, place.ep, 0)
        y = None
        for k in range(len(routing.experts)):
            yk = routing.weights[k][:, None] * \
                full[routing.experts[k] * c + routing.slots[k]]
            y = yk if y is None else y + yk
        return y
    # tokens split over ep: to the experts' ranks and back
    g = place.ep
    n = g.nranks
    tok, e, cs, w = _chosen(routing, 0, n_local * n)
    owner = torch.div(e, n_local, rounding_mode="floor")
    order = torch.sort(owner, stable=True).indices
    tok, e, cs, w, owner = (a[order] for a in (tok, e, cs, w, owner))
    sends = torch.bincount(owner, minlength=n)
    recvs = comm.all_to_all_rows(sends.reshape(n, 1), [1] * n, [1] * n,
                                 g).reshape(-1)
    sends, recvs = sends.tolist(), recvs.tolist()
    meta = comm.all_to_all_rows(torch.stack([e - owner * n_local, cs], 1),
                                sends, recvs, g)
    got = _RowsAllToAll.apply(x[tok], sends, recvs, g)
    out = _slot_outputs(apply_fn, leaves, got, meta[:, 0], meta[:, 1], c)
    back = _RowsAllToAll.apply(out[meta[:, 0] * c + meta[:, 1]], recvs,
                               sends, g)
    # combined in f32, as the replicated placement combines
    return back.new_zeros((x.shape[0], back.shape[1]), dtype=torch.float32
                          ).index_add(0, tok, w[:, None] * back.float())


@_register(name="moe_forward")
def _moe_forward_emitter(x, gate_w, leaves, apply_fn=None, k=2,
                         capacity=0, ep_axis=None, key=None,
                         switch_eps=0.0, random_routing=False,
                         placement=None):
    """x [T, M] (this rank's tokens); gate_w [M, E]; leaves: the stacked
    [E_local, ...] expert parameters. Returns (out [T, M], aux scalar).

    ``key`` (a generator key when training, None in eval) drives the
    gates' stochastic parts: SwitchGate's additive uniform logit noise in
    [1 - eps, 1 + eps] and GShardGate's random second-expert routing,
    each drawn over every share's tokens (this share takes its rows).
    ``placement`` holds the ep group and the token shares (None: one
    process holding every expert and token); ``ep_axis`` is the
    reference's argument, whose sharding constraint the placement's
    groups stand for here."""
    place = placement or _Placement()
    t = x.shape[0]
    n_all = t * place.shares.n
    logits = torch.matmul(x.float(), gate_w.float())
    if k == 1:
        if key is not None and switch_eps > 0.0:
            k_noise = threefry.split(key)[0]
            noise = threefry.uniform(k_noise, (n_all, logits.shape[1]),
                                     1.0 - switch_eps, 1.0 + switch_eps,
                                     device=x.device)
            logits = logits + place.shares.rows(noise, t)
        routing = _top1_dispatch(logits, capacity, place.shares)
    else:
        rand = None
        if key is not None and random_routing:
            k_rand = threefry.split(key)[0]
            rand = place.shares.rows(
                threefry.uniform(k_rand, (n_all,), device=x.device), t)
        routing = _top2_dispatch(logits, capacity, rand, place.shares)
    out = _experts(x, routing, leaves, apply_fn, place)
    return out.to(x.dtype), routing.aux.float()


if "moe_forward" not in _registry.OPS:
    _registry.build_registry([
        {"op": "moe_forward", "tensor_args": ["x", "gate_w", "*leaves"],
         "methods": []}])


# ---------------------------------------------------------------------------
# gate layers (the reference's moe/gate/*.py)
# ---------------------------------------------------------------------------
class NaiveGate(nn.Layer):
    """Linear router; k=2 like the reference NaiveGate."""

    top_k = 2

    def __init__(self, d_model, num_experts):
        super().__init__()
        self.weight = self.create_parameter(
            [d_model, num_experts],
            default_initializer=nn.initializer.XavierUniform())


class GShardGate(NaiveGate):
    """Top-2 with random second-expert routing and train/eval capacity
    factors (capacity=(1.2, 2.4), random_routing=True)."""

    top_k = 2

    def __init__(self, d_model, num_experts, capacity=(1.2, 2.4),
                 random_routing=True):
        super().__init__(d_model, num_experts)
        self.capacity = tuple(capacity)
        self.random_routing = random_routing


class SwitchGate(NaiveGate):
    """Top-1 with additive uniform logit noise while training
    (switch_eps=0.1, capacity=(1.2, 2.4))."""

    top_k = 1

    def __init__(self, d_model, num_experts, switch_eps=0.1,
                 capacity=(1.2, 2.4)):
        super().__init__(d_model, num_experts)
        self.switch_eps = switch_eps
        self.capacity = tuple(capacity)


_GATES = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}


# ---------------------------------------------------------------------------
# MoELayer
# ---------------------------------------------------------------------------
class MoELayer(nn.Layer):
    """A gate and experts stacked on a leading [E, ...] axis marked for
    ``ep_axis`` sharding (the experts share one structure; the first is
    the template the stacked leaves are applied through).

    The load-balancing aux loss of the last forward is ``self.aux_loss``
    (a Tensor): add ``aux_loss_weight * layer.aux_loss`` to the loss."""

    def __init__(self, d_model: int, experts: Sequence[nn.Layer],
                 gate="gshard", capacity_factor: Optional[float] = None,
                 ep_axis: Optional[str] = "ep"):
        super().__init__()
        self.d_model = d_model
        self.num_experts = len(experts)
        # None: the gate's (train, eval) factors; a value always wins
        self.capacity_factor = capacity_factor
        self.ep_axis = ep_axis
        if isinstance(gate, str):
            gate = _GATES[gate](d_model, self.num_experts)
        self.gate = gate
        self.top_k = getattr(gate, "top_k", 2)
        template = experts[0]
        if list(template.named_buffers()):
            raise NotImplementedError(
                "MoE experts with buffers (BatchNorm) are unsupported; "
                "use LayerNorm/RMSNorm")
        names = [n for n, _ in template.named_parameters()]
        per_expert = []
        for ex in experts:
            ps = list(ex.named_parameters())
            if [n for n, _ in ps] != names:
                raise ValueError("experts must share one structure")
            per_expert.append([p for _, p in ps])
        self.stacked_params = []
        for i in range(len(names)):
            p = nn.Parameter(torch.stack([per_expert[e][i]._data.detach()
                                          for e in range(self.num_experts)]))
            if ep_axis:
                mark_placements(p, **{ep_axis: Shard(0)})
            self.add_parameter(f"expert_leaf_{i}", p)
            self.stacked_params.append(p)
        # the template is applied with each expert's leaves; it is not a
        # sublayer
        object.__setattr__(self, "_template", template)
        self._template_params = per_expert[0]
        self._placement = _Placement()
        self.aux_loss = None

    def _bind_mesh(self, mesh, batch_axes):
        """The ep group (this rank holds its E/ep experts once the
        parameters are cut) and the token shares over ``batch_axes``."""
        ep = mesh.group(self.ep_axis) if self.ep_axis in mesh.dim_names \
            else None
        shares = _Shares(mesh.group(batch_axes) if batch_axes else None)
        self._placement = _Placement(ep, shares, self.ep_axis in batch_axes)

    def _apply_experts(self, leaves, xe):
        """Expert e (local) on ``xe[e]`` [C, M] with ``leaves[i][e]``:
        [E_local, C, M_out]."""
        outs = []
        saved = [p._data for p in self._template_params]
        try:
            for e in range(xe.shape[0]):
                for p, leaf in zip(self._template_params, leaves):
                    p._data = leaf[e]
                x = Tensor._from_data(xe[e], stop_gradient=not
                                      xe.requires_grad)
                outs.append(self._template(x)._data)
        finally:
            for p, d in zip(self._template_params, saved):
                p._data = d
        return torch.stack(outs)

    def forward(self, x):
        from paddle_tpu_torch.core import generator as gen

        shape = x.shape
        t = math.prod(shape[:-1])
        x2 = x.reshape([t, shape[-1]])
        gate_caps = getattr(self.gate, "capacity", None)
        if self.capacity_factor is not None:
            factor = self.capacity_factor
        elif gate_caps is not None:
            factor = gate_caps[0 if self.training else 1]
        else:
            factor = 1.25
        n_all = t * self._placement.shares.n
        capacity = int(math.ceil(n_all / self.num_experts * factor))
        key = gen.active_key() if self.training else None
        # the reference's vmapped expert draws one key a forward
        gen.active_key()
        out, aux = _registry.API["moe_forward"](
            x2, self.gate.weight, list(self.stacked_params),
            apply_fn=self._apply_experts, k=self.top_k,
            capacity=max(capacity, 1), ep_axis=self.ep_axis, key=key,
            switch_eps=getattr(self.gate, "switch_eps", 0.0),
            random_routing=getattr(self.gate, "random_routing", False),
            placement=self._placement)
        self.aux_loss = aux
        return out.reshape(shape)
