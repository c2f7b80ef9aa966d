"""Hybrid-parallel training step (port of
``paddle_tpu/distributed/engine.py``).

The JAX package jits forward, backward and update into ONE SPMD program
over a ``jax.sharding.Mesh``; parameters and slots carry
``NamedSharding``s and GSPMD inserts every collective. PyTorch's idiom is
one process per rank, so here each rank of a
:class:`~paddle_tpu_torch.distributed.mesh.ProcessMesh` runs the same
program on its own share, and the collectives are written out:

* **the same program on every rank.** Every rank builds the same model
  from the same seed and calls ``step(X, Y)`` with the GLOBAL batch, as
  the JAX caller does. The step keeps the rank's share of the batch dim
  (split over ``config.dp_axes``, plus the sharding axis at ZeRO stage
  >= 1, the JAX step's batch sharding) and returns the global loss, the
  same on every rank;
* **parameters are shards after construction.**
  :func:`shard_model_parameters` cuts each parameter that carries
  placement hints (``mark_placements``: ``{axis: Shard(dim)}``) to the
  rank's slice IN PLACE, and at stage 3 also the ZeRO dim (the first dim
  not already sharded that the sharding axis divides, the JAX package's
  ``_pspec_from_hints``; a parameter stored transposed from the JAX
  model's names its dims in the JAX order in ``_dim_order``). It binds every module with a ``_bind_mp``
  method (the tensor-parallel layers, the Llama's modules) to the mesh's
  ``"mp"`` group, which then compute the Megatron pairs, and gives every
  module with a ``_bind_mesh`` method the mesh and the batch axes (the
  context-parallel Llama, ``incubate.moe.MoELayer``);
* **context parallelism.** A model that runs sequence-sharded declares
  its sequence axis: a module bound by :func:`shard_model_parameters`
  (``_bind_mesh``) sets ``_seq_axis`` (the context-parallel Llama,
  ``cp_axis``). The step then also keeps the rank's chunk of the
  sequence (the dim after the batch dim) over that axis, for the inputs
  and the labels, and the loss and the gradients are averaged over it
  with the batch axes (the parameters are replicated there);
* **the gradients.** After the backward, the gradients of parameters in
  a sequence-parallel region (``param.sequence_parallel``) are summed
  over ``"mp"``; then every gradient is averaged over the batch axes
  (and the sequence axis): an all-reduce, or at stage 2 a reduce-scatter
  onto the ZeRO slice. A gradient is not summed over an axis its
  parameter is sharded on (a ZeRO-3 slice, an expert stacked over
  ``"ep"``: the collectives' backwards have gathered it). A loss
  layer with ``reduction="sum"`` is summed over the batch axes instead
  of averaged (the JAX step's loss of the global batch is then the sum
  of the ranks' losses); any other loss is taken as a mean over equal
  shares;
* **ZeRO.** Stage 0: the slots follow the parameter. Stages 1 and 2: each
  rank of the sharding axis keeps the slots (and master weights) of its
  slice of the ZeRO dim, updates that slice and all-gathers the
  parameter. Stage 3: the parameter itself is the slice at rest; each
  module all-gathers its parameters just before its forward, frees them
  after it, and a saved-tensor hook re-gathers them for the backward
  instead of keeping them (:class:`_Zero3`), whose all-gather's backward
  reduce-scatters the gradient. The numbers are the same at every stage;
* **one step body.** :class:`ParallelTrainStep` is a
  :class:`~paddle_tpu_torch.jit.train.TrainStep` (the update rule with
  master weights, the scaler, ``skip_nonfinite``, the device RNG chain)
  with its hooks overridden: the batch placement, the gradient and loss
  synchronisation, the flags every rank must agree on (the scaler's
  ``found_inf`` and the ``skip_nonfinite`` flag, all-reduced by max, so
  every rank skips together), the clip (squared norms summed over the
  groups that shard each gradient, a replicated one counted once), and
  the sliced update;
* **inside the step** the current mesh is set (the ambient mesh the
  sequence-parallel ops and ``ParallelCrossEntropy`` read), BatchNorm
  and SyncBatchNorm take their statistics over the batch axes (the JAX
  step's BatchNorm sees the global batch), and a dropout over the
  batch dim draws its slice of the global batch's mask;
  ``config.remat`` runs the model under
  :func:`~paddle_tpu_torch.distributed.fleet.recompute.recompute`.

At world > 1 the step runs uncaptured: gloo cannot sit in a CUDA graph,
and capture under NCCL is queued (ROADMAP). The tests hold every
configuration against the JAX ``ParallelTrainStep`` on the CPU, with
the global view of each parameter assembled from the ranks' shards
(:meth:`ParallelTrainStep.layouts`).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.distributed import communication as comm
from paddle_tpu_torch.distributed.mesh import ProcessMesh, Shard
from paddle_tpu_torch.jit.train import TrainStep

__all__ = ["current_mesh", "set_current_mesh", "shard_model_parameters",
           "ParallelTrainStep", "ParallelConfig", "mp_group", "batch_axes"]

_current_mesh: Optional[ProcessMesh] = None

def current_mesh() -> Optional[ProcessMesh]:
    return _current_mesh


def set_current_mesh(mesh: Optional[ProcessMesh]):
    global _current_mesh
    _current_mesh = mesh


def mp_group():
    """The current mesh's ``"mp"`` group when it spans more than one
    rank, else None."""
    mesh = _current_mesh
    if mesh is None or mesh.dim_size("mp") < 2:
        return None
    return mesh.group("mp")


class ParallelConfig:
    """Which mesh axes mean what + ZeRO stage + batch placement."""

    def __init__(self, dp_axes: Sequence[str] = ("dp",),
                 sharding_stage: int = 0,
                 sharding_axis: str = "dp",
                 batch_dim: int = 0,
                 remat: bool = False):
        self.dp_axes = tuple(dp_axes)
        self.sharding_stage = sharding_stage
        self.sharding_axis = sharding_axis
        self.batch_dim = batch_dim
        self.remat = remat


# ---------------------------------------------------------------------------
# parameter placement
# ---------------------------------------------------------------------------
class _Plan:
    """Where one parameter lives: its global shape, the mesh axis each
    tensor dim is split over at rest (hints, plus the ZeRO dim at stage
    3), and the ZeRO dim its slots are sliced along (stage >= 1)."""

    __slots__ = ("global_shape", "dims", "zero_dim", "zero_axis", "stage",
                 "sp")

    def __init__(self, global_shape, dims, zero_dim, zero_axis, stage, sp):
        self.global_shape = tuple(global_shape)
        self.dims: Dict[int, str] = dict(dims)
        self.zero_dim = zero_dim
        self.zero_axis = zero_axis
        self.stage = stage
        self.sp = sp

    def key(self):
        return (self.global_shape, tuple(sorted(self.dims.items())))

    def layout(self, mesh: ProcessMesh):
        """The parameter's :class:`~paddle_tpu_torch.distributed.
        redistribute.Layout` at rest over ``mesh``."""
        from paddle_tpu_torch.distributed.redistribute import Layout

        return Layout(list(zip(mesh.dim_names, mesh.shape)),
                      [self.dims.get(d) for d in
                       range(len(self.global_shape))])


def _plan_for(p, mesh: ProcessMesh, config: ParallelConfig) -> _Plan:
    old = getattr(p, "_dist_plan", None)
    shape = old.global_shape if old is not None else tuple(_tensor(p).shape)
    ndim = len(shape)
    dims: Dict[int, str] = {}
    for ax, pl in (getattr(p, "_placement_hints", None) or {}).items():
        if ax not in mesh.dim_names or not isinstance(pl, Shard) or not ndim:
            continue
        d = pl.dim % ndim
        if d in dims:
            raise ValueError(f"dim {d} of a parameter is split over both "
                             f"{dims[d]!r} and {ax!r}")
        dims[d] = ax
    stage = int(config.sharding_stage)
    zaxis = config.sharding_axis
    zero_dim = None
    if stage >= 1 and zaxis in mesh.dim_names and \
            zaxis not in dims.values() and ndim > 0:
        n = mesh.get_dim_size(zaxis)
        for d in getattr(p, "_dim_order", range(ndim)):
            if d not in dims and shape[d] % n == 0:
                zero_dim = d
                break
    if stage >= 3 and zero_dim is not None:
        dims[zero_dim] = zaxis
    return _Plan(shape, dims, zero_dim, zaxis if zero_dim is not None
                 else None, stage, bool(getattr(p, "sequence_parallel",
                                                False)))


def _tensor(p) -> torch.Tensor:
    """The torch tensor of a parameter (a Tensor API Parameter's data)."""
    return p if isinstance(p, torch.Tensor) else p._data


def _named_params(model):
    return list(model.named_parameters())


def _modules(model):
    if isinstance(model, torch.nn.Module):
        return list(model.modules())
    return model.sublayers(include_self=True)


def _own_params(module):
    """(name, parameter) of the parameters a module holds itself."""
    return [(n, p) for n, p in module._parameters.items() if p is not None]


def _cut(data: torch.Tensor, plan: _Plan, mesh: ProcessMesh, coord
         ) -> torch.Tensor:
    """This rank's slice of the global ``data`` under ``plan``."""
    out = data
    for d, ax in sorted(plan.dims.items()):
        n = mesh.get_dim_size(ax)
        if out.shape[d] % n:
            raise ValueError(f"dim {d} of size {out.shape[d]} does not "
                             f"split over mesh axis {ax!r} of {n}")
        out = out.chunk(n, dim=d)[coord[mesh.dim_names.index(ax)]]
    return out


def batch_axes(mesh: ProcessMesh, config: ParallelConfig) -> Tuple[str, ...]:
    """The mesh axes the batch is split over: ``config.dp_axes`` the
    mesh has, and the sharding axis at ZeRO stage >= 1."""
    axes = [a for a in config.dp_axes if a in mesh.dim_names]
    if config.sharding_stage >= 1 and config.sharding_axis in \
            mesh.dim_names and config.sharding_axis not in axes:
        axes.append(config.sharding_axis)
    return tuple(axes)


@torch.no_grad()
def shard_model_parameters(model, mesh: ProcessMesh,
                           config: Optional[ParallelConfig] = None):
    """Cut every parameter to this rank's slice per its hints (and, at
    ZeRO stage 3, the ZeRO dim) IN PLACE, bind the modules that have a
    ``_bind_mp`` method to the mesh's ``"mp"`` group, give the modules
    that have a ``_bind_mesh`` method the mesh and the batch axes, and at
    stage 3 make each module gather its parameters for use. A model
    already sharded the same way is left as it is."""
    from paddle_tpu_torch.distributed.env import get_rank

    config = config or ParallelConfig()
    coord = mesh.coord(get_rank())
    if coord is None:
        raise ValueError(f"rank {get_rank()} is not on the mesh "
                         f"{mesh.process_ids}")
    for name, p in _named_params(model):
        plan = _plan_for(p, mesh, config)
        old = getattr(p, "_dist_plan", None)
        if old is not None:
            if old.key() != plan.key():
                raise ValueError(
                    f"{name} is already sharded as {old.dims}; cannot "
                    f"re-shard it as {plan.dims}")
            p._dist_plan = plan
            continue
        data = _tensor(p)
        local = _cut(data, plan, mesh, coord)
        if local.shape != data.shape:
            local = local.contiguous().clone()
            if isinstance(p, torch.Tensor):
                p.data = local
            else:
                p._data = local.requires_grad_(data.requires_grad)
        p._dist_plan = plan
        p._process_mesh = mesh
    mp = mesh.group("mp") if mesh.dim_size("mp") > 1 else None
    axes = batch_axes(mesh, config)
    for m in _modules(model):
        if mp is not None and hasattr(m, "_bind_mp"):
            m._bind_mp(mp)
        if hasattr(m, "_bind_mesh"):
            m._bind_mesh(mesh, axes)
    if int(config.sharding_stage) >= 3:
        _Zero3.install(model, mesh)
    return model


# ---------------------------------------------------------------------------
# ZeRO-3: gather on use
# ---------------------------------------------------------------------------
class _Regather:
    """A saved tensor that was (a view of) a gathered parameter: the
    backward gathers it again from the shard."""

    __slots__ = ("shard", "group", "dim", "size", "stride", "offset")

    def __init__(self, shard, group, dim, t):
        self.shard, self.group, self.dim = shard, group, dim
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()

    def gather(self):
        full = comm.all_gather_cat(self.shard.detach(), self.dim, self.group)
        return full.as_strided(self.size, self.stride, self.offset)


class _Zero3:
    """Stage 3's parameters at rest are ZeRO slices. A forward pre-hook on
    each module that holds one puts the all-gathered parameter in its
    place (:func:`~paddle_tpu_torch.distributed.communication.
    all_gather_along`: the backward reduce-scatters its gradient onto the
    slice); the post-hook puts the slice back, so the gathered copy dies
    with the module's forward. While the step's forward runs,
    :meth:`saved_hooks` keeps autograd from saving a gathered parameter:
    it saves the slice and gathers again when the backward unpacks it."""

    # storage address of each live gathered parameter -> (slice, group,
    # dim)
    live: Dict[int, tuple] = {}

    @classmethod
    def install(cls, model, mesh: ProcessMesh):
        for m in _modules(model):
            if getattr(m, "_zero3_hooked", False):
                continue
            entries = []
            for name, p in _own_params(m):
                plan = getattr(p, "_dist_plan", None)
                if plan is None or plan.stage < 3 or plan.zero_dim is None:
                    continue
                entries.append((name, p, mesh.group(plan.zero_axis),
                                plan.zero_dim))
            if not entries:
                continue
            m._zero3_entries = entries
            m._zero3_hooked = True
            if isinstance(m, torch.nn.Module):
                m.register_forward_pre_hook(cls._pre_module)
                m.register_forward_hook(cls._post_module)
            else:
                m.register_forward_pre_hook(cls._pre_layer)
                m.register_forward_post_hook(cls._post_layer)

    @classmethod
    def _gather(cls, shard, g, d):
        full = comm.all_gather_along(shard, g, d)
        cls.live[full.untyped_storage().data_ptr()] = (shard, g, d)
        return full

    @classmethod
    def _release(cls, full):
        cls.live.pop(full.untyped_storage().data_ptr(), None)

    @classmethod
    def _pre_module(cls, m, args):
        m._zero3_full = []
        for name, p, g, d in m._zero3_entries:
            full = cls._gather(p, g, d)
            m._parameters[name] = full
            m._zero3_full.append(full)

    @classmethod
    def _post_module(cls, m, args, out):
        for (name, p, _, _), full in zip(m._zero3_entries, m._zero3_full):
            m._parameters[name] = p
            cls._release(full)
        m._zero3_full = []

    @classmethod
    def _pre_layer(cls, m, inputs):
        m._zero3_full = []
        for _, p, g, d in m._zero3_entries:
            shard = p._data
            full = cls._gather(shard, g, d)
            p._data = full
            m._zero3_full.append((shard, full))

    @classmethod
    def _post_layer(cls, m, inputs, outputs):
        for (_, p, _, _), (shard, full) in zip(m._zero3_entries,
                                              m._zero3_full):
            p._data = shard
            cls._release(full)
        m._zero3_full = []

    @classmethod
    def _pack(cls, t):
        if t.layout != torch.strided or t.device.type == "meta":
            return t
        e = cls.live.get(t.untyped_storage().data_ptr())
        return t if e is None else _Regather(e[0], e[1], e[2], t)

    @staticmethod
    def _unpack(x):
        return x.gather() if isinstance(x, _Regather) else x

    @classmethod
    def saved_hooks(cls):
        return torch.autograd.graph.saved_tensors_hooks(cls._pack,
                                                         cls._unpack)


def _is_share(b, mesh: ProcessMesh, axes: Sequence[str], dim: int) -> bool:
    """``b`` is a DistTensor on ``mesh`` sharded on ``dim`` over exactly
    the batch ``axes`` and whole over the other axes (mesh-placed
    prefetch): its block is this rank's contiguous share of the batch."""
    pls = getattr(b, "_placements", None)
    if pls is None or not axes or \
            getattr(b, "_process_mesh", None) != mesh:
        return False
    on = {n for n, p in zip(mesh.dim_names, pls) if p.is_shard()}
    return on == set(axes) and all(
        pls[mesh.dim_names.index(a)].get_dim() == dim for a in axes)


def _count_weight(loss_fn, label, group, n: int
                  ) -> Optional[torch.Tensor]:
    """A loss that is a mean over the labels it does not ignore (a cross
    entropy or NLL loss layer on hard labels, reduction "mean") divides
    by this rank's count of them, and the whole batch's by the count over
    ``group`` (``n`` ranks): the factor that makes the ranks' mean of
    their losses the whole batch's loss. None for any other loss."""
    ignore = getattr(loss_fn, "ignore_index", None)
    if group is None or ignore is None or getattr(
            loss_fn, "reduction", None) != "mean" or getattr(
            loss_fn, "soft_label", False):
        return None
    label = _tensor(label)
    valid = label != ignore
    w = getattr(loss_fn, "weight", None)
    if w is None:
        cnt, least = valid.sum(dtype=torch.float32), 1.0
    else:
        w = _tensor(w).to(label.device, torch.float32)
        cnt = torch.where(valid, w[torch.where(valid, label, 0).long()],
                          0.0).sum()
        least = 1e-12
    tot = cnt.reshape(1).clone()
    comm.all_reduce_(tot, comm.ReduceOp.SUM, group)
    return cnt.clamp(min=least) * n / tot[0].clamp(min=least)


# ---------------------------------------------------------------------------
# fused collectives over lists of tensors
# ---------------------------------------------------------------------------
@torch.no_grad()
def _reduce_scatter_slices(tensors: List[torch.Tensor], dims: List[int],
                           group) -> List[torch.Tensor]:
    """Each tensor's slice (this rank's chunk of its dim) of the sum over
    ``group``, in f32 for 16-bit tensors; one collective a bucket."""
    n, me = group.nranks, group.rank()
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for run in comm.buckets(tensors):
        wide = tensors[run[0]].dtype in (torch.bfloat16, torch.float16)
        chunks = [[c.float() if wide else c for c in
                   tensors[i].chunk(n, dim=dims[i])] for i in run]
        parts = [torch.cat([ch[r].reshape(-1) for ch in chunks])
                 for r in range(n)]
        mine = comm.reduce_scatter_list(parts, comm.ReduceOp.SUM, group)
        off = 0
        for j, i in enumerate(run):
            shape = chunks[j][me].shape
            k = chunks[j][me].numel()
            out[i] = mine[off:off + k].view(shape)
            off += k
    return out


@torch.no_grad()
def _all_gather_slices(params: List[torch.Tensor], dims: List[int], group):
    """Fill each parameter from every rank's chunk of its dim, the
    chunk this rank holds included; one collective a bucket."""
    n = group.nranks
    me = group.rank()
    for run in comm.buckets(params):
        views = [params[i].chunk(n, dim=dims[i]) for i in run]
        flat = torch.cat([v[me].reshape(-1) for v in views])
        got = comm.all_gather_list(flat, group)
        for r in range(n):
            if r == me:
                continue
            off = 0
            for v in views:
                k = v[r].numel()
                v[r].copy_(got[r][off:off + k].view(v[r].shape))
                off += k


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
class ParallelTrainStep(TrainStep):
    """``step(*batch)`` runs one hybrid-parallel optimizer step of
    ``model`` on this rank's share of the global batch and returns the
    global loss (see the module docstring). The model's parameters are
    cut to their shards at construction."""

    def __init__(self, model, loss_fn: Callable, optimizer,
                 mesh: ProcessMesh, config: Optional[ParallelConfig] = None,
                 n_model_inputs: int = 1, scaler=None,
                 skip_nonfinite: bool = False):
        from paddle_tpu_torch.distributed.env import get_rank

        cfg = self._config = config or ParallelConfig()
        self._mesh = mesh
        self._n_inputs = n_model_inputs
        shard_model_parameters(model, mesh, cfg)
        me = get_rank()
        axes = batch_axes(mesh, cfg)
        self._batch_axes = axes
        self._batch_n = 1
        for a in axes:
            self._batch_n *= mesh.get_dim_size(a)
        self._batch_index = mesh.axis_index(axes, me)
        self._bgroup = mesh.group(axes)
        # the sequence axis a context-parallel model declares
        seq = next((m._seq_axis for m in _modules(model)
                    if getattr(m, "_seq_axis", None)), None)
        self._cp_n = mesh.dim_size(seq) if seq else 1
        self._cp_index = mesh.axis_index((seq,), me) if seq else 0
        # the loss and the gradients are averaged over these
        self._mean_axes = axes + ((seq,) if seq and seq not in axes
                                  else ())
        self._mean_n = self._batch_n * self._cp_n
        self._lgroup = mesh.group(self._mean_axes)
        self._world = mesh.group(tuple(mesh.dim_names))
        self._stage = int(cfg.sharding_stage)
        self._zgroup = mesh.group(cfg.sharding_axis) \
            if cfg.sharding_axis in mesh.dim_names else None
        self._sums = getattr(loss_fn, "reduction", None) == "sum"
        self._plans = {id(_tensor(p)): p._dist_plan
                       for _, p in _named_params(model)}
        super().__init__(model, loss_fn, optimizer, scaler=scaler,
                         skip_nonfinite=skip_nonfinite)
        self._plan_list = [self._plans[id(p)] for p in self._params]
        self._build_sync_plan()
        from paddle_tpu_torch.distributed.checkpoint import register_layouts

        register_layouts(self)

    # -- the plan of the collectives -------------------------------------
    def _sliced(self, plan: _Plan) -> bool:
        """Stage 1/2: the slots cover this rank's slice of the ZeRO dim."""
        return self._stage in (1, 2) and plan.zero_dim is not None

    def _build_sync_plan(self):
        mesh = self._mesh
        self._sp_idx = [i for i, pl in enumerate(self._plan_list) if pl.sp]
        # the batch-axis reduction of each gradient: a reduce-scatter onto
        # the ZeRO slice at stage 2, and an all-reduce over the rest
        self._rs_idx = [i for i, pl in enumerate(self._plan_list)
                        if self._stage == 2 and pl.zero_dim is not None]
        by_axes: Dict[Tuple[str, ...], List[int]] = {}
        for i, pl in enumerate(self._plan_list):
            done = pl.zero_axis if (self._stage >= 2 and
                                    pl.zero_dim is not None) else None
            # an axis the parameter is sharded on: its collectives'
            # backwards summed the gradient there already
            key = tuple(a for a in self._mean_axes
                        if a != done and a not in pl.dims.values())
            by_axes.setdefault(key, []).append(i)
        self._ar = [(mesh.group(k) if k else None, idx)
                    for k, idx in by_axes.items()]
        # the axes each gradient is split over when the update sees it
        # (its groups for the clip's norms and Lamb's trust ratio)
        self._grad_axes = []
        self._target_axes = []
        for pl in self._plan_list:
            at_rest = tuple(sorted(set(pl.dims.values()),
                                   key=mesh.dim_names.index))
            extra = (pl.zero_axis,) if self._sliced(pl) else ()
            self._target_axes.append(at_rest + extra)
            self._grad_axes.append(at_rest + (extra if self._stage == 2
                                              else ()))

    def _new_slots(self, p) -> dict:
        plan = self._plans[id(p)]
        if self._sliced(plan):
            return self._opt._init_slots_mp(self._slice(p, plan))
        return self._opt._init_slots_mp(p)

    def _slice(self, t: torch.Tensor, plan: _Plan) -> torch.Tensor:
        """This rank's chunk of ``t``'s ZeRO dim (a view)."""
        return t.chunk(self._zgroup.nranks,
                       dim=plan.zero_dim)[self._zgroup.rank()]

    # -- TrainStep's hooks -------------------------------------------------
    def _place(self, batch, lead: int = 0):
        from paddle_tpu_torch.jit.train import _as_data

        d = lead + self._config.batch_dim
        out = []
        for b in batch:
            if _is_share(b, self._mesh, self._batch_axes,
                         self._config.batch_dim):
                # a DistTensor placed over the batch axes (mesh-placed
                # prefetch): its block is this rank's share already
                out.append(b._data.to_local().to(self._device,
                                                 non_blocking=True))
                continue
            x = _as_data(b)
            if self._batch_n > 1 and x.dim() > d:
                if x.shape[d] % self._batch_n:
                    raise ValueError(
                        f"batch dim of size {x.shape[d]} does not split "
                        f"over the {self._batch_n} ranks of "
                        f"{self._batch_axes}")
                x = x.chunk(self._batch_n, dim=d)[self._batch_index]
            if self._cp_n > 1 and x.dim() > d + 1:
                if x.shape[d + 1] % self._cp_n:
                    raise ValueError(
                        f"sequence dim of size {x.shape[d + 1]} does not "
                        f"split over the {self._cp_n} context-parallel "
                        f"ranks")
                x = x.chunk(self._cp_n, dim=d + 1)[self._cp_index]
            out.append(x.to(self._device, non_blocking=True))
        return out

    def _captures(self) -> bool:
        return self._mesh.size == 1 and self._device.type == "cuda"

    @contextlib.contextmanager
    def _context(self):
        from paddle_tpu_torch.core import generator as gen
        from paddle_tpu_torch.nn import norm

        prev = current_mesh()
        set_current_mesh(self._mesh)
        try:
            with contextlib.ExitStack() as stack:
                stack.enter_context(norm.batch_stats_group(self._bgroup))
                if self._batch_n > 1:
                    stack.enter_context(gen.batch_view(
                        self._config.batch_dim, self._batch_n,
                        self._batch_index))
                if self._stage >= 3:
                    stack.enter_context(_Zero3.saved_hooks())
                yield
        finally:
            set_current_mesh(prev)

    def _body(self, datas, n_inputs: int, inplace: bool):
        # the backward runs inside too: a recompute replays the forward
        with self._context():
            return super()._body(datas, n_inputs, inplace)

    def _loss(self, datas, n_inputs: int):
        loss = super()._loss(datas, n_inputs)
        w = _count_weight(self._loss_fn, datas[n_inputs], self._lgroup,
                          self._mean_n) \
            if self._mean_n > 1 and len(datas) > n_inputs else None
        return loss if w is None else loss * w

    def _forward(self, *inputs):
        if self._config.remat:
            from paddle_tpu_torch.distributed.fleet.recompute import recompute

            return recompute(self._model, *inputs)
        return self._model(*inputs)

    def _sync(self, grads, loss):
        g = self._lgroup
        if g is not None and g.nranks > 1:
            loss = loss.float().clone()
            comm.all_reduce_(loss, comm.ReduceOp.SUM, g)
            if not self._sums:
                loss = loss / g.nranks
        mp = self._mesh.group("mp") if self._mesh.dim_size("mp") > 1 \
            else None
        comm.all_reduce_into([grads[i] for i in self._sp_idx], mp)
        grads = list(grads)
        if self._rs_idx:
            sl = _reduce_scatter_slices(
                [grads[i] for i in self._rs_idx],
                [self._plan_list[i].zero_dim for i in self._rs_idx],
                self._zgroup)
            for i, s in zip(self._rs_idx, sl):
                grads[i] = s.to(grads[i].dtype)
        scale = None if self._sums or self._mean_n == 1 \
            else 1.0 / self._mean_n
        for group, idx in self._ar:
            comm.all_reduce_into([grads[i] for i in idx], group, scale)
        return grads, loss

    def _agree(self, flag: torch.Tensor) -> torch.Tensor:
        g = self._world
        if g is None or g.nranks == 1:
            return flag
        f = flag.float().reshape(1).clone()
        comm.all_reduce_(f, comm.ReduceOp.MAX, g)
        return f[0] > 0

    def _sum_over(self, sq: List[torch.Tensor], axes: List[tuple]):
        """Each squared norm summed over the groups of its axes (one
        collective per set of axes)."""
        by: Dict[tuple, List[int]] = {}
        for i, a in enumerate(axes):
            if a:
                by.setdefault(a, []).append(i)
        out = list(sq)
        for a, idx in by.items():
            t = torch.stack([sq[i] for i in idx])
            comm.all_reduce_(t, comm.ReduceOp.SUM, self._mesh.group(a))
            for j, i in enumerate(idx):
                out[i] = t[j]
        return out

    def _clip(self, grads):
        from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm,
                                              ClipGradByNorm)

        clip = self._opt._grad_clip
        if not grads or not isinstance(clip, (ClipGradByGlobalNorm,
                                              ClipGradByNorm)):
            return super()._clip(grads)
        sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
              for g in grads]
        sq = self._sum_over(sq, self._grad_axes)
        if isinstance(clip, ClipGradByGlobalNorm):
            gn = torch.stack(sq).sum().sqrt()
            scale = clip.clip_norm / torch.clamp(gn, min=clip.clip_norm)
            torch._foreach_mul_(grads, scale)
        else:
            for g, s in zip(grads, sq):
                g.mul_(torch.clamp(clip.clip_norm / torch.clamp(
                    s.sqrt(), min=1e-12), max=1.0))
        return grads

    def _update(self, grads, step, skip, inplace: bool):
        targets, gs, norm_reduce = [], [], []
        for p, g, plan, axes in zip(self._params, grads, self._plan_list,
                                    self._target_axes):
            if self._sliced(plan):
                targets.append(self._slice(p, plan))
                gs.append(g if self._stage == 2 else self._slice(g, plan))
            else:
                targets.append(p)
                gs.append(g)
            group = self._mesh.group(axes) if axes else None
            norm_reduce.append(None if group is None else
                               (lambda s, g_=group: comm.all_reduce_(
                                   s, comm.ReduceOp.SUM, g_)))
        self._opt._apply(self._params, gs, self._lr, step, skip=skip,
                         cast_grads=False, inplace=True, targets=targets,
                         norm_reduce=norm_reduce)
        sliced = [i for i, pl in enumerate(self._plan_list)
                  if self._sliced(pl)]
        if sliced and self._zgroup.nranks > 1:
            _all_gather_slices([self._params[i].data for i in sliced],
                               [self._plan_list[i].zero_dim
                                for i in sliced], self._zgroup)

    def _wd_tag(self) -> str:
        return f"ParallelTrainStep#{self._opt._step_count + 1}"

    def __call__(self, *batch, n_model_inputs: Optional[int] = None):
        return super().__call__(
            *batch, n_model_inputs=self._n_inputs if n_model_inputs is None
            else n_model_inputs)

    def run_steps(self, k, *batch, n_model_inputs: Optional[int] = None,
                  stacked: bool = False):
        return super().run_steps(
            k, *batch, n_model_inputs=self._n_inputs if n_model_inputs
            is None else n_model_inputs, stacked=stacked)

    # -- what a caller reads -----------------------------------------------
    def layouts(self) -> Dict[str, object]:
        """Each parameter's :class:`~paddle_tpu_torch.distributed.
        redistribute.Layout` at rest, by name: rank i's shard is shard i
        of the layout when the mesh's ids are 0..n-1 in C order."""
        return {n: p._dist_plan.layout(self._mesh)
                for n, p in _named_params(self._model)}

    def shard_layouts(self):
        """``(tensor, Layout, global shape, shard index, mesh ids)`` for
        each parameter shard and optimizer slot this rank holds: what a
        multi-rank checkpoint writes and loads (``checkpoint.
        register_layouts``). A slot takes its parameter's layout, plus
        the ZeRO axis on its slice at stages 1 and 2; a slot of another
        shape (a scalar) is left out, as replicated."""
        from paddle_tpu_torch.distributed.env import get_rank
        from paddle_tpu_torch.distributed.redistribute import Layout

        ids = self._mesh.process_ids
        me = get_rank()
        if me not in ids:
            return
        index = ids.index(me)
        axes = list(zip(self._mesh.dim_names, self._mesh.shape))
        for p, plan in zip(self._params, self._plan_list):
            lay = plan.layout(self._mesh)
            yield p, lay, plan.global_shape, index, ids
            slot_lay = lay
            if self._sliced(plan):
                dims = list(lay.dim_placements)
                dims[plan.zero_dim] = plan.zero_axis
                slot_lay = Layout(axes, dims)
            want = slot_lay.local_shape(plan.global_shape)
            for v in self._opt._slots.get(id(p), {}).values():
                if isinstance(v, torch.Tensor) and tuple(v.shape) == want:
                    yield v, slot_lay, plan.global_shape, index, ids

    def slot_bytes(self) -> int:
        """Bytes of this rank's optimizer slots (master weights
        included)."""
        return sum(v.numel() * v.element_size()
                   for p in self._params
                   for v in self._opt._slots[id(p)].values())
