"""Pipeline-parallel train step (port of
``paddle_tpu/distributed/fleet/pp_engine.py``).

The JAX package builds ONE XLA program for: pre (embedding) ->
``ppermute``-rotated pipeline body over the ``pp`` mesh axis -> post
(norm, head) -> loss -> backward -> optimizer, with dp and mp left to
GSPMD. Here each rank of the mesh runs its share of that program, one
process per rank over ``torch.distributed``:

* **the chunk is the unit of pre, post and loss**, as in the JAX step's
  ``chunk_loss``: the batch splits into ``n_chunks`` chunks of
  ``CM`` microbatches ("1f1b": CM = S V, so in-flight activations are
  capped at one ring; "gpipe", "zero_bubble", "interleave": one chunk of
  all M). For each chunk, pp rank 0 runs the pre section over the whole
  chunk and feeds its microbatches into the ring; the body rotation runs
  the JAX package's ticks (:class:`~paddle_tpu_torch.distributed.fleet.
  pipeline_parallel._Rotation`, P2P to the next rank, wrapping to rank
  0 for the next virtual stage); the last stage gathers the chunk's
  outputs, runs post and ``loss_fn`` over the whole chunk and starts the
  backward, which runs the ticks in reverse. The chunk gradients add up
  in f32 for 16-bit parameters (the JAX ``_grad_dtype``), then are
  divided by the chunk count, and the loss is the mean of the chunk
  losses. "zero_bubble" runs "gpipe"'s chunking, as the JAX step does;
* **pre and post live sliced over pp** (``shard_pre_post=True``): each pp
  rank keeps 1/S of every pre and post parameter, and of its slots, along
  the first dim pp divides after the mp hints (the JAX package's
  ``_pspec_from_hints(extra_axis=pp)``). At each step the pp ranks
  all-gather them, rank 0 and rank S-1 compute with the whole
  parameters, and the gradients are reduce-scattered back onto the
  slices. A tied weight (``SharedLayerDesc``) is one parameter in both
  sections: its gradients from the embedding (rank 0) and from the head
  (rank S-1) add in that reduce-scatter, it is updated once, and both
  uses read the same slice; it holds one set of slots. With
  ``shard_pre_post=False`` every pp rank holds them whole and their
  gradients are summed over pp;
* **dp and mp inside pp.** The batch splits over ``dp_axis`` chunk by
  chunk (each dp rank a contiguous share of every chunk), and the
  gradients are averaged over it; the parameters with mp hints are cut
  by :func:`~paddle_tpu_torch.distributed.engine.shard_model_parameters`
  and the Llama's modules bind the mp group, as in ``ParallelTrainStep``;
* **after the backward** come the scaler's unscale and ``found_inf``, the
  ``skip_nonfinite`` guard (both flags all-reduced by max over the whole
  mesh, so every rank skips together), the clip (squared norms summed
  over the ranks that split each JAX leaf: pp for the body's stacked
  leaves and the sliced pre/post, mp for mp-cut ones; a replicated
  parameter counted once) and the update; a skipped step rolls the step
  counter and the pre/post buffers back, as the JAX step does;
* **randomness** follows the JAX step's chain: ``chain, key =
  split(chain)``, one key per chunk (``split(key, C)``), then ``k1, k2,
  k3 = split(k, 3)`` for pre, body and post; every body layer at every
  tick draws from a fresh stream of the same ``k2`` (the JAX
  ``_rotated_forward`` hands ``k2`` to each layer), and a dp rank draws
  its rows of the whole batch's masks;
* **remat_body** recomputes each body layer in the backward
  (:func:`~paddle_tpu_torch.distributed.fleet.recompute.recompute`);
* **context parallelism**: where the body declares a sequence axis (the
  context-parallel ``LlamaForCausalLMPipe``), each microbatch's sequence
  is cut over it, the body attends over the ring, and the loss and the
  gradients are averaged over it with dp (a mean over labels not
  ignored weighted by each rank's count), as in ``ParallelTrainStep``;
* **Lamb** takes one trust ratio per parameter, as the JAX package's
  ``TrainStep`` and PaddlePaddle do: a parameter's squared norms are
  summed over the ranks that split it (mp, and pp for a pre/post slice).
  The JAX pipeline step takes one per stacked body leaf, every layer's
  copy of a weight at once; that quirk is not copied;
* **checkpoints**: the step registers where each of its tensors lies
  (:meth:`PipelineTrainStep.shard_layouts`), so a multi-rank checkpoint
  of :meth:`PipelineTrainStep.state_dict` writes each chunk once, a body
  layer's by a rank of its stage, and restores at any pp degree.

A failure on one rank fails the step on every rank: the others stop in
their next exchange or collective with the group's error. There is no
retry and no fallback to one rank.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch

from paddle_tpu_torch import amp as _amp
from paddle_tpu_torch.core import generator as gen
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.distributed import communication as comm
from paddle_tpu_torch.distributed.engine import (
    ParallelConfig, _all_gather_slices, _count_weight, _is_share, _plan_for,
    _reduce_scatter_slices, _tensor, current_mesh, sequence_axis,
    set_current_mesh, shard_model_parameters)
from paddle_tpu_torch.distributed.fleet.pipeline_parallel import (
    _Rotation, _call, _ticks, _vpp_schedule, layer_perm)
from paddle_tpu_torch.distributed.mesh import ProcessMesh
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.ops import threefry

__all__ = ["PipelineTrainStep"]

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.bool]


def _entries(section) -> list:
    """A section's layers (a LayerDict or ModuleDict by key, a LayerList
    in order)."""
    return list(section.values()) if hasattr(section, "values") \
        else list(section)


def _walk(section):
    """Every (sub)module or sublayer of a section."""
    out = []
    for e in _entries(section):
        out += list(e.modules()) if isinstance(e, torch.nn.Module) \
            else e.sublayers(include_self=True)
    return out


def _trainable(p) -> bool:
    return p.requires_grad if isinstance(p, torch.Tensor) \
        else not p.stop_gradient


def _buf(holder, name) -> torch.Tensor:
    """The torch tensor of buffer ``name`` of a module or Layer."""
    b = holder._buffers[name]
    return b._data if isinstance(b, Tensor) else b


def _bcast_meta(t: Optional[torch.Tensor], src: int, group
                ) -> Tuple[tuple, torch.dtype]:
    """``t``'s shape and dtype (known on global rank ``src``) on every
    rank of ``group``."""
    meta = torch.zeros(10, dtype=torch.int64)
    if t is not None:
        meta[0] = _DTYPES.index(t.dtype)
        meta[1] = t.dim()
        meta[2:2 + t.dim()] = torch.tensor(t.shape)
    comm.broadcast_(meta, src, group)
    n = int(meta[1])
    return tuple(int(v) for v in meta[2:2 + n]), _DTYPES[int(meta[0])]


class PipelineTrainStep:
    SCHEDULES = ("1f1b", "gpipe", "interleave", "zero_bubble")

    def __init__(self, pipe_layer, loss_fn: Callable, optimizer,
                 mesh: ProcessMesh, n_microbatches: int = None,
                 pp_axis: str = "pp", dp_axis: str = "dp",
                 remat_body: bool = True, scaler=None,
                 shard_pre_post: bool = True, schedule: str = "1f1b",
                 interleave_degree: int = 2,
                 skip_nonfinite: bool = False):
        """``schedule`` selects the microbatch schedule (the reference's
        pipeline_scheduler passes):

        - "1f1b": chunks of S V microbatches, gradients accumulated over
          the chunks; in-flight activations capped at one chunk, ramp
          bubble (S-1)/(2S-1) a chunk.
        - "gpipe": all M microbatches in one rotation; bubble
          (S-1)/(M+S-1), activations of M microbatches live.
        - "interleave": true VPP, ``interleave_degree`` non-contiguous
          layer chunks a rank, ONE scheduled chunk a tick
          (``_vpp_schedule``); bubble (S-1)/(M V+S-1). The
          ``PipelineLayer`` must be cut for it
          (``num_virtual_pipeline_stages``).
        - "zero_bubble": gpipe's chunking (the JAX step leaves the B/W
          split to XLA's scheduler; here it is left for later).

        ``optimizer=None`` makes a forward-only pipeline
        (:meth:`predict`)."""
        from paddle_tpu_torch.distributed.env import get_rank

        self._pipe = pipe_layer
        self._loss_fn = loss_fn
        self._opt = optimizer
        self._mesh = mesh
        self._pp_axis = pp_axis
        self._dp_axis = dp_axis
        self.S = mesh.get_dim_size(pp_axis) if pp_axis in mesh.dim_names \
            else 1
        if schedule not in self.SCHEDULES:
            raise ValueError(f"schedule must be one of {self.SCHEDULES}, "
                             f"got {schedule!r}")
        self.schedule = schedule
        self.V = interleave_degree if schedule == "interleave" else 1
        if self.V < 1:
            raise ValueError("interleave_degree must be >= 1")
        ring = self.S * self.V
        M = n_microbatches or ring
        self._chunk_mb = M if schedule in ("gpipe", "zero_bubble",
                                           "interleave") else ring
        if M % self._chunk_mb:
            raise ValueError(
                f"n_microbatches ({M}) must be a multiple of the chunk "
                f"size ({self._chunk_mb} = ring depth {ring} for "
                f"{schedule!r})")
        self.M = M
        self.n_chunks = M // self._chunk_mb
        self._remat = remat_body
        self._scaler = scaler if scaler is not None and scaler.is_enable() \
            else None
        self._skip_nonfinite = bool(skip_nonfinite)
        S, V = self.S, self.V
        L = pipe_layer.n_body_layers
        if V > 1 and S > 1 and L % (S * V):
            raise ValueError(
                f"interleave needs layers ({L}) divisible by "
                f"stages*degree ({S}*{V})")
        if pipe_layer.num_stages != S:
            raise ValueError(f"the PipelineLayer has {pipe_layer.num_stages}"
                             f" stages; the mesh's {pp_axis!r} axis {S}")
        self._rot_v = V if S > 1 else 1
        if S > 1 and pipe_layer.num_virtual_pipeline_stages != V:
            raise ValueError(
                f"the PipelineLayer is cut for "
                f"{pipe_layer.num_virtual_pipeline_stages} virtual stages a "
                f"rank; schedule {schedule!r} needs "
                f"num_virtual_pipeline_stages={V}")
        self._layer_perm = layer_perm(L, S, V)
        me = get_rank()
        coord = mesh.coord(me)
        if coord is None:
            raise ValueError(f"rank {me} is not on the mesh "
                             f"{mesh.process_ids}")
        self._pp_index = coord[mesh.dim_names.index(pp_axis)] if S > 1 \
            else 0
        if pipe_layer.stage_id != self._pp_index:
            raise ValueError(f"rank {me} is pp rank {self._pp_index}; its "
                             f"PipelineLayer holds stage "
                             f"{pipe_layer.stage_id}")
        self._first = self._pp_index == 0
        self._last = self._pp_index == S - 1
        self._pp_group = mesh.group(pp_axis) if S > 1 else None
        self._dp_n = mesh.dim_size(dp_axis)
        self._dp_group = mesh.group(dp_axis) if self._dp_n > 1 else None
        self._dp_index = mesh.axis_index((dp_axis,), me) \
            if self._dp_n > 1 else 0
        self._batch_axes = (dp_axis,) if self._dp_n > 1 else ()
        self._mp_group = mesh.group("mp") if mesh.dim_size("mp") > 1 \
            else None
        self._world = mesh.group(tuple(mesh.dim_names))
        self._sums = getattr(loss_fn, "reduction", None) == "sum"
        self._wrap = any(isinstance(e, Layer) for sec in (
            pipe_layer.pre_layers, pipe_layer.body_layers,
            pipe_layer.post_layers) for e in _entries(sec))
        self._pre = _entries(pipe_layer.pre_layers)
        self._post = _entries(pipe_layer.post_layers)
        # this stage's layers by chunk, in the order it applies them
        body = _entries(pipe_layer.body_layers)
        per = len(body) // self._rot_v if body else 0
        self._chunks = [body[c * per:(c + 1) * per]
                        for c in range(self._rot_v)]
        for layer in body:
            bufs = list(layer.buffers()) if isinstance(
                layer, torch.nn.Module) else list(layer.named_buffers())
            if bufs:
                raise NotImplementedError(
                    "pipeline body layers with buffers (e.g. BatchNorm) "
                    "are not supported; use LayerNorm/RMSNorm in the body")

        # ---- placement: mp cuts, then the pp slices of pre and post -----
        cfg = ParallelConfig(dp_axes=(dp_axis,))
        for sec in (pipe_layer.pre_layers, pipe_layer.body_layers,
                    pipe_layer.post_layers):
            shard_model_parameters(sec, mesh, cfg)
        named = list(pipe_layer.named_parameters())
        sections = {id(p): n.split(".", 1)[0] for n, p in reversed(named)}
        self._pp_dim: Dict[int, int] = {}
        if shard_pre_post and S > 1:
            zcfg = ParallelConfig(sharding_stage=1, sharding_axis=pp_axis)
            for name, p in named:
                if sections[id(p)] == "body_layers":
                    continue
                # a step built before on this pipe cut it already
                d = getattr(p, "_pp_dim", None)
                if d is None:
                    d = _plan_for(p, mesh, zcfg).zero_dim
                    if d is None:
                        continue
                    self._cut(p, d)
                    p._pp_dim = d
                self._pp_dim[id(p)] = d
        if optimizer is not None:
            optimizer._follow_wrappers()
        # the sequence axis a context-parallel body declares (bound by
        # shard_model_parameters): each microbatch's sequence is cut over
        # it, and the loss and the gradients are averaged over it with
        # the batch axes, as in ParallelTrainStep
        seq, self._cp_n, self._cp_index, mean_axes = sequence_axis(
            mesh, _walk(pipe_layer.body_layers), self._batch_axes, me)
        self._cp_group = mesh.group(seq) if self._cp_n > 1 else None
        self._mean_n = self._dp_n * self._cp_n
        self._mean_group = mesh.group(mean_axes) if self._mean_n > 1 \
            else None

        # the trainable parameters: pre, body, post (a tied one once)
        self._objs, self._params, self._kinds, self._names = [], [], [], []
        for name, p in named:
            if not _trainable(p):
                continue
            self._objs.append(p)
            self._params.append(_tensor(p))
            self._kinds.append(sections[id(p)].split("_")[0])
            self._names.append(name)
        self._device = self._params[0].device if self._params else \
            torch.device("cpu")
        # the JAX leaf each parameter belongs to: a body parameter's leaf
        # is its position in its layer (the stacked leaf over all
        # layers); every other parameter is a leaf of its own
        leaf_of = {}
        for layer in body:
            ps = [p for _, p in layer.named_parameters() if _trainable(p)]
            for i, p in enumerate(ps):
                leaf_of[id(p)] = ("body", i)
        self._leaf = [leaf_of.get(id(o), ("own", i))
                      for i, o in enumerate(self._objs)]
        # the axes each gradient is split over when the update sees it
        self._axes = []
        for o, kind in zip(self._objs, self._kinds):
            plan = o._dist_plan
            ax = tuple(sorted(set(plan.dims.values()),
                              key=mesh.dim_names.index))
            if S > 1 and (kind == "body" or id(o) in self._pp_dim):
                ax = tuple(sorted(set(ax) | {pp_axis},
                                  key=mesh.dim_names.index))
            self._axes.append(ax)
        self._sp_idx = [i for i, o in enumerate(self._objs)
                        if o._dist_plan.sp]
        # Lamb's trust ratio is per parameter (not per stacked body leaf,
        # as the JAX step takes it): a squared norm is summed over the
        # ranks that split the parameter itself, mp for an mp shard and
        # pp for a pre/post slice
        self._norm_reduce = []
        for o in self._objs:
            ax = set(o._dist_plan.dims.values())
            if id(o) in self._pp_dim:
                ax.add(pp_axis)
            g = mesh.group(tuple(sorted(ax, key=mesh.dim_names.index))) \
                if ax else None
            self._norm_reduce.append(
                None if g is None or g.nranks == 1 else
                (lambda s, g_=g: comm.all_reduce_(s, comm.ReduceOp.SUM,
                                                  g_)))
        # where each pre/post parameter sits in its modules (a tied one
        # in both sections)
        self._holders: Dict[int, list] = {}
        for sec in (pipe_layer.pre_layers, pipe_layer.post_layers):
            for m in _walk(sec):
                for n, p in m._parameters.items():
                    if p is not None:
                        self._holders.setdefault(id(p), []).append((m, n))
        self._pre_bufs = [b for m in _walk(pipe_layer.pre_layers)
                          for b in self._buffers_of(m)]
        self._post_bufs = [b for m in _walk(pipe_layer.post_layers)
                           for b in self._buffers_of(m)]

        if optimizer is not None:
            if optimizer._parameter_list is None:
                optimizer._parameter_list = list(self._params)
            for name, t in zip(self._names, self._params):
                optimizer._model_names.setdefault(id(t), name)
            for t in self._params:
                if id(t) not in optimizer._slots:
                    optimizer._slots[id(t)] = optimizer._init_slots_mp(t)
        dev = self._device
        step0 = 0 if optimizer is None else optimizer._step_count
        self._step = torch.tensor(float(step0), device=dev)
        self._nskip = torch.zeros((), device=dev)
        self._lr = torch.zeros((), device=dev)
        self._lr_val: Optional[float] = None
        self._host_step_mirror = step0
        self._chain = torch.tensor(gen.default_generator.next_key(),
                                   dtype=torch.int64, device=dev)
        self._scaler_state = _amp.scaler_init_state(self._scaler, dev)
        if self._skip_nonfinite and optimizer is not None:
            from paddle_tpu_torch.jit.train import (
                install_nonfinite_observability)

            install_nonfinite_observability(self, optimizer)
        self._act_meta: Dict[tuple, tuple] = {}
        from paddle_tpu_torch.distributed.checkpoint import register_layouts

        register_layouts(self)

    # ------------------------------------------------------------------
    @staticmethod
    def _buffers_of(m):
        """(holder, name) of the buffers ``m`` holds itself."""
        return [(m, n) for n, b in m._buffers.items() if b is not None]

    def _cut(self, p, dim: int):
        """Cut parameter ``p`` to this pp rank's slice of ``dim`` in
        place."""
        data = _tensor(p)
        n = self.S
        if data.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {data.shape[dim]} does not "
                             f"split over {n} pp ranks")
        local = data.detach().chunk(n, dim=dim)[self._pp_index].clone()
        if isinstance(p, torch.Tensor):
            p.data = local
        else:
            p._data = local.requires_grad_(data.requires_grad)

    @property
    def skipped_steps(self) -> int:
        """Steps the ``skip_nonfinite`` guard turned into identity
        updates."""
        return int(self._nskip.item())

    @property
    def bubble_fraction(self) -> float:
        """Ramp-bubble fraction of the chosen schedule; for interleave
        from the VPP schedule's tick count, each tick 1/V of a stage."""
        if self.schedule == "interleave":
            T = _vpp_schedule(self._chunk_mb, self.S, self.V)[0]
            return (T - self._chunk_mb * self.V) / T
        return (self.S - 1) / (self._chunk_mb + self.S - 1)

    # -- the batch ---------------------------------------------------------
    def _as_batch(self, x) -> torch.Tensor:
        from paddle_tpu_torch.jit.train import _as_data

        return _as_data(x).to(self._device, non_blocking=True)

    def _share(self, x, chunks: int, what: str) -> torch.Tensor:
        """This dp rank's rows: a contiguous share of each of ``chunks``
        chunks of the batch. A batch placed over dp (mesh-placed
        prefetch) holds the rank's contiguous share of the whole batch:
        that is its share of the one chunk, and with more chunks the
        batch is gathered over dp and cut as a global batch is."""
        n = self._dp_n
        local = None
        if _is_share(x, self._mesh, self._batch_axes, 0):
            local = self._as_batch(x._data.to_local())
            rows = local.shape[0] * n
        else:
            t = self._as_batch(x)
            rows = t.shape[0]
            if n == 1:
                return t
        per = rows // chunks
        if per % (n * self._chunk_mb):
            raise ValueError(
                f"{what}: a chunk of {per} rows does not split into "
                f"{self._chunk_mb} microbatches on each of the {n} ranks "
                f"of {self._dp_axis!r}")
        if local is not None:
            if chunks == 1:
                return local
            t = comm.all_gather_cat(local.contiguous(), 0, self._dp_group)
        k = per // n
        t = t.reshape((chunks, per) + tuple(t.shape[1:]))
        t = t[:, self._dp_index * k:(self._dp_index + 1) * k]
        return t.reshape((chunks * k,) + tuple(t.shape[2:]))

    def _seq_chunk(self, t: torch.Tensor, what: str) -> torch.Tensor:
        """This rank's chunk of dim 1 (the sequence) over the
        context-parallel axis."""
        n = self._cp_n
        if n == 1:
            return t
        if t.dim() < 2 or t.shape[1] % n:
            raise ValueError(f"{what}: a sequence of {tuple(t.shape)[1:2]} "
                             f"does not split over the {n} context-parallel "
                             f"ranks")
        return t.chunk(n, dim=1)[self._cp_index]

    # -- the sections ------------------------------------------------------
    def _seq(self, layers, x):
        for layer in layers:
            x = _call(layer, x)
        return x

    def _loss_of(self, out, y) -> torch.Tensor:
        outs = out if isinstance(out, tuple) else (out,)
        if self._wrap and not isinstance(self._loss_fn, torch.nn.Module):
            loss = self._loss_fn(*[Tensor._from_data(o) for o in outs],
                                 Tensor._from_data(y))
        else:
            loss = self._loss_fn(*outs, y)
        ld = loss._data if isinstance(loss, Tensor) else loss
        ld = ld.mean() if ld.dim() > 0 else ld
        # a mean over the labels it does not ignore: weighted so that the
        # dp mean is the chunk's loss over all its rows, as in the JAX step
        w = _count_weight(self._loss_fn, y, self._mean_group, self._mean_n)
        return ld if w is None else ld * w

    @contextlib.contextmanager
    def _view(self, index: int):
        """A dp rank's draws take its share ``index`` of the whole
        rows' masks."""
        if self._dp_n > 1:
            with gen.batch_view(0, self._dp_n, index):
                yield
        else:
            yield

    def _apply_chunk(self, c: int, m: int, h, k2, grad: bool):
        """This rank's chunk ``c`` on microbatch ``m``: each layer under a
        fresh stream of ``k2``, recomputed in the backward with
        remat."""
        from paddle_tpu_torch.distributed.fleet.recompute import recompute

        # microbatch m's rows are share (d CM + m) mod dp of a JAX
        # microbatch, whose masks all draw from the same k2
        idx = (self._dp_index * self._chunk_mb + m) % self._dp_n
        with self._view(idx):
            for layer in self._chunks[c]:
                with gen.device_key_stream(k2):
                    h = recompute(_call, layer, h) if grad and self._remat \
                        else _call(layer, h)
        return h

    # -- pre / post parameters ---------------------------------------------
    def _gather(self, want: bool):
        """All-gather the pp-sliced pre/post parameters (every pp rank
        takes part); where ``want``, put the whole ones in their modules.
        Returns {id(param): whole leaf}."""
        idx = [i for i, o in enumerate(self._objs) if id(o) in self._pp_dim]
        if not idx:
            return {}
        fulls, dims = [], []
        for i in idx:
            o = self._objs[i]
            d = self._pp_dim[id(o)]
            t = self._params[i].detach()
            shape = list(t.shape)
            shape[d] *= self.S
            full = torch.empty(shape, dtype=t.dtype, device=t.device)
            full.chunk(self.S, dim=d)[self._pp_index].copy_(t)
            fulls.append(full)
            dims.append(d)
        _all_gather_slices(fulls, dims, self._pp_group)
        if not want:
            return {}
        out = {}
        for i, full in zip(idx, fulls):
            o = self._objs[i]
            leaf = full.requires_grad_(True)
            out[id(o)] = leaf
            self._swap(o, leaf)
        return out

    def _swap(self, o, t):
        if isinstance(o, torch.Tensor):
            for holder, n in self._holders.get(id(o), ()):
                holder._parameters[n] = t
        else:
            o._data = t

    def _restore(self, swapped: dict):
        for i, o in enumerate(self._objs):
            if id(o) in swapped:
                if isinstance(o, torch.Tensor):
                    for holder, n in self._holders.get(id(o), ()):
                        holder._parameters[n] = o
                else:
                    o._data = self._params[i]

    # -- the step ----------------------------------------------------------
    @contextlib.contextmanager
    def _context(self):
        from paddle_tpu_torch.nn import norm

        prev = current_mesh()
        set_current_mesh(self._mesh)
        try:
            with norm.batch_stats_group(self._dp_group):
                yield
        finally:
            set_current_mesh(prev)

    def _like(self, h: Optional[torch.Tensor], key) -> torch.Tensor:
        """An activation's shape and dtype on every pp rank (rank 0 has
        ``h``; one broadcast per new batch shape)."""
        if self.S == 1:
            return h
        if key not in self._act_meta:
            self._act_meta[key] = _bcast_meta(h, self._pp_group.ranks[0],
                                              self._pp_group)
        shape, dtype = self._act_meta[key]
        return torch.empty(shape, dtype=dtype, device=self._device)

    def _forward(self, xc, keys, rot, key, grad: bool):
        """The forward of one chunk on this rank: pre over the chunk on pp
        rank 0, its microbatches through the body rotation, post over
        the gathered outputs on the last stage. Returns (pre's output on
        rank 0, the rotation's outputs as leaves on the last stage, the
        activation's shape, post's output on the last stage)."""
        k1, k2, k3 = keys
        CM = self._chunk_mb
        h = leaves = out = None
        mbs = [None] * CM
        if self._first:
            with gen.device_key_stream(k1), self._view(self._dp_index):
                h = self._seq(self._pre, xc)
            mbs = list(h.chunk(CM))
        like = self._like(mbs[0], key)
        done = rot.forward(lambda c, m, t: self._apply_chunk(c, m, t, k2,
                                                             grad),
                           mbs, like, grad=grad)
        if self._last:
            leaves = [done[m].detach().requires_grad_(grad)
                      for m in range(CM)]
            with gen.device_key_stream(k3), self._view(self._dp_index):
                out = self._seq(self._post, torch.cat(leaves))
        return h, leaves, like, out

    def _chunk(self, xc, yc, keys, rot, key):
        """Forward and backward of one chunk on this rank; the chunk's
        loss on the last stage (else None)."""
        CM = self._chunk_mb
        h, leaves, like, out = self._forward(xc, keys, rot, key, True)
        loss = None
        grads_out = {}
        if self._last:
            loss = self._loss_of(out, yc)
            state = self._scaler_state
            (loss if state is None else loss * state[0]).backward()
            grads_out = {m: leaves[m].grad if leaves[m].grad is not None
                         else torch.zeros_like(leaves[m])
                         for m in range(CM)}
        first = rot.backward(grads_out, like)
        if self._first:
            torch.autograd.backward(h, torch.cat([first[m]
                                                  for m in range(CM)]))
        return None if loss is None else loss.detach()

    def _grads_of(self, swapped) -> List[Optional[torch.Tensor]]:
        out = []
        for o, t in zip(self._objs, self._params):
            leaf = swapped.get(id(o), t)
            g = leaf.grad
            leaf.grad = None
            out.append(g)
        return out

    def _sync_step_carry(self):
        if self._opt._step_count != self._host_step_mirror:
            self._step.fill_(float(self._opt._step_count))
            self._host_step_mirror = self._opt._step_count

    def __call__(self, x, y):
        if self._opt is None:
            raise RuntimeError("a PipelineTrainStep without an optimizer "
                               "only predicts")
        shared = _is_share(x, self._mesh, self._batch_axes, 0)
        B = self._as_batch(x._data.to_local() if shared else x).shape[0] * (
            self._dp_n if shared else 1)
        if B % self.M:
            raise ValueError(
                f"batch size {B} must be a multiple of "
                f"n_microbatches ({self.M} = {self.n_chunks} chunks x "
                f"{self._chunk_mb} microbatches/chunk, schedule="
                f"{self.schedule}); pad the batch or adjust "
                f"accumulate_steps")
        C = self.n_chunks
        xs = self._seq_chunk(self._share(x, C, "the batch"),
                             "the batch").chunk(C)
        ys = self._seq_chunk(self._share(y, C, "the labels"),
                             "the labels").chunk(C)
        self._sync_step_carry()
        self._opt._step_count += 1
        self._host_step_mirror = self._opt._step_count
        lr = float(torch.tensor(self._opt.get_lr(), dtype=torch.float32))
        if lr != self._lr_val:
            self._lr.fill_(lr)
            self._lr_val = lr
        with self._context():
            loss = self._step_body(xs, ys)
        if self._scaler_state is not None:
            _amp.scaler_sync_from_state(self._scaler, self._scaler_state)
        return loss

    def _step_body(self, xs, ys):
        S, C = self.S, self.n_chunks
        snap = None
        if self._skip_nonfinite:
            snap = [(h, n, _buf(h, n).clone())
                    for h, n in self._pre_bufs + self._post_bufs]
        swapped = self._gather(self._first or self._last)
        rot = _Rotation(self._pp_group, S, self._rot_v,
                        _ticks(self._chunk_mb, S, self._rot_v))
        key = (tuple(xs[0].shape), xs[0].dtype)
        acc: List[Optional[torch.Tensor]] = [None] * len(self._params)
        lsum = torch.zeros((), dtype=torch.float32, device=self._device)
        try:
            pair = threefry.split(self._chain)
            self._chain.copy_(pair[0])
            keys = threefry.split(pair[1], C)
            for c in range(C):
                lc = self._chunk(xs[c], ys[c],
                                 threefry.split(keys[c], 3).unbind(0), rot,
                                 key)
                if lc is not None:
                    lsum = lsum + lc.float()
                for i, g in enumerate(self._grads_of(swapped)):
                    if g is None:
                        continue
                    wide = g.float() if g.dtype in (torch.bfloat16,
                                                    torch.float16) else g
                    acc[i] = wide if acc[i] is None else acc[i] + wide
        finally:
            self._restore(swapped)
        grads = []
        for i, (o, t) in enumerate(zip(self._objs, self._params)):
            g = acc[i]
            if g is None:
                shape = list(t.shape)
                if id(o) in self._pp_dim:
                    shape[self._pp_dim[id(o)]] *= S
                wide = t.dtype in (torch.bfloat16, torch.float16)
                g = torch.zeros(shape, device=t.device,
                                dtype=torch.float32 if wide else t.dtype)
            grads.append(g / C)
        loss = lsum / C
        grads, loss = self._sync(grads, loss)
        return self._finish(grads, loss, snap)

    def _sync(self, grads, loss):
        """The gradients the update sees: pre/post over pp (onto the
        slices, or summed), SP ones over mp, all averaged over dp; the
        loss from the last stage on every rank."""
        S = self.S
        if S > 1:
            sl = [i for i, o in enumerate(self._objs)
                  if id(o) in self._pp_dim]
            if sl:
                got = _reduce_scatter_slices(
                    [grads[i] for i in sl],
                    [self._pp_dim[id(self._objs[i])] for i in sl],
                    self._pp_group)
                for i, s in zip(sl, got):
                    grads[i] = s.to(grads[i].dtype).contiguous()
            rep = [i for i, k in enumerate(self._kinds)
                   if k != "body" and id(self._objs[i]) not in self._pp_dim]
            comm.all_reduce_into([grads[i] for i in rep], self._pp_group)
            comm.broadcast_(loss, self._pp_group.ranks[S - 1],
                            self._pp_group)
        comm.all_reduce_into([grads[i] for i in self._sp_idx],
                             self._mp_group)
        if self._mean_group is not None:
            comm.all_reduce_(loss, comm.ReduceOp.SUM, self._mean_group)
            if not self._sums:
                loss = loss / self._mean_n
            comm.all_reduce_into(grads, self._mean_group,
                                 None if self._sums else 1.0 / self._mean_n)
        return grads, loss

    def _agree(self, flag: torch.Tensor) -> torch.Tensor:
        g = self._world
        if g is None or g.nranks == 1:
            return flag
        f = flag.float().reshape(1).clone()
        comm.all_reduce_(f, comm.ReduceOp.MAX, g)
        return f[0] > 0

    def _clip(self, grads):
        from paddle_tpu_torch.nn.clip import (ClipGradByGlobalNorm,
                                              ClipGradByNorm)

        clip = self._opt._grad_clip
        if not grads or clip is None:
            return grads
        if not isinstance(clip, (ClipGradByGlobalNorm, ClipGradByNorm)):
            return clip.clip_fn(grads)
        # each JAX leaf's squared norm: the rank's parts, summed over the
        # ranks that split it
        leaves: Dict[tuple, torch.Tensor] = {}
        axes_of: Dict[tuple, tuple] = {}
        for g, leaf, ax in zip(grads, self._leaf, self._axes):
            sq = torch.linalg.vector_norm(g, dtype=torch.float32).square()
            leaves[leaf] = leaves[leaf] + sq if leaf in leaves else sq
            axes_of[leaf] = ax
        by: Dict[tuple, list] = {}
        for leaf, ax in axes_of.items():
            if ax:
                by.setdefault(ax, []).append(leaf)
        for ax, keys in by.items():
            t = torch.stack([leaves[k] for k in keys])
            comm.all_reduce_(t, comm.ReduceOp.SUM, self._mesh.group(ax))
            for j, k in enumerate(keys):
                leaves[k] = t[j]
        if isinstance(clip, ClipGradByGlobalNorm):
            # the leaves of the whole model: the body's stacked leaves
            # once (their sums already span the ranks)
            gn = torch.stack(list(leaves.values())).sum().sqrt()
            scale = clip.clip_norm / torch.clamp(gn, min=clip.clip_norm)
            torch._foreach_mul_(grads, scale)
        else:
            for g, leaf in zip(grads, self._leaf):
                g.mul_(torch.clamp(clip.clip_norm / torch.clamp(
                    leaves[leaf].sqrt(), min=1e-12), max=1.0))
        return grads

    @torch.no_grad()
    def _finish(self, grads, loss, snap):
        state = self._scaler_state
        step = self._step + 1
        found_inf = new_state = None
        if state is not None:
            grads, found_inf = _amp.scaler_unscale_and_check(grads, state)
            found_inf = self._agree(found_inf)
            new_state = _amp.scaler_update_state(self._scaler, state,
                                                 found_inf)
        nonfinite = None
        if self._skip_nonfinite:
            from paddle_tpu_torch.jit.train import nonfinite_any

            nonfinite = self._agree(nonfinite_any(loss, grads))
        grads = self._clip(grads)
        skip = found_inf
        if nonfinite is not None:
            skip = nonfinite if skip is None else skip | nonfinite
        self._opt._apply(self._params, grads, self._lr, step, skip=skip,
                         cast_grads=False, inplace=True,
                         norm_reduce=self._norm_reduce)
        if nonfinite is not None:
            self._nskip.add_(nonfinite.float())
            step = torch.where(nonfinite, step - 1, step)
            for holder, n, old in snap:
                _buf(holder, n).copy_(torch.where(nonfinite, old,
                                                  _buf(holder, n)))
        self._sync_buffers()
        self._step.copy_(step)
        if new_state is not None:
            self._scaler_state.copy_(new_state)
        return loss

    def _sync_buffers(self):
        """The pre buffers from pp rank 0 and the post buffers from the
        last stage on every pp rank (only those ranks ran them)."""
        if self.S == 1:
            return
        for bufs, src in ((self._pre_bufs, 0), (self._post_bufs, self.S - 1)):
            for holder, n in bufs:
                comm.broadcast_(_buf(holder, n), self._pp_group.ranks[src],
                                self._pp_group)

    # -- inference ---------------------------------------------------------
    @torch.no_grad()
    def predict(self, x):
        """The pipeline forward of ``x`` in eval mode: the batch split into
        the training rotation's microbatches, no loss, no update. Every
        rank gets the whole batch's outputs."""
        CM = self._chunk_mb
        share = self._seq_chunk(self._share(x, 1, "the predict batch"),
                                "the predict batch")
        if share.shape[0] % CM:
            raise ValueError(
                f"predict batch size {share.shape[0]} must be a multiple "
                f"of the microbatch count ({CM})")
        key = torch.tensor(gen.default_generator.next_key(),
                           dtype=torch.int64, device=self._device)
        was_training = self._pipe.training
        self._pipe.eval()
        S = self.S
        try:
            with self._context():
                swapped = self._gather(self._first or self._last)
                try:
                    rot = _Rotation(self._pp_group, S, self._rot_v,
                                    _ticks(CM, S, self._rot_v))
                    out = self._forward(
                        share, threefry.split(key, 3).unbind(0), rot,
                        ("predict",) + tuple(share.shape) + (share.dtype,),
                        False)[3]
                finally:
                    self._restore(swapped)
        finally:
            if was_training:
                self._pipe.train()
        if S > 1:
            shape, dtype = _bcast_meta(out, self._pp_group.ranks[S - 1],
                                       self._pp_group)
            if out is None:
                out = torch.empty(shape, dtype=dtype, device=self._device)
            comm.broadcast_(out, self._pp_group.ranks[S - 1],
                            self._pp_group)
        if self._cp_group is not None:
            out = comm.all_gather_cat(out.contiguous(), 1, self._cp_group)
        if self._dp_group is not None:
            out = comm.all_gather_cat(out.contiguous(), 0, self._dp_group)
        return Tensor._from_data(out) if self._wrap else out

    def sync_params_to_model(self):
        """The JAX step writes its stacked body back into the layers.
        Here the stage's layers hold the live parameters and the pre/post
        ones their slices (:meth:`layouts`), so there is nothing to
        write."""

    # -- what a caller reads -----------------------------------------------
    def layouts(self) -> Dict[str, object]:
        """Each parameter of this rank's stage by name, its
        :class:`~paddle_tpu_torch.distributed.redistribute.Layout` over
        the mesh at rest (a body layer's: its mp cut; it lives on the pp
        ranks of its stage)."""
        out = {}
        for name, p in self._pipe.named_parameters():
            plan = p._dist_plan
            dims = dict(plan.dims)
            if id(p) in self._pp_dim:
                dims[self._pp_dim[id(p)]] = self._pp_axis
            from paddle_tpu_torch.distributed.redistribute import Layout

            out[name] = Layout(list(zip(self._mesh.dim_names,
                                        self._mesh.shape)),
                               [dims.get(d) for d in
                                range(len(plan.global_shape))])
        return out

    def shard_layouts(self):
        """``(tensor, Layout, global shape, shard index, mesh ids)`` for
        each parameter and optimizer slot this rank holds: what a
        multi-rank checkpoint writes and loads (``checkpoint.
        register_layouts``). A pre/post parameter's layout is over the
        whole mesh (its pp slice, its mp cut); a body layer's is over its
        stage's ranks only (the mesh without pp), so that one rank of the
        owning stage writes each chunk. A slot takes its parameter's
        layout; a slot of another shape (a scalar) is left out, as
        replicated."""
        from paddle_tpu_torch.distributed.env import get_rank
        from paddle_tpu_torch.distributed.redistribute import Layout

        mesh, me = self._mesh, get_rank()
        if mesh.coord(me) is None:
            return
        whole = (list(zip(mesh.dim_names, mesh.shape)), mesh.process_ids)
        sub = tuple(n for n in mesh.dim_names if n != self._pp_axis)
        stage = ([(n, mesh.get_dim_size(n)) for n in sub]
                 or [(self._pp_axis, 1)],
                 mesh.group_ranks(sub, me) if sub else [me])
        slots = {} if self._opt is None else self._opt._slots
        for name, p in self._pipe.named_parameters():
            plan, t = p._dist_plan, _tensor(p)
            dims = dict(plan.dims)
            if id(p) in self._pp_dim:
                dims[self._pp_dim[id(p)]] = self._pp_axis
            axes, ids = stage if name.startswith("body_layers.") else whole
            lay = Layout(axes, [dims.get(d)
                                for d in range(len(plan.global_shape))])
            index = ids.index(me)
            yield t, lay, plan.global_shape, index, ids
            want = lay.local_shape(plan.global_shape)
            for v in slots.get(id(t), {}).values():
                if isinstance(v, torch.Tensor) and tuple(v.shape) == want:
                    yield v, lay, plan.global_shape, index, ids

    def state_dict(self) -> dict:
        """This rank's training state under the pipeline's global names:
        ``{"model": {parameter name: tensor}, "opt": {"step": n,
        "<parameter name>.<slot>": slot}}``, the live tensors detached.
        Each carries its layout (:meth:`shard_layouts`), so
        ``checkpoint.save_state_dict`` writes every chunk once over the
        ranks and ``load_state_dict`` fills this rank's shards at any pp
        degree. The slots are keyed by name: a position in a stage's
        parameter list (``Optimizer.state_dict``'s ``param_<i>``) names
        a different parameter on each stage."""
        opt_sd = self._opt.state_dict()
        opt = {k: opt_sd[k] for k in ("step", "LR_Scheduler") if k in opt_sd}
        model = {}
        for name, p in self._pipe.named_parameters():
            t = _tensor(p)
            model[name] = t.detach()
            for k, v in self._opt._slots.get(id(t), {}).items():
                opt[f"{name}.{k}"] = v.detach()
        return {"model": model, "opt": opt}

    @torch.no_grad()
    def set_state_dict(self, state: dict):
        """Take :meth:`state_dict`'s keys back: the step count (and the
        scheduler's state), and each tensor that ``load_state_dict`` did
        not fill in place already. A state without slots (the JAX
        package's pipeline checkpoint: parameters and ``{"step": n}``)
        leaves the slots as they are."""
        opt = state.get("opt", {})
        self._opt._step_count = int(opt.get("step", 0))
        if self._opt._lr_scheduler is not None and "LR_Scheduler" in opt:
            self._opt._lr_scheduler.set_state_dict(opt["LR_Scheduler"])
        live = self.state_dict()
        for sec in ("model", "opt"):
            for k, v in state.get(sec, {}).items():
                t = live[sec].get(k)
                if isinstance(t, torch.Tensor) and isinstance(
                        v, torch.Tensor) and v.data_ptr() != t.data_ptr():
                    t.copy_(v.to(device=t.device, dtype=t.dtype))

    def slot_bytes(self) -> int:
        """Bytes of this rank's optimizer slots (master weights
        included)."""
        return sum(v.numel() * v.element_size() for t in self._params
                   for v in self._opt._slots[id(t)].values())

    def param_bytes(self) -> int:
        """Bytes of this rank's parameters (pre/post slices, its body)."""
        return sum(t.numel() * t.element_size() for t in self._params)
