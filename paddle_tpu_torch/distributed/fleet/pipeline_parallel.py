"""Pipeline parallelism (port of
``paddle_tpu/distributed/fleet/pipeline_parallel.py``).

Reference: python/paddle/distributed/fleet/meta_parallel/
pipeline_parallel.py (PipelineParallel:149, train_batch:693) +
parallel_layers/pp_layers.py (LayerDesc:56, PipelineLayer:257) + P2P via
batched isend/irecv (pp_utils/p2p_communication.py:559).

The JAX package runs the pipeline as ONE SPMD program: the body's layers
are stacked on a leading axis sharded over ``pp``, and a ``lax.scan`` of
ticks moves the activations with ``ppermute``. PyTorch's idiom is one
process per rank, so here:

* **a rank builds only its stage.** :class:`PipelineLayer` segments the
  layer list as the JAX package does (the same ``_body_range``, pre,
  body and post, the same errors), builds the pre and post sections on
  every rank (their storage is sliced over ``pp`` by the step) and, of
  the body, keeps the layers its stage owns: ``[r L/S, (r+1) L/S)``, or
  for an interleaved pipeline of ``num_virtual_pipeline_stages`` V the
  chunks of the JAX step's ``_layer_perm``. Every body layer is built in
  the one-rank order and the ones the stage does not own are dropped at
  once, so each rank draws the initialisers a one-rank pipeline draws
  and holds at most one foreign layer at a time. The body entries and
  the sections may be port ``nn.Layer``\\ s or ``torch.nn.Module``\\ s
  (the port's Llama layers are modules);
* **the rotation is an eager loop over the JAX package's ticks.**
  :func:`pipeline_forward` (one chunk of layers a rank) and
  :func:`pipeline_forward_vpp` (``_vpp_schedule``'s interleaved ticks)
  apply, at each tick, the chunk the schedule gives this rank, then
  exchange the tick's activations with the neighbours in one batched
  isend/irecv (staged through the host when gloo carries CUDA tensors).
  The last virtual stage's outputs reach every pp rank, as the JAX
  ``psum`` gives them. :func:`pipeline_forward_interleaved` (the
  conveyor) reaches the same outputs as :func:`pipeline_forward_vpp`.

:class:`PipelineParallel` is the ``fleet.distributed_model`` wrapper
over :class:`~paddle_tpu_torch.distributed.fleet.pp_engine.
PipelineTrainStep`. A port rank holds only its stage, so its
``eval_batch`` and ``forward`` run the pipeline forward (the step's
``predict``) where the JAX package's run the whole model in its global
view.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.nn.layer import Layer, LayerDict, LayerList

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineParallel", "pipeline_forward",
           "pipeline_forward_interleaved", "pipeline_forward_vpp"]


class LayerDesc:
    """Deferred layer construction (reference pp_layers.py:56)."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """Weight-shared layer across stages (reference pp_layers.py:76), e.g.
    a tied embedding and LM head. All SharedLayerDescs with the same
    ``key`` share one parameter (``shared_weight_attr``); the optional
    ``forward_func(layer, x)`` overrides the forward for a secondary use
    (x @ embedding.T for the head). The step sums both uses' gradients
    into one update, so the two uses never hold different values."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _SharedForwardAdapter(Layer):
    """Wraps a shared layer so forward_func(layer, x) drives forward."""

    def __init__(self, layer, forward_func):
        super().__init__()
        self.inner = layer
        self._forward_func = forward_func

    def forward(self, *args, **kwargs):
        if self._forward_func is not None:
            return self._forward_func(self.inner, *args, **kwargs)
        return self.inner(*args, **kwargs)


class _SharedForwardModule(torch.nn.Module):
    """:class:`_SharedForwardAdapter` for a ``torch.nn.Module``."""

    def __init__(self, layer, forward_func):
        super().__init__()
        self.inner = layer
        self._forward_func = forward_func

    def forward(self, *args, **kwargs):
        return self._forward_func(self.inner, *args, **kwargs)


def _is_module(x) -> bool:
    return isinstance(x, torch.nn.Module)


def _stage_of(num_stages: int, topology, stage_id) -> int:
    """This rank's pipeline stage: ``stage_id``, else its coordinate on
    ``topology``'s pipe axis, else on the fleet's hybrid group, else on
    the mesh of ``dist.set_mesh``'s ``pp`` axis; 0 for one stage."""
    if stage_id is not None:
        return int(stage_id)
    if num_stages == 1:
        return 0
    from paddle_tpu_torch.distributed.env import get_rank

    rank = get_rank()
    if topology is not None:
        names = topology.get_hybrid_group_names()
        return int(topology.get_coord(rank)[names.index("pipe")])
    from paddle_tpu_torch.distributed.fleet.facade import fleet

    hcg = fleet._hcg
    if hcg is not None and hcg.get_pipe_parallel_world_size() == num_stages:
        return hcg.get_stage_id()
    from paddle_tpu_torch.distributed.mesh import get_mesh

    mesh = get_mesh()
    if mesh is not None and mesh.dim_size("pp") == num_stages and \
            mesh.coord(rank) is not None:
        return mesh.coord(rank)[mesh.dim_names.index("pp")]
    raise ValueError(
        f"PipelineLayer at num_stages={num_stages} needs this rank's "
        f"stage: pass stage_id= or topology=, initialise fleet with "
        f"pp_degree={num_stages}, or set a mesh with a 'pp' axis of "
        f"{num_stages} (dist.set_mesh)")


def layer_perm(n_layers: int, n_stages: int, v: int) -> List[int]:
    """The JAX step's stacking order (``pp_engine.py`` ``_layer_perm``):
    position p = r (V Lv) + v Lv + j holds layer (v S + r) Lv + j, so
    rank r's positions are its V non-contiguous chunks."""
    if v > 1 and n_stages > 1:
        lv = n_layers // (n_stages * v)
        return [(c * n_stages + r) * lv + j for r in range(n_stages)
                for c in range(v) for j in range(lv)]
    return list(range(n_layers))


class PipelineLayer(Layer):
    """Stage-partitioned model container (reference pp_layers.py:257).

    ``layers`` = [pre... (embedding), N x identical LayerDesc (body),
    post... (norm, head)]. The body is the longest homogeneous run of
    LayerDescs (``seg_method="uniform"``) or the longest run of the named
    class (``"layer:<Name>"``). ``num_virtual_pipeline_stages`` is the
    interleave degree the rank's body is cut for; ``stage_id`` this
    rank's stage (see :func:`_stage_of`). ``body_layers`` holds this
    stage's layers keyed by their index in the body, in the order the
    stage applies them."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method="uniform",
                 recompute_interval=0, num_virtual_pipeline_stages=1,
                 stage_id=None, **kw):
        super().__init__()
        self._loss_fn = loss_fn
        self.num_stages = num_stages or (
            topology.get_dim("pipe") if topology else 1)
        self.recompute_interval = recompute_interval
        self.num_virtual_pipeline_stages = int(num_virtual_pipeline_stages)
        self.shared_layers = {}  # key -> first-built layer (weight owner)

        built = []
        descs = []
        for item in layers:
            if isinstance(item, SharedLayerDesc):
                descs.append(None)
                built.append(self._build_shared(item))
            elif isinstance(item, LayerDesc):
                descs.append(item)
                built.append(None)
            else:
                descs.append(None)
                built.append(item)

        def _homog_run(i):
            j = i
            while (j < len(descs) and descs[j] is not None
                   and descs[j].layer_func is descs[i].layer_func
                   and descs[j].inputs == descs[i].inputs
                   and descs[j].kwargs == descs[i].kwargs):
                j += 1
            return j

        if isinstance(seg_method, str) and seg_method.startswith("layer:"):
            want = seg_method.split(":", 1)[1]
            best = (0, 0)
            i = 0
            while i < len(descs):
                if descs[i] is None or \
                        getattr(descs[i].layer_func, "__name__", "") != want:
                    i += 1
                    continue
                j = _homog_run(i)
                if j - i > best[1] - best[0]:
                    best = (i, j)
                i = j
            if best == (0, 0):
                raise ValueError(
                    f"seg_method {seg_method!r} matched no LayerDesc run")
        else:
            best = (0, 0)
            i = 0
            while i < len(descs):
                if descs[i] is None:
                    i += 1
                    continue
                j = _homog_run(i)
                if j - i > best[1] - best[0]:
                    best = (i, j)
                i = j
        self._body_range = best
        b0, b1 = best
        self.n_body_layers = b1 - b0
        S, V = self.num_stages, self.num_virtual_pipeline_stages
        if S > 1:
            if self.n_body_layers == 0:
                raise ValueError(
                    "PipelineLayer needs a homogeneous run of LayerDescs "
                    "to form the pipeline body")
            if self.n_body_layers % S != 0:
                raise ValueError(
                    f"body layers ({self.n_body_layers}) must divide "
                    f"evenly into {S} stages")
            if V > 1 and self.n_body_layers % (S * V):
                raise ValueError(
                    f"interleave needs layers ({self.n_body_layers}) "
                    f"divisible by stages*degree ({S}*{V})")
        self.stage_id = _stage_of(S, topology, stage_id)
        if not 0 <= self.stage_id < S:
            raise ValueError(f"stage_id {self.stage_id} is not one of the "
                             f"{S} stages")
        L = self.n_body_layers
        per = L // S if S > 1 else L
        perm = layer_perm(L, S, V)
        # this stage's layers, in the order it applies them
        self._owned = perm[self.stage_id * per:(self.stage_id + 1) * per]
        owned = set(self._owned)

        # build in the one-rank order: pre, then body, then post
        pre = [built[k] if built[k] is not None else descs[k].build_layer()
               for k in range(0, b0)]
        body = {}
        for k in range(b0, b1):
            layer = descs[k].build_layer()
            if k - b0 in owned:
                body[k - b0] = layer
            del layer
        post = [built[k] if built[k] is not None else descs[k].build_layer()
                for k in range(b1, len(descs))]
        self._torch: "OrderedDict[str, torch.nn.Module]" = OrderedDict()
        self.pre_layers = self._section("pre_layers", pre)
        self.body_layers = self._section(
            "body_layers", [(str(k), body[k]) for k in self._owned])
        self.post_layers = self._section("post_layers", post)
        self._is_modules = bool(self._torch)

    def _section(self, name, items):
        """A port container when every entry is a Layer, else a torch
        one (held outside the Layer tree, walked by the overrides
        below)."""
        pairs = [(str(i), x) for i, x in enumerate(items)] \
            if items and not isinstance(items[0], tuple) else list(items)
        if any(_is_module(x) for _, x in pairs):
            if not all(_is_module(x) for _, x in pairs):
                raise TypeError(f"PipelineLayer {name}: mixes nn.Layers and "
                                f"torch.nn.Modules in one section")
            sec = torch.nn.ModuleDict(OrderedDict(pairs))
            self._torch[name] = sec
            return sec
        if name == "body_layers":
            return LayerDict(OrderedDict(pairs))
        return LayerList([x for _, x in pairs])

    def _build_shared(self, desc: SharedLayerDesc):
        layer = desc.build_layer()
        owner = self.shared_layers.get(desc.layer_name)
        if owner is None:
            self.shared_layers[desc.layer_name] = layer
        else:
            attr = desc.shared_weight_attr
            shared = None
            for holder in (owner, getattr(owner, "inner", None)):
                if holder is not None and hasattr(holder, attr):
                    shared = getattr(holder, attr)
                    break
            if shared is None:
                raise ValueError(
                    f"shared key {desc.layer_name!r}: owner has no "
                    f"attribute {attr!r}")
            if _is_module(layer):
                delattr(layer, attr)
            setattr(layer, attr, shared)
        if desc.forward_func is not None:
            return (_SharedForwardModule if _is_module(layer)
                    else _SharedForwardAdapter)(layer, desc.forward_func)
        return layer

    # -- the torch sections in the Layer API ------------------------------
    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        for name, p in super().named_parameters(prefix, include_sublayers):
            seen.add(id(p))
            yield name, p
        if not include_sublayers:
            return
        for sec_name, sec in self._torch.items():
            base = f"{prefix}.{sec_name}" if prefix else sec_name
            for name, p in sec.named_parameters(prefix=base):
                if id(p) not in seen:
                    seen.add(id(p))
                    yield name, p

    def named_buffers(self, prefix="", include_sublayers=True):
        yield from super().named_buffers(prefix, include_sublayers)
        for sec_name, sec in self._torch.items():
            base = f"{prefix}.{sec_name}" if prefix else sec_name
            yield from sec.named_buffers(prefix=base)

    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = super().state_dict(destination, include_sublayers,
                                  structured_name_prefix, use_hook)
        # a shared parameter under its first name only, as the Layer
        # state dict has it
        names = {n for n, _ in self.named_parameters()}
        for sec_name, sec in self._torch.items():
            for k, v in sec.state_dict(keep_vars=True).items():
                key = f"{sec_name}.{k}"
                if key in names or not isinstance(v, torch.nn.Parameter):
                    dest[structured_name_prefix + key] = v.detach()
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        own = self.state_dict()
        missing, unexpected = [], []
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    unexpected.append(k)
                elif isinstance(own[k], torch.Tensor):
                    own[k].copy_(v if isinstance(v, torch.Tensor)
                                 else torch.as_tensor(np.asarray(v)))
                else:
                    own[k].set_value(v)
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict

    def train(self):
        super().train()
        for sec in self._torch.values():
            sec.train()
        return self

    def eval(self):
        super().eval()
        for sec in self._torch.values():
            sec.eval()
        return self

    # eager forward: one stage holds the whole body only at num_stages 1
    def forward(self, x):
        if self.num_stages > 1:
            raise RuntimeError(
                f"PipelineLayer.forward at num_stages={self.num_stages}: "
                f"this rank holds only stage {self.stage_id}; run the "
                f"pipeline forward (PipelineParallel.forward or "
                f"PipelineTrainStep.predict)")
        for section in (self.pre_layers, self.body_layers.values()
                        if isinstance(self.body_layers, (LayerDict,
                                                         torch.nn.ModuleDict))
                        else self.body_layers, self.post_layers):
            for layer in (section.values() if isinstance(
                    section, torch.nn.ModuleDict) else section):
                x = _call(layer, x)
        return x

    def get_loss_fn(self):
        return self._loss_fn


def _call(layer, x):
    """``layer(x)`` on torch tensors: a Layer gets and gives Tensors."""
    if isinstance(layer, Layer) and isinstance(x, torch.Tensor):
        out = layer(Tensor._from_data(x))
        return out._data if isinstance(out, Tensor) else out
    return layer(x)


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------
def _vpp_schedule(M: int, S: int, V: int):
    """Static interleaved-pipeline schedule (true VPP), copied from the
    JAX package.

    Greedy drain-first list scheduling of the (microbatch, virtual-stage)
    grid: virtual stage q in [0, S V) runs on rank q mod S as chunk
    q div S; each rank executes ONE chunk per tick, and chunks fill each
    other's ramp, so the makespan is M V + S - 1 micro-ticks and the
    bubble fraction (S-1)/(M V + S-1) DECREASES in V (reference
    PipelineParallelWithInterleave, meta_parallel/pipeline_parallel.py:
    987).

    Returns (T, proc_chunk[T,S], inject_m[T], recv_chunk[T,S],
    out_m[T]) as numpy arrays:
      proc_chunk[t,r]: chunk this rank applies at tick t (-1 idle)
      inject_m[t]:     microbatch rank 0 injects at tick t (-1 none)
      recv_chunk[t,r]: bank slot for the activation arriving at rank r
                       at the END of tick t (-1 drop)
      out_m[t]:        microbatch completing on rank S-1 at tick t (-1)
    """
    R = S * V
    done_at = {}          # (m, q) -> tick completed
    pending = {}          # (rank, chunk) -> (m, q) waiting in the bank
    proc, inject, recv, outm = [], [], [], []
    remaining = {(m, q) for m in range(M) for q in range(R)}
    t = 0
    while remaining:
        t += 1
        row = [-1] * S
        inj = -1
        processed = {}    # rank -> (m, q) this tick
        for r in range(S):
            # available work: banked arrivals + fresh injections (rank 0)
            avail = [mq for (rr, _), mq in pending.items() if rr == r]
            if r == 0:
                for m in range(M):
                    if (m, 0) in remaining and (m, 0) not in avail:
                        avail.append((m, 0))
            avail = [mq for mq in avail if mq in remaining]
            if not avail:
                continue
            # drain-first: highest virtual stage, then oldest microbatch
            m, q = max(avail, key=lambda mq: (mq[1], -mq[0]))
            row[r] = q // S
            processed[r] = (m, q)
            remaining.discard((m, q))
            done_at[(m, q)] = t
            if q == 0:
                inj = m
            else:
                pending.pop((r, q // S), None)
        # arrivals: rank r's output (m, q) lands on rank (q+1) mod S as
        # chunk (q+1) div S, unless q was the last virtual stage
        rrow = [-1] * S
        om = -1
        for r, (m, q) in processed.items():
            if q == R - 1:
                om = m
                continue
            nr, nc = (q + 1) % S, (q + 1) // S
            slot = (nr, nc)
            if slot in pending and pending[slot] in remaining:
                raise AssertionError(
                    f"VPP schedule bank conflict at tick {t}: slot {slot} "
                    f"still holds {pending[slot]}")
            pending[slot] = (m, q + 1)
            rrow[nr] = nc
        proc.append(row)
        inject.append(inj)
        recv.append(rrow)
        outm.append(om)
        if t > 4 * (M * V + R):
            raise AssertionError("VPP scheduler failed to converge")
    T = t
    # M a multiple of S achieves the ideal makespan M*V + S - 1; other M
    # still schedule correctly, just with a few extra drain ticks
    assert T <= M * V + R, \
        f"VPP makespan {T} > bound {M * V + R} (M={M},S={S},V={V})"
    return (T, np.asarray(proc, np.int32), np.asarray(inject, np.int32),
            np.asarray(recv, np.int32), np.asarray(outm, np.int32))


def _ticks(M: int, S: int, V: int, vpp: bool = True):
    """Each tick's work: a list per tick of, for each rank, the
    (microbatch, virtual stage) it applies, or None. ``V == 1``: the
    rotation of :func:`pipeline_forward` (rank r takes microbatch t - r
    at tick t); else ``_vpp_schedule``'s ticks (``vpp``) or the
    conveyor's (every rank applies each of its V chunks that holds a
    microbatch; only the list's first entry per rank is kept here, the
    conveyor runs one tick per (tick, chunk))."""
    if V == 1:
        return [[(t - r, r) if 0 <= t - r < M else None for r in range(S)]
                for t in range(M + S - 1)]
    if not vpp:
        R = S * V
        out = []
        for t in range(M + R - 1):
            for c in range(V):
                out.append([(t - (c * S + r), c * S + r)
                            if 0 <= t - (c * S + r) < M else None
                            for r in range(S)])
        return out
    T, proc, inject, _, _ = _vpp_schedule(M, S, V)
    bank = {}            # (rank, chunk) -> microbatch waiting there
    out = []
    for t in range(T):
        row = [None] * S
        for r in range(S):
            c = int(proc[t, r])
            if c < 0:
                continue
            m = int(inject[t]) if (r == 0 and c == 0) else \
                bank.pop((r, c))
            row[r] = (m, c * S + r)
        for r in range(S):
            if row[r] is None or row[r][1] == S * V - 1:
                continue
            m, q = row[r]
            bank[((q + 1) % S, (q + 1) // S)] = m
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# the per-rank rotation
# ---------------------------------------------------------------------------
def _exchange(group, sends, recvs, like: torch.Tensor):
    """One tick's P2P: ``sends`` [(tensor, global dst)], ``recvs``
    [(global src)] (each a tensor shaped and typed as ``like``), in one
    batched isend/irecv; a CUDA tensor goes through the host under gloo.
    Returns the received tensors on ``like``'s device, in order."""
    from paddle_tpu_torch.distributed import communication as comm

    if not sends and not recvs:
        return []
    dist = torch.distributed
    staged = like.is_cuda and group.backend == "gloo"
    nbytes = sum(t.numel() * t.element_size() for t, _ in sends)
    with comm._timed_p2p(nbytes):
        ops, bufs = [], []
        for t, dst in sends:
            w = t.detach()
            w = w.cpu() if staged else w.contiguous()
            ops.append(dist.P2POp(dist.isend, w.contiguous(), dst,
                                  group=group._pg))
        for src in recvs:
            b = torch.empty(like.shape, dtype=like.dtype,
                            device="cpu" if staged else like.device)
            bufs.append(b)
            ops.append(dist.P2POp(dist.irecv, b, src, group=group._pg))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(like.device) for b in bufs]


class _Rotation:
    """One pass of microbatches through the pp ring on this rank, and
    its backward. ``apply(chunk, m, h)`` applies this rank's
    ``chunk``-th layer chunk (one chunk when V is 1) to microbatch m.
    Built by the train step and by the pipeline forwards below."""

    def __init__(self, group, n_stages: int, v: int, ticks):
        self.g, self.S, self.V = group, n_stages, v
        self.R = n_stages * v
        self.ticks = ticks
        self.me = group.rank() if group is not None else 0

    def _peer(self, i):
        return self.g.ranks[i % self.S]

    def forward(self, apply: Callable, x_mbs: Sequence[Optional[torch.Tensor]],
                like: torch.Tensor, grad: bool):
        """Run the ticks. ``x_mbs[m]`` is microbatch m's input (rank 0;
        None elsewhere), ``like`` an activation's shape and dtype.
        Returns this rank's last-virtual-stage outputs {m: tensor}
        (rank S - 1) and keeps what the backward needs."""
        S, me = self.S, self.me
        self._ins, self._outs = {}, {}
        inbox, done = {}, {}
        for row in self.ticks:
            ev = row[me]
            if ev is not None:
                m, q = ev
                h = x_mbs[m] if q == 0 else inbox.pop((m, q))
                if grad:
                    h = h.detach().requires_grad_(True)
                    self._ins[(m, q)] = h
                out = apply(q // S, m, h)
                if grad:
                    self._outs[(m, q)] = out
                if q == self.R - 1:
                    done[m] = out
            sends = []
            if ev is not None and ev[1] != self.R - 1 and S > 1:
                sends.append((out, self._peer(me + 1)))
            prev = row[(me - 1) % S] if S > 1 else None
            want = []
            if prev is not None and prev[1] != self.R - 1:
                want.append((prev[0], prev[1] + 1))
            got = _exchange(self.g, sends, [self._peer(me - 1)] * len(want),
                            like) if S > 1 else []
            for key, t in zip(want, got):
                inbox[key] = t
        return done

    def backward(self, grads_out: dict, like: torch.Tensor) -> dict:
        """The ticks in reverse: ``grads_out`` {m: gradient of the last
        virtual stage's output m} (rank S - 1). Returns the gradients of
        the first virtual stage's inputs {m: tensor} (rank 0)."""
        S, me = self.S, self.me
        gbox = {(m, self.R - 1): g for m, g in grads_out.items()}
        first = {}
        for row in reversed(self.ticks):
            ev = row[me]
            gin = None
            if ev is not None:
                m, q = ev
                out, h = self._outs.pop((m, q)), self._ins.pop((m, q))
                torch.autograd.backward(out, gbox.pop((m, q)))
                gin = h.grad if h.grad is not None else torch.zeros_like(h)
                if q == 0:
                    first[m] = gin
            sends = []
            if ev is not None and ev[1] > 0 and S > 1:
                sends.append((gin, self._peer(me - 1)))
            nxt = row[(me + 1) % S] if S > 1 else None
            want = []
            if nxt is not None and nxt[1] > 0:
                want.append((nxt[0], nxt[1] - 1))
            got = _exchange(self.g, sends, [self._peer(me + 1)] * len(want),
                            like) if S > 1 else []
            for key, t in zip(want, got):
                gbox[key] = t
        return first


def _replicate_outputs(done: dict, M: int, group, src_index: int,
                       like: torch.Tensor) -> torch.Tensor:
    """[M, ...] of the last stage's outputs on every rank of ``group``
    (the JAX ``psum`` of the last stage's rows)."""
    from paddle_tpu_torch.distributed import communication as comm

    if done:
        outs = torch.stack([done[m] for m in range(M)])
    else:
        outs = torch.empty((M,) + tuple(like.shape), dtype=like.dtype,
                           device=like.device)
    if group is not None and group.nranks > 1:
        comm.broadcast_(outs, group.ranks[src_index], group)
    return outs


def _pp_group(pp_axis: str):
    from paddle_tpu_torch.distributed.engine import current_mesh

    mesh = current_mesh()
    if mesh is None:
        from paddle_tpu_torch.distributed.mesh import get_mesh

        mesh = get_mesh()
    if mesh is None or pp_axis not in mesh.dim_names:
        raise ValueError(f"the pipeline forwards need a mesh with a "
                         f"{pp_axis!r} axis (dist.set_mesh)")
    return mesh.group(pp_axis)


def pipeline_forward(stage_apply: Callable, stacked_params, x_mbs,
                     n_stages: int, pp_axis: str = "pp"):
    """The rotation schedule on this rank: ``stage_apply(local_params,
    h)`` applies this rank's L/S layers. ``x_mbs``: [M, mb, ...]
    microbatched inputs (every rank passes them; rank 0 reads them).
    Returns [M, mb, ...] outputs of the last stage on every pp rank.
    ``pp_axis`` names the axis of the current mesh (``dist.set_mesh``)."""
    g = _pp_group(pp_axis)
    M = x_mbs.shape[0]
    rot = _Rotation(g, n_stages, 1, _ticks(M, n_stages, 1))
    with torch.no_grad():
        done = rot.forward(lambda c, m, h: stage_apply(stacked_params, h),
                           list(x_mbs), x_mbs[0], grad=False)
    return _replicate_outputs(done, M, g, n_stages - 1, x_mbs[0])


def pipeline_forward_vpp(vstage_apply: Callable, stacked_params, x_mbs,
                         n_stages: int, v: int, pp_axis: str = "pp"):
    """True-VPP interleaved rotation on this rank: each tick applies the
    ONE chunk ``_vpp_schedule`` gives it, ``vstage_apply(local_params,
    chunk_index, h)``. Returns [M, mb, ...] last-virtual-stage outputs
    on every pp rank."""
    g = _pp_group(pp_axis)
    M = x_mbs.shape[0]
    rot = _Rotation(g, n_stages, v, _ticks(M, n_stages, v))
    with torch.no_grad():
        done = rot.forward(lambda c, m, h: vstage_apply(stacked_params, c, h),
                           list(x_mbs), x_mbs[0], grad=False)
    return _replicate_outputs(done, M, g, n_stages - 1, x_mbs[0])


def pipeline_forward_interleaved(vstage_apply: Callable, stacked_params,
                                 x_mbs, n_stages: int, v: int,
                                 pp_axis: str = "pp"):
    """The conveyor form of the interleaved rotation (``v`` virtual
    stages a rank; a microbatch visits ranks 0..S-1 ``v`` times):
    ``vstage_apply(local_params, slot_index, h)`` applies this rank's
    slot chunk. Each JAX tick applies every occupied slot; here each
    (tick, slot) is one tick of the loop. Returns [M, mb, ...] on every
    pp rank."""
    g = _pp_group(pp_axis)
    M = x_mbs.shape[0]
    rot = _Rotation(g, n_stages, v, _ticks(M, n_stages, v, vpp=False))
    with torch.no_grad():
        done = rot.forward(lambda c, m, h: vstage_apply(stacked_params, c, h),
                           list(x_mbs), x_mbs[0], grad=False)
    return _replicate_outputs(done, M, g, n_stages - 1, x_mbs[0])


class PipelineParallel(Layer):
    """train_batch-compatible wrapper (reference pipeline_parallel.py:149)
    over :class:`~paddle_tpu_torch.distributed.fleet.pp_engine.
    PipelineTrainStep`."""

    def __init__(self, layers: PipelineLayer, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self.num_stages = hcg.get_pipe_parallel_world_size()
        self.micro_batches = 1
        if strategy is not None:
            self.micro_batches = strategy.pipeline_configs.get(
                "accumulate_steps", 1)
        self._step = None
        self._mesh = hcg.mesh

    def _micro(self) -> int:
        M = max(self.micro_batches, self.num_stages)
        return M + (-M) % self.num_stages  # round up to a chunk multiple

    def _runner(self, optimizer=None, scaler=None):
        from paddle_tpu_torch.distributed.fleet.pp_engine import (
            PipelineTrainStep,
        )

        if self._step is None or (optimizer is not None and
                                  self._step._opt is None):
            self._step = PipelineTrainStep(
                self._layers, self._layers.get_loss_fn(), optimizer,
                self._mesh, n_microbatches=self._micro(), scaler=scaler)
        return self._step

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        x, y = data
        loss = self._runner(optimizer, scaler)(x, y)
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss=True):
        """The pipeline forward of ``x`` (every rank gets the outputs),
        then the loss on each rank: a port rank holds only its stage."""
        x, y = data
        out = self.forward(x)
        loss_fn = self._layers.get_loss_fn()
        if compute_loss and loss_fn is not None:
            step = self._runner()
            return step._loss_of(out._data if isinstance(out, Tensor)
                                 else out, step._as_batch(y))
        return out

    def forward(self, x):
        return self._runner().predict(x)

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)
