"""Collective communication (port of
``paddle_tpu/distributed/communication.py``).

The JAX package runs collectives as XLA ops over a mesh axis inside an
SPMD program, and eagerly across processes as a jitted ``shard_map``.
PyTorch's idiom is one process per rank, so here every collective is a
``torch.distributed`` call on the torch process group of a
:class:`Group`. A group's ranks are global ranks of the world; its torch
group is made once per set of ranks, by the members alone
(``use_local_synchronization``), and kept until
:func:`~paddle_tpu_torch.distributed.compat.destroy_process_group`. The
order of :attr:`Group.ranks` is the order of a gather's result and of a
scatter's parts, whatever order torch gives the members.

The public functions take Tensor API Tensors and torch tensors, and work
in place as the reference's do (``all_reduce`` rewrites its tensor,
``all_gather`` appends to its list). A group of one rank, or a process
outside any world, gives each its identity.

Two rules hold on one path, chosen by the group's backend and the
operation, never by a caught error:

* **host staging.** Under gloo a CUDA tensor goes through the host for
  every operation but ``all_reduce``, ``broadcast``, ``all_gather`` and
  ``reduce_scatter``, the ones that gloo runs on CUDA tensors;
* **16-bit sums in f32.** A bf16 or f16 sum (``all_reduce``,
  ``reduce_scatter``) is taken in f32 and rounded once, as the
  tensor-parallel serving step reduces (``serving/tp.py``).

:func:`stats` counts the collectives this process ran, the host seconds
spent in them (waiting for the other ranks included) and their bytes.
While one runs, the default watchdog holds an entry tagged
``<kind>@ranks[...]`` (``all_reduce@ranks[0, 1, 2, 3]``), so that a
hung collective names itself well before the group's own timeout (a
no-op without ``PADDLE_STEP_TIMEOUT``).

The differentiable collectives at the end (:func:`copy_to_group`,
:func:`reduce_from_group`, :func:`split_along`, :func:`gather_along`,
:func:`all_gather_along`, :func:`reduce_scatter_along`,
:func:`all_reduce_both`) are the Megatron and sequence-parallel pairs
that the tensor-parallel layers, the Llama and the ZeRO-3 step build on:
each is a ``torch.autograd.Function`` whose backward is its forward's
transpose.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import torch

from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["ReduceOp", "Group", "new_group", "get_group",
           "all_reduce", "all_gather", "all_gather_object", "reduce",
           "reduce_scatter", "all_to_all", "broadcast", "scatter", "barrier",
           "send", "recv", "isend", "irecv", "shift", "stream",
           "copy_to_group", "reduce_from_group", "split_along",
           "gather_along", "all_gather_along", "reduce_scatter_along",
           "all_reduce_both"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _dist():
    import torch.distributed as dist

    return dist


def _world_up() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


class Group:
    """A communicator: ``ranks`` (global ranks, in the group's order),
    the mesh axis it runs along, and its torch process group (None for
    a process outside the group or outside any world)."""

    _next_gid = 0

    def __init__(self, ranks: Sequence[int], axis_name: Optional[str] = None,
                 mesh=None):
        self.ranks = [int(r) for r in ranks]
        self.axis_name = axis_name or f"group{Group._next_gid}"
        self.id = Group._next_gid
        Group._next_gid += 1
        self.mesh = mesh
        self._pg = _torch_group(self.ranks)

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def process_group(self):
        """The torch process group (None outside the group or world)."""
        return self._pg

    @property
    def backend(self) -> Optional[str]:
        if self._pg is None:
            return None
        return str(_dist().get_backend(self._pg))

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def rank(self) -> int:
        """This process's index in :attr:`ranks` (-1 if not a member)."""
        return self.get_group_rank(_dist().get_rank() if _world_up() else 0)

    # torch's order of the members (sorted global ranks) against ours
    def _torch_order(self) -> List[int]:
        """Position in :attr:`ranks` of each torch group rank."""
        return [self.ranks.index(r) for r in sorted(self.ranks)]

    def __repr__(self):
        return (f"Group(id={self.id}, axis={self.axis_name}, "
                f"ranks={self.ranks})")


# one torch process group per set of ranks (members only), and the
# Groups handed out
_pgs: dict = {}
_groups: dict = {}
_default_group: Optional[Group] = None


def _torch_group(ranks: Sequence[int]):
    """The torch process group over ``ranks``, made once per set and
    only by its members; the world's own group for the whole world;
    None outside the group or outside any world."""
    if not _world_up() or len(ranks) < 2:
        return None
    dist = _dist()
    me = dist.get_rank()
    if me not in ranks:
        return None
    key = tuple(sorted(ranks))
    if key == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    pg = _pgs.get(key)
    if pg is None:
        from datetime import timedelta

        from paddle_tpu_torch.distributed.env import GROUP_TIMEOUT_S

        pg = dist.new_group(list(key),
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S),
                            use_local_synchronization=True)
        _pgs[key] = pg
    return pg


def _reset():
    """Forget every group (the world is being torn down)."""
    global _default_group
    _pgs.clear()
    _groups.clear()
    _default_group = None


def new_group(ranks=None, backend=None, timeout=None, axis_name=None,
              mesh=None) -> Group:
    """A group over ``ranks`` (global ranks; default: the whole world).
    Only its members need to call this."""
    if ranks is None:
        ranks = list(range(_dist().get_world_size() if _world_up() else 1))
    g = Group(ranks, axis_name=axis_name, mesh=mesh)
    _groups[g.id] = g
    return g


def get_group(gid: int = 0) -> Optional[Group]:
    """The world group (``gid`` 0) or the group of that id."""
    global _default_group
    if gid == 0:
        if _default_group is None or (
                _world_up() and _default_group._pg is None
                and _dist().get_world_size() > 1):
            _default_group = new_group(axis_name="world")
        return _default_group
    return _groups.get(gid)


def _group(group) -> Group:
    return group if group is not None else get_group(0)


# ---------------------------------------------------------------------------
# the torch-level operations (one path per backend and operation)
# ---------------------------------------------------------------------------
# operations that gloo runs on CUDA tensors (torch 2.11's gloo, probed on
# the card: all_reduce, broadcast, all_gather and reduce_scatter take them,
# the list all_to_all does not); the rest go through the host
_GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather",
                            "reduce_scatter"})

# host-side accounting of the collectives this process ran: calls, wall
# seconds inside them (waiting for the other ranks included) and the
# bytes of this rank's input; the batched point-to-point exchanges (the
# pipeline's ticks, the ring attention's hops, ``shift``) apart, under
# ``p2p_``
_ZERO = {"calls": 0, "seconds": 0.0, "bytes": 0, "p2p_calls": 0,
         "p2p_seconds": 0.0, "p2p_bytes": 0}
_stats = dict(_ZERO)


def stats(reset: bool = False) -> dict:
    """This process's collective calls, the host seconds spent in them and
    their input bytes since the last reset, and the same of its batched
    point-to-point exchanges (``p2p_calls``, ``p2p_seconds``,
    ``p2p_bytes``: the bytes it sent)."""
    out = dict(_stats)
    if reset:
        _stats.update(_ZERO)
    return out


class _watched:
    """While a collective runs, the default watchdog holds an entry tagged
    ``<kind>@ranks[...]``, so that a hung collective names itself (the
    reference's per-collective record; a no-op without a step
    timeout)."""

    def __init__(self, kind: str, g: "Group"):
        self._tag = f"{kind}@ranks{list(g.ranks)}"

    def __enter__(self):
        from paddle_tpu_torch.distributed.watchdog import default_watchdog

        self._wd = default_watchdog()
        self._eid = self._wd.arm(self._tag)

    def __exit__(self, *exc):
        if self._eid:
            self._wd.disarm(self._eid)


class _timed(_watched):
    """A watched collective, counted into :func:`stats`."""

    def __init__(self, nbytes: int, kind: str, g: "Group",
                 prefix: str = ""):
        super().__init__(kind, g)
        self._n = nbytes
        self._p = prefix

    def __enter__(self):
        super().__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        _stats[self._p + "calls"] += 1
        _stats[self._p + "seconds"] += time.perf_counter() - self._t0
        _stats[self._p + "bytes"] += self._n
        super().__exit__(*exc)


def _staged(g: Group, t: torch.Tensor, op: str) -> bool:
    return t.is_cuda and g.backend == "gloo" and op not in _GLOO_CUDA_OPS


def _wire(g: Group, t: torch.Tensor, op: str, widen: bool = False):
    """The tensor the collective runs on: on the host when gloo cannot
    take the CUDA tensor, in f32 for a 16-bit sum."""
    w = t
    if widen and w.dtype in (torch.bfloat16, torch.float16):
        w = w.float()
    if _staged(g, w, op):
        w = w.cpu()
    return w.contiguous()


def _torch_op(op):
    dist = _dist()
    return {ReduceOp.SUM: dist.ReduceOp.SUM, "sum": dist.ReduceOp.SUM,
            ReduceOp.AVG: dist.ReduceOp.SUM,
            ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.PROD: dist.ReduceOp.PRODUCT}[op]


def _sums(op) -> bool:
    return op in (ReduceOp.SUM, ReduceOp.AVG, "sum")


@torch.no_grad()
def all_reduce_(t: torch.Tensor, op=ReduceOp.SUM, group=None
                ) -> torch.Tensor:
    """Reduce ``t`` in place over the group (AVG: the sum over the
    ranks, divided by their number)."""
    g = _group(group)
    if g.nranks == 1 or g._pg is None:
        return t
    w = _wire(g, t, "all_reduce", widen=_sums(op))
    with _timed(w.numel() * w.element_size(), "all_reduce", g):
        _dist().all_reduce(w, op=_torch_op(op), group=g._pg)
    if op == ReduceOp.AVG:
        w.div_(g.nranks)
    if w is not t:
        t.copy_(w)
    return t


# bytes a fused collective's flat buffer holds at most (16-bit tensors
# are widened to f32 in it)
BUCKET_BYTES = 256 * 2 ** 20


def _wide(t: torch.Tensor) -> bool:
    return t.dtype in (torch.bfloat16, torch.float16)


def buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int = BUCKET_BYTES):
    """Indices of ``tensors`` in consecutive runs of one dtype, each run's
    flat buffer at most ``bucket_bytes`` (a larger tensor is a run of its
    own)."""
    run, n, dtype = [], 0, None
    for i, t in enumerate(tensors):
        size = t.numel() * (4 if _wide(t) else t.element_size())
        if run and (t.dtype != dtype or n + size > bucket_bytes):
            yield run
            run, n = [], 0
        run.append(i)
        n += size
        dtype = t.dtype
    if run:
        yield run


@torch.no_grad()
def all_reduce_into(tensors: Sequence[torch.Tensor], group, scale=None,
                    bucket_bytes: int = BUCKET_BYTES):
    """Sum each tensor over ``group`` in place (in f32 for 16-bit ones,
    rounded once), times ``scale`` when given: the tensors flattened into
    :func:`buckets`, one collective a bucket."""
    trivial = group is None or group.nranks == 1
    if not tensors or (trivial and scale is None):
        return
    for run in buckets(tensors, bucket_bytes):
        ts = [tensors[i] for i in run]
        flat = torch.cat([(t.float() if _wide(t) else t).reshape(-1)
                          for t in ts])
        if not trivial:
            all_reduce_(flat, ReduceOp.SUM, group)
        if scale is not None:
            flat.mul_(scale)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


@torch.no_grad()
def all_gather_list(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every member's ``t``, in the group's order (new tensors on
    ``t``'s device)."""
    g = _group(group)
    if g.nranks == 1 or g._pg is None:
        return [t.clone()]
    w = _wire(g, t, "all_gather")
    outs = [torch.empty_like(w) for _ in range(g.nranks)]
    with _timed(w.numel() * w.element_size(), "all_gather", g):
        _dist().all_gather(outs, w, group=g._pg)
    order = g._torch_order()
    got = [None] * g.nranks
    for j, i in enumerate(order):
        got[i] = outs[j]
    return [x.to(t.device) for x in got]


def all_gather_cat(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The members' ``t`` concatenated along ``dim``, in the group's
    order."""
    return torch.cat(all_gather_list(t, group), dim=dim)


@torch.no_grad()
def reduce_scatter_list(chunks: Sequence[torch.Tensor], op=ReduceOp.SUM,
                        group=None) -> torch.Tensor:
    """Member i gets the reduction over the ranks of their ``chunks[i]``
    (chunks in the group's order)."""
    g = _group(group)
    me = g.rank()
    if g.nranks == 1 or g._pg is None:
        return chunks[max(me, 0)].clone()
    like = chunks[0]
    wires = [_wire(g, c, "reduce_scatter", widen=_sums(op)) for c in chunks]
    order = g._torch_order()
    out = torch.empty_like(wires[0])
    with _timed(sum(w.numel() * w.element_size() for w in wires),
                "reduce_scatter", g):
        _dist().reduce_scatter(out, [wires[i] for i in order],
                               op=_torch_op(op), group=g._pg)
    if op == ReduceOp.AVG:
        out.div_(g.nranks)
    return out.to(like.device, like.dtype)


@torch.no_grad()
def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` takes the value of global rank ``src``'s, in place."""
    g = _group(group)
    if src not in g.ranks:
        raise ValueError(
            f"src rank {src} is not a member of group ranks={g.ranks}")
    if g.nranks == 1 or g._pg is None:
        return t
    w = _wire(g, t, "broadcast")
    with _timed(w.numel() * w.element_size(), "broadcast", g):
        _dist().broadcast(w, src=src, group=g._pg)
    if w is not t:
        t.copy_(w)
    return t


@torch.no_grad()
def all_to_all_list(ins: Sequence[torch.Tensor], group=None
                    ) -> List[torch.Tensor]:
    """``outs[j]`` is member j's ``ins[my index]`` (both in the group's
    order)."""
    g = _group(group)
    if g.nranks == 1 or g._pg is None:
        return [x.clone() for x in ins]
    wires = [_wire(g, x, "all_to_all") for x in ins]
    order = g._torch_order()
    outs = [torch.empty_like(wires[i]) for i in order]
    with _timed(sum(w.numel() * w.element_size() for w in wires),
                "all_to_all", g):
        _dist().all_to_all(outs, [wires[i] for i in order], group=g._pg)
    got = [None] * g.nranks
    for j, i in enumerate(order):
        got[i] = outs[j]
    return [x.to(ins[0].device) for x in got]


@torch.no_grad()
def scatter_(t: torch.Tensor, parts: Optional[Sequence[torch.Tensor]],
             src: int, group=None) -> torch.Tensor:
    """``t`` takes part ``i`` (the group's order) of global rank
    ``src``'s ``parts``, in place."""
    g = _group(group)
    if src not in g.ranks:
        raise ValueError(
            f"src rank {src} is not a member of group ranks={g.ranks}")
    if g.nranks == 1 or g._pg is None:
        if parts:
            t.copy_(parts[0])
        return t
    w = _wire(g, t, "scatter")
    lst = None
    if g.rank() == g.ranks.index(src):
        wires = [_wire(g, p, "scatter") for p in parts]
        lst = [wires[i] for i in g._torch_order()]
    with _watched("scatter", g):
        _dist().scatter(w, lst, src=src, group=g._pg)
    if w is not t:
        t.copy_(w)
    return t


# ---------------------------------------------------------------------------
# the public API (Tensor API Tensors and torch tensors)
# ---------------------------------------------------------------------------
def _data(x) -> torch.Tensor:
    return x._data if isinstance(x, Tensor) else x


def _wrap_like(x, data):
    if isinstance(x, Tensor):
        return Tensor._from_data(data, stop_gradient=x.stop_gradient)
    return data


def _set(x, data):
    """Write ``data`` into ``x`` (a Tensor's data is rebound, a torch
    tensor copied into) and return ``x``."""
    if isinstance(x, Tensor):
        x._data = data.to(x._data.dtype) if x._data is not None else data
        return x
    with torch.no_grad():
        x.copy_(data)
    return x


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    all_reduce_(_data(tensor), op, group)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """As in the JAX package: every member gets the reduction."""
    return all_reduce(tensor, op=op, group=group)


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Append every member's tensor to ``tensor_list`` (group order); with
    ``tensor_list=None`` return them stacked."""
    got = all_gather_list(_data(tensor), group)
    if isinstance(tensor_list, list):
        tensor_list.extend(_wrap_like(tensor, d) for d in got)
        return tensor_list
    return _wrap_like(tensor, torch.stack(got))


def all_gather_object(object_list, obj, group=None):
    """Append every member's ``obj`` to ``object_list`` (group order)."""
    g = _group(group)
    if g.nranks == 1 or g._pg is None:
        object_list.append(obj)
        return object_list
    got = [None] * g.nranks
    _dist().all_gather_object(got, obj, group=g._pg)
    object_list.extend(got[i] for i in _inverse(g._torch_order()))
    return object_list


def _inverse(order: List[int]) -> List[int]:
    """Torch rank of each position in the group's order."""
    inv = [0] * len(order)
    for j, i in enumerate(order):
        inv[i] = j
    return inv


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """``tensor`` takes this member's chunk of the reduction: the chunks
    are ``tensor_list`` (a list, or one tensor stacked on dim 0)."""
    src = tensor_list if tensor_list is not None else tensor
    chunks = list(_data(x) for x in src) if isinstance(
        src, (list, tuple)) else list(_data(src).unbind(0))
    return _set(tensor, reduce_scatter_list(chunks, op, group))


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Append member j's part for this member to ``out_tensor_list``;
    ``in_tensor_list`` is a list, or one tensor stacked on dim 0."""
    ins = [_data(x) for x in in_tensor_list] if isinstance(
        in_tensor_list, (list, tuple)) else list(
        _data(in_tensor_list).unbind(0))
    outs = all_to_all_list(ins, group)
    ref = in_tensor_list[0] if isinstance(in_tensor_list, (list, tuple)) \
        else in_tensor_list
    if isinstance(out_tensor_list, list):
        out_tensor_list.extend(_wrap_like(ref, o) for o in outs)
        return out_tensor_list
    return torch.stack(outs)


def broadcast(tensor, src=0, group=None, sync_op=True):
    g = _group(group)
    if src not in g.ranks:
        raise ValueError(
            f"src rank {src} is not a member of group ranks={g.ranks}")
    if isinstance(tensor, Tensor):
        data = tensor._data.detach().clone()
        broadcast_(data, src, g)
        with torch.no_grad():
            tensor._data.copy_(data)
        return tensor
    broadcast_(tensor, src, g)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    parts = None
    if tensor_list is not None:
        parts = [_data(x) for x in tensor_list] if isinstance(
            tensor_list, (list, tuple)) else list(_data(tensor_list).unbind(0))
    data = _data(tensor)
    out = data.detach().clone()
    scatter_(out, parts, src, group)
    return _set(tensor, out)


def send(tensor, dst=0, group=None, sync_op=True):
    """Point to point to global rank ``dst``."""
    data = _data(tensor)
    g = _group(group)
    w = data.detach().cpu() if _staged(g, data, "send") else data.detach()
    work = _dist().isend(w.contiguous(), dst, group=g._pg)
    if sync_op:
        work.wait()
        return tensor
    return work


def recv(tensor, src=0, group=None, sync_op=True):
    """Point to point from global rank ``src``, into ``tensor``."""
    data = _data(tensor)
    g = _group(group)
    buf = torch.empty_like(data, device="cpu") \
        if _staged(g, data, "recv") else torch.empty_like(data)
    work = _dist().irecv(buf, src, group=g._pg)

    def finish():
        work.wait()
        _set(tensor, buf.to(data.device))

    if sync_op:
        finish()
        return tensor
    return _RecvTask(finish)


class _RecvTask:
    def __init__(self, finish):
        self._finish = finish
        self._done = False

    def wait(self, timeout=None):
        if not self._done:
            self._finish()
            self._done = True
        return True

    def is_completed(self):
        return self._done


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


def barrier(group=None):
    g = _group(group)
    if g.nranks > 1 and g._pg is not None:
        with _watched("barrier", g):
            _dist().barrier(group=g._pg)


def shift(x, group: Group, offset: int = 1):
    """Rotate values around the group's ring by ``offset``: member i's
    value goes to member (i + offset) mod n. Returns this member's new
    value (a torch tensor)."""
    return shift_many([_data(x)], group, offset)[0]


def shift_many(xs: Sequence[torch.Tensor], group: Group, offset: int = 1
               ) -> List[torch.Tensor]:
    """:func:`shift` of several tensors (on one device) in one
    :func:`exchange`. Returns the received tensors."""
    g = _group(group)
    n = g.nranks
    if n == 1 or g._pg is None:
        return [x.clone() for x in xs]
    i = g.rank()
    to, frm = g.ranks[(i + offset) % n], g.ranks[(i - offset) % n]
    return exchange(g, [(x, to) for x in xs],
                    [(x.shape, x.dtype, frm) for x in xs], xs[0].device)


@torch.no_grad()
def exchange(group: Group, sends, recvs, device) -> List[torch.Tensor]:
    """One batched isend/irecv over ``group``: ``sends`` [(tensor, global
    dst)], ``recvs`` [(shape, dtype, global src)]; a CUDA tensor goes
    through the host under gloo. Counted with the point-to-point
    exchanges (``stats()``'s ``p2p_*``: the bytes sent). Returns the
    received tensors on ``device``, in order."""
    if not sends and not recvs:
        return []
    g = _group(group)
    dist = _dist()
    device = torch.device(device)
    host = device.type == "cuda" and g.backend == "gloo"
    nbytes = sum(t.numel() * t.element_size() for t, _ in sends)
    with _timed(nbytes, "shift", g, "p2p_"):
        ops, bufs = [], []
        for t, dst in sends:
            ops.append(dist.P2POp(dist.isend, _wire(g, t.detach(), "send"),
                                  dst, group=g._pg))
        for shape, dtype, src in recvs:
            b = torch.empty(shape, dtype=dtype,
                            device="cpu" if host else device)
            bufs.append(b)
            ops.append(dist.P2POp(dist.irecv, b, src, group=g._pg))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(device) for b in bufs]


@torch.no_grad()
def all_to_all_rows(x: torch.Tensor, send_counts: Sequence[int],
                    recv_counts: Sequence[int], group) -> torch.Tensor:
    """Rows of ``x`` to the members of ``group``: the first
    ``send_counts[0]`` rows to member 0, the next ``send_counts[1]`` to
    member 1, ... (the group's order); returns the rows received,
    member 0's first, ``recv_counts[j]`` from member j. A CUDA tensor
    goes through the host under gloo."""
    g = _group(group)
    if g.nranks == 1 or g._pg is None:
        return x.clone()
    w = _wire(g, x, "all_to_all")
    ins = list(w.split([int(c) for c in send_counts]))
    order = g._torch_order()
    sends = [int(send_counts[j]) for j in order]
    recvs = [int(recv_counts[j]) for j in order]
    out = torch.empty((sum(recvs),) + tuple(x.shape[1:]), dtype=w.dtype,
                      device=w.device)
    with _timed(w.numel() * w.element_size(), "all_to_all", g):
        _dist().all_to_all_single(out, torch.cat([ins[j] for j in order]),
                                  recvs, sends, group=g._pg)
    # back to the group's order of the senders
    got = dict(zip(order, out.split(recvs)))
    return torch.cat([got[j] for j in range(g.nranks)]).to(x.device)


class stream:
    """``paddle.distributed.stream.*``: the plain collectives (the port
    issues every collective on the current stream)."""

    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce_scatter = staticmethod(reduce_scatter)
    all_to_all = staticmethod(all_to_all)
    broadcast = staticmethod(broadcast)
    scatter = staticmethod(scatter)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------
def _trivial(g: Optional[Group]) -> bool:
    return g is None or g.nranks == 1 or g._pg is None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.contiguous().clone(), ReduceOp.SUM, ctx.g), \
            None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return all_reduce_(x.contiguous().clone(), ReduceOp.SUM, g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _AllReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return all_reduce_(x.contiguous().clone(), ReduceOp.SUM, g)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.contiguous().clone(), ReduceOp.SUM, ctx.g), \
            None


def _my_chunk(x, g: Group, dim: int):
    n = g.nranks
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {n} ranks")
    return x.chunk(n, dim=dim)[g.rank()].contiguous()


def _reduce_scatter_dim(x, g: Group, dim: int):
    n = g.nranks
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {n} ranks")
    chunks = [c.contiguous() for c in x.chunk(n, dim=dim)]
    return reduce_scatter_list(chunks, ReduceOp.SUM, g)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _my_chunk(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return all_gather_cat(dy.contiguous(), ctx.dim, ctx.g), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return all_gather_cat(x.contiguous(), dim, g)

    @staticmethod
    def backward(ctx, dy):
        return _my_chunk(dy, ctx.g, ctx.dim), None, None


class _AllGatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return all_gather_cat(x.contiguous(), dim, g)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter_dim(dy, ctx.g, ctx.dim), None, None


class _ReduceScatterAG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _reduce_scatter_dim(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return all_gather_cat(dy.contiguous(), ctx.dim, ctx.g), None, None


def copy_to_group(x, g: Optional[Group]):
    """Identity forward, all-reduce (sum) backward: the input of a
    column-parallel matmul (Megatron's ``f``)."""
    return x if _trivial(g) else _CopyTo.apply(x, g)


def reduce_from_group(x, g: Optional[Group]):
    """All-reduce (sum) forward, identity backward: the output of a
    row-parallel matmul (Megatron's ``g``)."""
    return x if _trivial(g) else _ReduceFrom.apply(x, g)


def all_reduce_both(x, g: Optional[Group]):
    """All-reduce (sum) forward and backward: a statistic every rank's
    loss reads (cross-replica BatchNorm)."""
    return x if _trivial(g) else _AllReduceBoth.apply(x, g)


def split_along(x, g: Optional[Group], dim: int):
    """This rank's chunk of ``dim`` forward, all-gather backward."""
    return x if _trivial(g) else _Split.apply(x, g, dim)


def gather_along(x, g: Optional[Group], dim: int):
    """All-gather along ``dim`` forward, this rank's chunk backward."""
    return x if _trivial(g) else _Gather.apply(x, g, dim)


def all_gather_along(x, g: Optional[Group], dim: int):
    """All-gather along ``dim`` forward, reduce-scatter (sum) backward:
    the sequence-parallel input of a column-parallel matmul, and a ZeRO-3
    parameter gathered for use."""
    return x if _trivial(g) else _AllGatherRS.apply(x, g, dim)


def reduce_scatter_along(x, g: Optional[Group], dim: int):
    """Reduce-scatter (sum) along ``dim`` forward, all-gather backward:
    the sequence-parallel output of a row-parallel matmul."""
    return x if _trivial(g) else _ReduceScatterAG.apply(x, g, dim)
