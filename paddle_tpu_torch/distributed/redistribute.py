"""Layout algebra and the ``redistribute`` primitive (port of the JAX
package's ``distributed/redistribute.py``).

"Memory-efficient array redistribution through portable collective
communication" (arxiv 2112.01075) observes that ONE layout-to-layout
transfer primitive serves every resharding consumer: tensor-parallel
serving, checkpoint resharding onto a different mesh, and KV-cache ships
between replicas of different TP degrees. This module is that primitive:

* :class:`Layout` — ``Layout(mesh_axes, dim_placements)``: an ordered list
  of named mesh axes with sizes, plus one entry per tensor dim naming the
  axis it is split over (or None for replicated). A layout is pure
  metadata, so the same object describes the shards a TP engine's ranks
  hold, a wire-format KV frame set, and a checkpoint target;
* the **numpy oracle** — :meth:`Layout.shards` / :meth:`Layout.assemble`
  and :func:`redistribute_host` slice and reassemble host arrays with
  plain numpy indexing, and price the transfer exactly (bytes a
  destination shard must receive that its rank does not already hold);
* the **collective path** — :func:`redistribute` takes one rank's
  ``src`` shard and returns its ``dst`` shard over ``torch.distributed``:
  an ``all_gather`` of the shards, the global tensor assembled on every
  rank, then this rank's slice. Layouts of different sizes meet in one
  group by the trailing-replication embedding: rank ``f`` of the
  ``N``-rank group holds shard ``f // (N // layout.size)``. The JAX
  package lowers the same change through GSPMD; both must agree with the
  oracle bit for bit.

Transfer accounting is module-global (:func:`get_stats` /
:func:`reset_stats`): every redistribute, oracle or collective, adds its
priced bytes to the same counters.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "Layout", "redistribute", "redistribute_host", "transfer_bytes",
    "get_stats", "reset_stats",
]


class Layout:
    """How one logical array is laid out over a named device mesh.

    ``mesh_axes`` is an ordered sequence of ``(name, size)`` pairs;
    ``dim_placements`` has one entry per tensor dim — the mesh-axis
    name that dim is split over, or None for replicated. Shard order
    is C-order over the mesh axes (last axis fastest): shard ``i`` is
    the one rank ``i`` of a process group holds.
    """

    __slots__ = ("mesh_axes", "dim_placements")

    def __init__(self, mesh_axes: Sequence[Tuple[str, int]],
                 dim_placements: Sequence[Optional[str]]):
        axes = tuple((str(n), int(s)) for n, s in mesh_axes)
        names = [n for n, _ in axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis names in {names}")
        for n, s in axes:
            if s < 1:
                raise ValueError(f"mesh axis {n!r} has size {s} < 1")
        placements = tuple(None if p is None else str(p)
                           for p in dim_placements)
        used = [p for p in placements if p is not None]
        if len(set(used)) != len(used):
            raise ValueError(
                f"a mesh axis shards at most one tensor dim: {placements}")
        for p in used:
            if p not in names:
                raise ValueError(
                    f"placement {p!r} is not a mesh axis ({names})")
        self.mesh_axes = axes
        self.dim_placements = placements

    # -- constructors --------------------------------------------------
    @classmethod
    def replicated(cls, ndim: int) -> "Layout":
        """Fully replicated over the trivial 1-device mesh."""
        return cls((("r", 1),), (None,) * ndim)

    @classmethod
    def tp_sharded(cls, ndim: int, dim: int, degree: int,
                   axis: str = "tp") -> "Layout":
        """One dim split ``degree``-ways over a 1-D ``tp`` mesh; the
        degenerate degree=1 layout is replicated-on-one-device."""
        placements: List[Optional[str]] = [None] * ndim
        if degree > 1:
            placements[dim % ndim] = axis
        return cls(((axis, int(degree)),), placements)

    # -- metadata ------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.dim_placements)

    @property
    def size(self) -> int:
        n = 1
        for _, s in self.mesh_axes:
            n *= s
        return n

    @property
    def is_replicated(self) -> bool:
        return all(p is None for p in self.dim_placements)

    def axis_size(self, name: str) -> int:
        for n, s in self.mesh_axes:
            if n == name:
                return s
        raise KeyError(name)

    def sharding_degree(self, dim: int) -> int:
        p = self.dim_placements[dim]
        return 1 if p is None else self.axis_size(p)

    def validate_shape(self, global_shape: Sequence[int]) -> None:
        if len(global_shape) != self.ndim:
            raise ValueError(
                f"layout has {self.ndim} dims, array has "
                f"{len(global_shape)}")
        for d, p in enumerate(self.dim_placements):
            if p is not None and global_shape[d] % self.axis_size(p):
                raise ValueError(
                    f"dim {d} of size {global_shape[d]} not divisible "
                    f"by mesh axis {p!r} size {self.axis_size(p)}")

    def local_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        self.validate_shape(global_shape)
        return tuple(n // self.sharding_degree(d)
                     for d, n in enumerate(global_shape))

    # -- shard geometry ------------------------------------------------
    def _axis_sizes(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.mesh_axes)

    def shard_slices(self, global_shape: Sequence[int],
                     index: int) -> Tuple[slice, ...]:
        """Index tuple of flat shard ``index`` (C-order over the mesh
        axes) into the global array."""
        self.validate_shape(global_shape)
        coords = np.unravel_index(index % self.size, self._axis_sizes())
        names = [n for n, _ in self.mesh_axes]
        out = []
        for d, p in enumerate(self.dim_placements):
            if p is None:
                out.append(slice(0, int(global_shape[d])))
            else:
                chunk = global_shape[d] // self.axis_size(p)
                c = int(coords[names.index(p)])
                out.append(slice(c * chunk, (c + 1) * chunk))
        return tuple(out)

    def shards(self, x: np.ndarray) -> List[np.ndarray]:
        """Slice a global host array into its ``size`` per-device
        shards, flat C-order. Replicated dims repeat by reference-free
        copy so shards are independently mutable/serializable."""
        x = np.asarray(x)
        return [np.ascontiguousarray(x[self.shard_slices(x.shape, i)])
                for i in range(self.size)]

    def assemble(self, shards: Sequence[np.ndarray],
                 global_shape: Optional[Sequence[int]] = None
                 ) -> np.ndarray:
        """Inverse of :meth:`shards`: rebuild the global array. With
        replication, later shards overwrite identical regions — any
        replica is authoritative."""
        if len(shards) != self.size:
            raise ValueError(
                f"layout has {self.size} shards, got {len(shards)}")
        first = np.asarray(shards[0])
        if global_shape is None:
            global_shape = tuple(
                ls * self.sharding_degree(d)
                for d, ls in enumerate(first.shape))
        self.validate_shape(global_shape)
        want = self.local_shape(global_shape)
        out = np.empty(global_shape, dtype=first.dtype)
        for i, sh in enumerate(shards):
            sh = np.asarray(sh)
            if tuple(sh.shape) != want:
                raise ValueError(
                    f"shard {i} has shape {sh.shape}, layout wants "
                    f"{want}")
            out[self.shard_slices(global_shape, i)] = sh
        return out

    def shard_frames(self, x: np.ndarray) -> np.ndarray:
        """:meth:`shards` stacked along a leading ``(size,)`` axis —
        the spill/wire framing: one contiguous ``(size, *local_shape)``
        array whose frame ``i`` is device ``i``'s shard. Degree 1 is a
        plain ``x[None]``, so replicated callers pay one copy and no
        branches. This is how KV leaves the device tier (host swap
        pool, tiered host region, peer payloads): per-shard frames,
        never a pre-assembled global array."""
        return np.stack(self.shards(x))

    def unshard_frames(self, frames: np.ndarray,
                       global_shape: Optional[Sequence[int]] = None
                       ) -> np.ndarray:
        """Inverse of :meth:`shard_frames`: reassemble the global array
        from a ``(size, *local_shape)`` frame stack."""
        frames = np.asarray(frames)
        if frames.shape[0] != self.size:
            raise ValueError(
                f"layout has {self.size} frames, got {frames.shape[0]}")
        return self.assemble(list(frames), global_shape)

    # -- wire format ---------------------------------------------------
    def to_meta(self) -> dict:
        return {"mesh_axes": [[n, s] for n, s in self.mesh_axes],
                "dim_placements": list(self.dim_placements)}

    @classmethod
    def from_meta(cls, meta: dict) -> "Layout":
        return cls([(n, s) for n, s in meta["mesh_axes"]],
                   meta["dim_placements"])

    # -- identity ------------------------------------------------------
    def _key(self):
        return (self.mesh_axes, self.dim_placements)

    def __eq__(self, other):
        return isinstance(other, Layout) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        axes = ",".join(f"{n}:{s}" for n, s in self.mesh_axes)
        return f"Layout([{axes}], {list(self.dim_placements)})"


# -- transfer pricing -------------------------------------------------------
def _overlap(a: Tuple[slice, ...], b: Tuple[slice, ...]) -> int:
    vol = 1
    for sa, sb in zip(a, b):
        lo = max(sa.start, sb.start)
        hi = min(sa.stop, sb.stop)
        if hi <= lo:
            return 0
        vol *= hi - lo
    return vol


def transfer_bytes(src: "Layout", dst: "Layout",
                   global_shape: Sequence[int], itemsize: int) -> int:
    """Exact bytes a redistribute must move: for every destination
    device, the volume of its target shard NOT already resident in the
    source shard the same physical device holds. Device f of the
    common mesh (size N = max of the two) holds source shard
    ``f // (N // src.size)`` and destination shard
    ``f // (N // dst.size)`` — the trailing-replication-axis
    embedding. Zero iff dst needs nothing it doesn't have locally
    (e.g. identical layouts, or pure sub-slicing of a replicated
    source)."""
    src.validate_shape(global_shape)
    dst.validate_shape(global_shape)
    n = max(src.size, dst.size)
    if n % src.size or n % dst.size:
        raise ValueError(
            f"layout sizes {src.size} and {dst.size} do not embed in a "
            f"common mesh")
    moved = 0
    for f in range(n):
        s_sl = src.shard_slices(global_shape, f // (n // src.size))
        d_sl = dst.shard_slices(global_shape, f // (n // dst.size))
        d_vol = 1
        for sl in d_sl:
            d_vol *= sl.stop - sl.start
        moved += d_vol - _overlap(s_sl, d_sl)
    return moved * int(itemsize)


# -- global accounting ------------------------------------------------------
_stats: Dict[str, int] = {"num_redistributes": 0, "bytes_moved": 0,
                          "bytes_total": 0}


def get_stats() -> Dict[str, int]:
    return dict(_stats)


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0


def _account(src: "Layout", dst: "Layout", global_shape, itemsize) -> None:
    total = int(itemsize)
    for d in global_shape:
        total *= int(d)
    _stats["num_redistributes"] += 1
    _stats["bytes_total"] += total * dst.size
    _stats["bytes_moved"] += transfer_bytes(src, dst, global_shape,
                                            itemsize)


# -- the primitive ----------------------------------------------------------
def redistribute_host(shards: Sequence[np.ndarray], src: "Layout",
                      dst: "Layout",
                      global_shape: Optional[Sequence[int]] = None
                      ) -> List[np.ndarray]:
    """The numpy oracle: take ``src``'s per-device shards, return
    ``dst``'s. Pure host indexing: the reference :func:`redistribute`
    must match bit for bit, and the transfer engine for resharding
    between processes that share no group (KV ships between replicas of
    different TP degrees, where bytes ride the wire as per-shard
    frames)."""
    x = src.assemble(shards, global_shape)
    _account(src, dst, x.shape, x.dtype.itemsize)
    return dst.shards(x)


def redistribute(x_local: torch.Tensor, src: "Layout", dst: "Layout",
                 group=None) -> torch.Tensor:
    """The collective path: this rank's ``src`` shard in, its ``dst``
    shard out (a new tensor on ``x_local``'s device).

    ``group`` is a ``torch.distributed`` process group (default: the
    default group; with none initialised, one process). The group's size
    ``N`` must equal ``max(src.size, dst.size)``, and rank ``f`` holds
    shard ``f // (N // layout.size)`` of each layout (the embedding of
    :func:`transfer_bytes`). Every rank all-gathers the ``src`` shards,
    assembles the global tensor, and keeps its ``dst`` slice; the bytes
    are priced as the oracle prices them. The global shape is the local
    one times each dim's ``src`` degree. On one process it is the
    identity and moves nothing."""
    import torch.distributed as dist

    x_local = x_local.contiguous()
    global_shape = tuple(int(s) * src.sharding_degree(d)
                         for d, s in enumerate(x_local.shape))
    src.validate_shape(global_shape)
    dst.validate_shape(global_shape)
    n = max(src.size, dst.size)
    if n % src.size or n % dst.size:
        raise ValueError(
            f"layout sizes {src.size} and {dst.size} do not embed in a "
            f"common mesh")
    if tuple(x_local.shape) != src.local_shape(global_shape):
        raise ValueError(
            f"local shard has shape {tuple(x_local.shape)}, layout "
            f"{src!r} wants {src.local_shape(global_shape)}")
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size(group) if initialised else 1
    rank = dist.get_rank(group) if initialised else 0
    if world != n:
        raise ValueError(
            f"redistribute {src!r} -> {dst!r} needs a group of {n} "
            f"ranks, this one has {world}")
    if n == 1:
        _account(src, dst, global_shape, x_local.element_size())
        return x_local.clone()
    parts = [torch.empty_like(x_local) for _ in range(n)]
    dist.all_gather(parts, x_local, group=group)
    full = torch.empty(global_shape, dtype=x_local.dtype,
                       device=x_local.device)
    for f in range(0, n, n // src.size):
        full[src.shard_slices(global_shape, f // (n // src.size))] = \
            parts[f]
    _account(src, dst, global_shape, x_local.element_size())
    return full[dst.shard_slices(global_shape,
                                 rank // (n // dst.size))].clone()
