"""ProcessMesh and placements (port of ``paddle_tpu/distributed/mesh.py``).

The JAX package's ``ProcessMesh`` wraps a ``jax.sharding.Mesh`` and its
placements become ``NamedSharding``s. Here a mesh's ids are global ranks
of the ``torch.distributed`` world, one process each: every rank finds
its own coordinates on the mesh (:meth:`ProcessMesh.coord`), and each
set of mesh axes gets one communication group per slice, the one this
rank is in, made once and cached on the mesh (:meth:`ProcessMesh.group`).
A placement list converts to the port's
:class:`~paddle_tpu_torch.distributed.redistribute.Layout`
(:func:`placements_to_layout`), whose shard ``i`` is the one mesh
position ``i`` (C order) holds.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ProcessMesh", "Shard", "Replicate", "Partial", "Placement",
           "get_mesh", "set_mesh", "init_mesh", "auto_mesh",
           "create_hybrid_mesh", "placements_to_layout"]


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicate(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    """Tensor dim ``dim`` is split across the corresponding mesh dim."""

    def __init__(self, dim: int):
        self.dim = int(dim)

    def is_shard(self, dim=None):
        return True if dim is None else dim == self.dim

    def get_dim(self):
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))


class Replicate(Placement):
    def is_replicate(self):
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("replicate")


class Partial(Placement):
    """A partial sum over the mesh dim (pending all-reduce)."""

    def __init__(self, reduce_type: str = "sum"):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, other):
        return isinstance(other, Partial) and \
            other.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("partial", self.reduce_type))


class ProcessMesh:
    """N-D mesh of global ranks with named dims:
    ``ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "mp"])``."""

    def __init__(self, mesh, dim_names: Optional[Sequence[str]] = None,
                 shape: Optional[Sequence[int]] = None):
        arr = np.asarray(mesh)
        if shape is not None:
            shape = tuple(int(s) for s in shape)
            if arr.size != int(np.prod(shape)):
                raise ValueError(
                    f"mesh has {arr.size} process ids but shape {shape} "
                    f"needs {int(np.prod(shape))}")
            arr = arr.reshape(shape)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(
                f"dim_names {dim_names} does not match mesh ndim {arr.ndim}")
        self._ids = arr.astype(np.int64)
        self._dim_names = list(dim_names)
        self._groups: Dict[Tuple[str, ...], object] = {}

    # -- metadata -------------------------------------------------------
    @property
    def shape(self) -> List[int]:
        return list(self._ids.shape)

    @property
    def ndim(self) -> int:
        return self._ids.ndim

    @property
    def dim_names(self) -> List[str]:
        return list(self._dim_names)

    @property
    def process_ids(self) -> List[int]:
        return self._ids.reshape(-1).tolist()

    @property
    def size(self):
        return int(self._ids.size)

    def get_dim_size(self, name: str) -> int:
        return self._ids.shape[self._dim_names.index(name)]

    def dim_size(self, name: str) -> int:
        """The size of axis ``name``, 1 for an axis the mesh lacks."""
        return self.get_dim_size(name) if name in self._dim_names else 1

    def get_rank_by_dim_and_process_id(self, dim, process_id):
        axis = self._dim_names.index(dim) if isinstance(dim, str) else dim
        pos = np.argwhere(self._ids == process_id)
        if len(pos) == 0:
            return -1
        return int(pos[0][axis])

    def coord(self, rank: int) -> Optional[Tuple[int, ...]]:
        """``rank``'s coordinates on the mesh, None if it is not on it."""
        pos = np.argwhere(self._ids == rank)
        return None if len(pos) == 0 else tuple(int(c) for c in pos[0])

    def axis_index(self, axes, rank: int) -> int:
        """``rank``'s position along the (C-ordered) product of ``axes``."""
        c = self.coord(rank)
        idx = 0
        for a in self._axes(axes):
            d = self._dim_names.index(a)
            idx = idx * self._ids.shape[d] + c[d]
        return idx

    def _axes(self, axes) -> Tuple[str, ...]:
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes if a in self._dim_names)
        return tuple(sorted(axes, key=self._dim_names.index))

    def group_ranks(self, axes, rank: int) -> List[int]:
        """The ranks that share ``rank``'s coordinates off ``axes``, in
        C order over ``axes``."""
        axes = self._axes(axes)
        c = self.coord(rank)
        idx = tuple(slice(None) if n in axes else c[i]
                    for i, n in enumerate(self._dim_names))
        return self._ids[idx].reshape(-1).tolist()

    def group(self, axes):
        """This rank's communication group along ``axes`` (a name or a
        tuple of names; names the mesh lacks are dropped). Made once and
        cached; None when this rank is not on the mesh."""
        from paddle_tpu_torch.distributed import communication as comm
        from paddle_tpu_torch.distributed.env import get_rank

        key = self._axes(axes)
        if key not in self._groups:
            me = get_rank()
            if self.coord(me) is None:
                return None
            self._groups[key] = comm.new_group(
                self.group_ranks(key, me), axis_name="+".join(key) or "self",
                mesh=self)
        return self._groups[key]

    def __getitem__(self, index):
        """The sub-mesh at ``index`` of the leading dims."""
        sub = self._ids[index]
        if np.ndim(sub) == 0:
            return ProcessMesh([int(sub)], dim_names=["d0"])
        idx = index if isinstance(index, tuple) else (index,)
        dropped = [i for i, ix in enumerate(idx) if isinstance(ix, int)]
        names = [n for i, n in enumerate(self._dim_names)
                 if i not in dropped]
        return ProcessMesh(sub, dim_names=names)

    def get_submesh_with_dim(self, dim_name: str, index: Optional[int] = None):
        """The 1-D mesh along ``dim_name`` through this rank (or through
        position ``index`` of the other dims' C order)."""
        from paddle_tpu_torch.distributed.env import get_rank

        d = self._dim_names.index(dim_name)
        moved = np.moveaxis(self._ids, d, -1).reshape(-1, self._ids.shape[d])
        if index is None:
            rows = [r for r in moved if get_rank() in r]
            row = rows[0] if rows else moved[0]
        else:
            row = moved[index]
        return ProcessMesh(row, dim_names=[dim_name])

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and np.array_equal(self._ids, other._ids)
                and self._dim_names == other._dim_names)

    def __hash__(self):
        return hash((self._ids.tobytes(), tuple(self._dim_names)))

    def __repr__(self):
        return (f"ProcessMesh(shape={self.shape}, "
                f"dim_names={self._dim_names})")


def placements_to_layout(mesh: ProcessMesh, placements: Sequence[Placement],
                         ndim: int):
    """One placement per mesh dim -> the
    :class:`~paddle_tpu_torch.distributed.redistribute.Layout` over the
    mesh's axes (a ``Partial`` is laid out as replicated: its sum is
    pending)."""
    from paddle_tpu_torch.distributed.redistribute import Layout

    dims: List[Optional[str]] = [None] * ndim
    for name, pl in zip(mesh.dim_names, placements):
        if isinstance(pl, Shard):
            d = pl.dim % ndim
            if dims[d] is not None:
                raise ValueError(f"tensor dim {d} is split over both "
                                 f"{dims[d]!r} and {name!r}")
            dims[d] = name
    return Layout(list(zip(mesh.dim_names, mesh.shape)), dims)


# -- global default mesh -----------------------------------------------------
_global_mesh: Optional[ProcessMesh] = None


def set_mesh(mesh: ProcessMesh):
    global _global_mesh
    _global_mesh = mesh


def get_mesh() -> Optional[ProcessMesh]:
    return _global_mesh


def init_mesh(shape: Sequence[int], dim_names: Sequence[str]) -> ProcessMesh:
    """A mesh of the given logical shape over ranks 0..n-1, set as the
    default mesh."""
    n = int(np.prod(shape))
    mesh = ProcessMesh(np.arange(n).reshape(shape), dim_names=list(dim_names))
    set_mesh(mesh)
    return mesh


def auto_mesh(*dim_names: str) -> ProcessMesh:
    """A 1-D mesh over every rank of the world."""
    from paddle_tpu_torch.distributed.env import get_world_size

    name = dim_names[0] if dim_names else "x"
    return init_mesh([get_world_size()], [name])


def create_hybrid_mesh(ici_shape: Sequence[int], dcn_shape: Sequence[int],
                       dim_names: Sequence[str]) -> ProcessMesh:
    """A mesh whose axis i spans ``dcn_shape[i] * ici_shape[i]`` ranks,
    the slow (cross-host) factor outermost: ranks are laid out so that an
    axis with ``dcn_shape[i] == 1`` stays within one host's block of
    ``prod(ici_shape)`` consecutive ranks. The JAX package builds the
    same layout over TPU slices; the world must hold exactly that many
    ranks."""
    from paddle_tpu_torch.distributed.env import get_world_size

    ici_shape, dcn_shape = list(ici_shape), list(dcn_shape)
    if len(ici_shape) != len(dcn_shape) or \
            len(ici_shape) != len(dim_names):
        raise ValueError("ici_shape, dcn_shape and dim_names must have "
                         "the same length")
    total = int(np.prod(ici_shape)) * int(np.prod(dcn_shape))
    world = get_world_size()
    if total != world:
        raise ValueError(f"mesh wants {total} ranks, {world} in the world")
    nd = len(ici_shape)
    # rank = host block (C order over dcn) * prod(ici) + position in block
    ids = np.arange(total).reshape(dcn_shape + ici_shape)
    perm = [i for pair in zip(range(nd), range(nd, 2 * nd)) for i in pair]
    ids = ids.transpose(perm).reshape(
        [d * i for d, i in zip(dcn_shape, ici_shape)])
    mesh = ProcessMesh(ids, dim_names=list(dim_names))
    mesh._dcn_shape = dcn_shape
    mesh._ici_shape = ici_shape
    return mesh
