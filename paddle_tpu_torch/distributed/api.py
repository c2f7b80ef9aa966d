"""The semi-auto parallel API (port of ``paddle_tpu/distributed/api.py``):
``shard_tensor`` / ``reshard`` / ``dtensor_from_local`` / ``shard_layer``
/ ``shard_optimizer`` / ``ShardDataloader`` / ``DistModel``.

Reference: python/paddle/distributed/auto_parallel/api.py
(shard_tensor:130, dtensor_from_local:266, reshard:346, shard_layer:445,
shard_optimizer:1120) over phi DistTensor.

The JAX package's DistTensor is a Tensor whose jax.Array carries a
``NamedSharding``; XLA's propagation plays the per-op SPMD rules. Here a
DistTensor is a port Tensor whose data is a
``torch.distributed.tensor.DTensor`` over the ``DeviceMesh`` of the
port's :class:`~paddle_tpu_torch.distributed.mesh.ProcessMesh` (one
process per rank, each holding its shard): PyTorch's own form of this
API, whose per-op propagation and autograd give the global-view values
the JAX package computes. Where they differ the port follows the JAX
package: an eager op's ``Partial`` output is reduced at once (GSPMD never
lets a pending sum escape an op), and a plain tensor operand joins as
replicated. ``process_mesh`` and ``placements`` are the port's objects.

``shard_optimizer(opt, ShardingStage1/2/3(axis, mesh))`` installs
``opt._slot_shard_fn``: each slot the optimizer creates (eager steps,
``TrainStep``, ``ParallelTrainStep``, ``PipelineTrainStep``) is placed
sharded over ``axis`` on its first dim the axis divides, so a rank holds
1/n of its elements; the update of a replicated parameter then runs on
the slices and is gathered back (ZeRO-1). ``ShardingStage3`` places the
parameters so too. ``DistModel`` / ``to_static`` wrap
``ParallelTrainStep``, as the JAX package's do.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.distributed.mesh import (Partial, ProcessMesh,
                                               Replicate, Shard)

__all__ = ["shard_tensor", "dtensor_from_local", "reshard", "shard_layer",
           "shard_optimizer", "unshard_dtensor", "dtensor_to_local",
           "ShardingStage1", "ShardingStage2", "ShardingStage3",
           "ShardDataloader", "shard_dataloader", "DistModel", "to_static"]

# id(DeviceMesh) -> (ProcessMesh, DeviceMesh), and id(ProcessMesh) -> the
# same pair: each mesh's DeviceMesh is made once (it makes a group per
# mesh dim, on every rank of the world)
_MESHES: dict = {}


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def device_mesh(mesh: ProcessMesh, device_type: str = None):
    """The ``DeviceMesh`` over ``mesh``'s ranks (made on first use, on
    every rank of the world: ``DeviceMesh`` makes a group per mesh
    dim)."""
    got = _MESHES.get(id(mesh))
    if got is not None:
        return got[1]
    from torch.distributed.device_mesh import DeviceMesh

    if device_type is None:
        from paddle_tpu_torch.core.place import _default_device

        device_type = torch.device(_default_device()).type
    dm = DeviceMesh(device_type,
                    torch.tensor(mesh.process_ids).reshape(mesh.shape),
                    mesh_dim_names=tuple(mesh.dim_names))
    _MESHES[id(mesh)] = _MESHES[id(dm)] = (mesh, dm)
    _enable_eager_propagation()
    return dm


def _torch_placements(placements):
    from torch.distributed.tensor import Partial as TP
    from torch.distributed.tensor import Replicate as TR
    from torch.distributed.tensor import Shard as TS

    out = []
    for p in placements:
        if isinstance(p, Shard):
            out.append(TS(p.dim))
        elif isinstance(p, Partial):
            out.append(TP())
        else:
            out.append(TR())
    return out


def _port_placements(dt, ndim: int):
    out = []
    for p in dt.placements:
        if p.is_shard():
            out.append(Shard(p.dim % max(ndim, 1)))
        elif p.is_partial():
            out.append(Partial())
        else:
            out.append(Replicate())
    return out


def _normalize_placements(mesh: ProcessMesh, placements):
    if placements is None:
        return [Replicate() for _ in range(mesh.ndim)]
    placements = list(placements)
    if len(placements) != mesh.ndim:
        raise ValueError(
            f"need one placement per mesh dim ({mesh.ndim}), got "
            f"{len(placements)}")
    return placements


def _local_of(data: torch.Tensor, mesh: ProcessMesh, placements):
    """This rank's block of the global ``data`` under ``placements``
    (the mesh dims in order, each cutting what the last left)."""
    from paddle_tpu_torch.distributed.env import get_rank

    coord = mesh.coord(get_rank())
    if coord is None:
        raise ValueError(f"rank {get_rank()} is not on the mesh "
                         f"{mesh.process_ids}")
    out = data
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            out = out.chunk(mesh.shape[i], dim=p.dim % out.dim())[coord[i]]
    return out


def from_global(data: torch.Tensor, mesh: ProcessMesh, placements):
    """A DTensor over ``mesh`` whose global value is ``data`` (every rank
    passes the same ``data`` and keeps its block: no communication). The
    block is a copy, so that the global ``data`` can be freed."""
    from torch.distributed.tensor import DTensor

    dm = device_mesh(mesh, data.device.type)
    local = _local_of(data, mesh, placements).clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, dm, _torch_placements(placements),
                              run_check=False, shape=data.shape,
                              stride=data.stride())


def _wrap(dt, mesh: ProcessMesh, placements, stop_gradient=True, like=None):
    out = Tensor._from_data(dt, stop_gradient=stop_gradient)
    out._process_mesh = mesh
    out._placements = list(placements)
    if like is not None and hasattr(like, "trainable"):
        out.__class__ = type(like)
        out.persistable = True
    return out


def _check_divisible(shape, mesh: ProcessMesh, placements):
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d = pl.dim % max(len(shape), 1)
            n = mesh.shape[mesh_dim]
            if shape[d] % n != 0:
                raise ValueError(
                    f"cannot Shard tensor dim {d} (size {shape[d]}) over "
                    f"mesh dim {mesh.dim_names[mesh_dim]!r} (size {n}): "
                    f"the shards must be equal; pad the dim or choose a "
                    f"different placement")


def shard_tensor(data, mesh: ProcessMesh, placements,
                 dtype=None, place=None, stop_gradient=None) -> Tensor:
    """Global-view tensor distributed over ``mesh`` with ``placements``:
    every rank passes the same global ``data`` and keeps its block."""
    t = data if isinstance(data, Tensor) else Tensor(data, dtype=dtype)
    placements = _normalize_placements(mesh, placements)
    if any(p.is_partial() for p in placements):
        raise ValueError("shard_tensor cannot create Partial placements; "
                         "they arise from computation")
    d = t._data.detach()
    if is_dtensor(d):
        d = d.full_tensor()
    _check_divisible(tuple(d.shape), mesh, placements)
    sg = t.stop_gradient if stop_gradient is None else stop_gradient
    dt = from_global(d, mesh, placements)
    if not sg:
        dt = dt.requires_grad_(True)
    return _wrap(dt, mesh, placements, sg, like=t)


def dtensor_from_local(local_tensor, mesh: ProcessMesh, placements
                       ) -> Tensor:
    """Assemble a global DistTensor from each rank's local block
    (reference dtensor_from_local, auto_parallel/api.py:266): global dim
    = local dim x the mesh dim's size for each Shard. Every rank must
    pass a block of the same shape; distinct ranks contribute distinct
    blocks."""
    from torch.distributed.tensor import DTensor

    from paddle_tpu_torch.distributed import communication as comm

    t = (local_tensor if isinstance(local_tensor, Tensor)
         else Tensor(local_tensor))
    placements = _normalize_placements(mesh, placements)
    local = t._data.detach().contiguous()
    g = mesh.group(tuple(mesh.dim_names))
    shapes = [tuple(s.tolist()) for s in comm.all_gather_list(
        torch.tensor(list(local.shape) + [-1] * (8 - local.dim())), g)]
    if len(set(shapes)) > 1:
        raise ValueError(f"dtensor_from_local: the ranks' local blocks "
                         f"differ in shape ({sorted(set(shapes))})")
    dm = device_mesh(mesh, local.device.type)
    dt = DTensor.from_local(local, dm, _torch_placements(placements),
                            run_check=False)
    return _wrap(dt, mesh, placements, t.stop_gradient)


def reshard(dist_tensor: Tensor, mesh: ProcessMesh, placements) -> Tensor:
    """Placement transition (the reference's reshard lattice: s_to_r
    all-gather, p_to_r all-reduce, s_to_s all-to-all, r_to_s slice) in
    one call, through ``DTensor.redistribute``; a Partial source is
    reduced first."""
    placements = _normalize_placements(mesh, placements)
    d = dist_tensor._data
    if not is_dtensor(d):
        return shard_tensor(dist_tensor, mesh, placements)
    dm = device_mesh(mesh, d.device.type)
    if d.device_mesh is not dm:
        d = from_global(d.full_tensor(), mesh, [Replicate()] * mesh.ndim)
    out = d.redistribute(dm, _torch_placements(placements))
    return _wrap(out, mesh, placements, dist_tensor.stop_gradient)


def dtensor_to_local(dist_tensor: Tensor, mesh=None, placements=None
                     ) -> Tensor:
    """This rank's block."""
    d = dist_tensor._data
    local = d.to_local() if is_dtensor(d) else d
    return Tensor._from_data(local, stop_gradient=dist_tensor.stop_gradient)


def unshard_dtensor(dist_tensor: Tensor) -> Tensor:
    """Gather to a fully replicated tensor."""
    mesh = dist_tensor._process_mesh
    if mesh is None:
        return dist_tensor
    return reshard(dist_tensor, mesh,
                   [Replicate() for _ in range(mesh.ndim)])


def _place_param(p, mesh: ProcessMesh, placements):
    """Rebind a Parameter's data to a DistTensor of ``placements``."""
    d = p._data.detach()
    if is_dtensor(d):
        d = d.full_tensor()
    dt = from_global(d, mesh, placements)
    if not p.stop_gradient:
        dt = dt.requires_grad_(True)
    p._data = dt
    p._process_mesh = mesh
    p._placements = list(placements)
    return p


def shard_layer(layer, process_mesh: ProcessMesh, shard_fn=None,
                input_fn=None, output_fn=None):
    """Shard every parameter of ``layer`` over ``process_mesh``:
    ``shard_fn(name, sublayer, mesh)`` places them, else they are
    replicated (reference: api.py:445)."""

    def _default_shard(name, sublayer, mesh):
        for pname, p in list(sublayer._parameters.items()):
            if p is not None:
                _place_param(p, mesh, [Replicate()] * mesh.ndim)

    fn = shard_fn or _default_shard
    for name, sub in layer.named_sublayers(include_self=True):
        fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda lyr, inputs: input_fn(inputs, process_mesh))
    if output_fn is not None:
        layer.register_forward_post_hook(
            lambda lyr, inputs, outputs: output_fn(outputs, process_mesh))
    return layer


class _ShardingStageBase:
    """Callable shard_fn for shard_optimizer (reference
    ShardingStage1/2/3, auto_parallel/api.py:889/950/1036): places each
    optimizer slot sharded along ``sharding_mesh_dim`` on its first
    evenly divisible tensor dim (replicated over the other mesh
    dims)."""

    def __init__(self, sharding_mesh_dim="dp", mesh: ProcessMesh = None):
        self._dim = sharding_mesh_dim
        self._mesh = mesh

    def _mesh_or_default(self):
        if self._mesh is not None:
            return self._mesh
        from paddle_tpu_torch.distributed.mesh import get_mesh

        mesh = get_mesh()
        if mesh is None:
            raise ValueError(
                "ShardingStage needs a mesh: pass mesh= or call "
                "dist.set_mesh/init_mesh first")
        return mesh

    def placements_for(self, shape):
        """The placements of a tensor of ``shape``: Shard on the first
        dim the axis divides, over the axis; else replicated."""
        mesh = self._mesh_or_default()
        out = [Replicate() for _ in range(mesh.ndim)]
        if self._dim in mesh.dim_names and len(shape):
            n = mesh.get_dim_size(self._dim)
            for d, s in enumerate(shape):
                if s > 0 and s % n == 0:
                    out[mesh.dim_names.index(self._dim)] = Shard(d)
                    break
        return out

    def _place(self, arr):
        mesh = self._mesh_or_default()
        if self._dim not in mesh.dim_names or arr.dim() == 0:
            return arr
        pls = self.placements_for(tuple(arr.shape))
        if is_dtensor(arr):
            dm = device_mesh(mesh, arr.device.type)
            if arr.device_mesh is dm:
                return arr.redistribute(dm, _torch_placements(pls))
            arr = arr.full_tensor()
        return from_global(arr.detach(), mesh, pls)

    # shard_fn contract: (slot_key, param_data, slot_value) -> placed value
    def __call__(self, key, param, acc):
        return self._place(acc)


class ShardingStage1(_ShardingStageBase):
    """Optimizer states sharded over the sharding axis (ZeRO-1)."""


class ShardingStage2(_ShardingStageBase):
    """States sharded; the gradients are reduced onto the same slices
    (numerically stage 1's update)."""


class ShardingStage3(_ShardingStageBase):
    """States AND parameters sharded (ZeRO-3): the parameters are
    re-placed at ``shard_optimizer()`` time."""

    def shard_parameter(self, p):
        mesh = self._mesh_or_default()
        if self._dim in mesh.dim_names and p._data.dim():
            _place_param(p, mesh, self.placements_for(tuple(p.shape)))
        return p


def shard_optimizer(optimizer, shard_fn=None):
    """Place optimizer slot states per parameter placements, or per an
    explicit ``shard_fn`` such as ShardingStage1/2/3 (reference
    shard_optimizer, auto_parallel/api.py:1120). Without a shard_fn the
    slots follow each parameter's placement (they are made like it).
    With one, every slot the optimizer makes from now on goes through
    ``shard_fn(key, param, slot)`` (the optimizer's ``_init_slots_mp``
    seam, which every step path uses), and the slots it holds already
    are placed now."""
    if shard_fn is not None:
        optimizer._slot_shard_fn = shard_fn
        if isinstance(shard_fn, ShardingStage3):
            for _, w in getattr(optimizer, "_wrappers", ()):
                shard_fn.shard_parameter(w)
            optimizer._follow_wrappers()
        by_id = {id(p): p for p in (optimizer._parameter_list or [])}
        for pid, slots in list(optimizer._slots.items()):
            optimizer._slots[pid] = {
                k: shard_fn(k, by_id.get(pid), v) for k, v in slots.items()}
    return optimizer


class ShardDataloader:
    """Wrap a DataLoader so each batch lands on the mesh with the batch
    dim sharded over the dp axis (reference ShardDataloader,
    auto_parallel/api.py:2325): every rank's loader yields the global
    batch and keeps its block."""

    def __init__(self, dataloader, meshes, input_keys=None,
                 shard_dims="dp", is_dataset_splitted=False):
        self._loader = dataloader
        self._mesh = meshes[0] if isinstance(meshes, (list, tuple)) \
            else meshes
        self._input_keys = set(input_keys) if input_keys else None
        self._shard_dims = shard_dims

    def _axis_for(self, key):
        sd = self._shard_dims
        if sd is None or isinstance(sd, str):
            return sd or "dp"
        if isinstance(sd, dict):
            return sd.get(key, None)
        if isinstance(sd, (list, tuple)):
            if isinstance(key, int) and key < len(sd):
                return sd[key]
            return None
        return None

    def _place(self, x, key=0):
        if self._input_keys is not None and key not in self._input_keys:
            return x
        t = x if isinstance(x, Tensor) else Tensor(x)
        axis = self._axis_for(key)
        if axis is None or axis not in self._mesh.dim_names:
            return t
        mesh = self._mesh
        pls = [Replicate() for _ in range(mesh.ndim)]
        if t._data.dim() and \
                t._data.shape[0] % mesh.get_dim_size(axis) == 0:
            pls[mesh.dim_names.index(axis)] = Shard(0)
        return _wrap(from_global(t._data.detach(), mesh, pls), mesh, pls,
                     t.stop_gradient)

    def __iter__(self):
        for batch in self._loader:
            if isinstance(batch, dict):
                yield {k: self._place(v, k) for k, v in batch.items()}
            elif isinstance(batch, (list, tuple)):
                yield type(batch)(self._place(v, i)
                                  for i, v in enumerate(batch))
            else:
                yield self._place(batch)

    def __len__(self):
        return len(self._loader)


def shard_dataloader(dataloader, meshes, input_keys=None, shard_dims="dp",
                     is_dataset_splitted=False):
    return ShardDataloader(dataloader, meshes, input_keys, shard_dims,
                           is_dataset_splitted)


class DistModel:
    """Train/eval/predict facade over the parallel step (reference
    DistModel, auto_parallel/api.py:1631): ``ParallelTrainStep`` is the
    engine, as in the JAX package."""

    def __init__(self, layer, loader=None, loss=None, optimizer=None,
                 strategy=None, mesh: ProcessMesh = None):
        from paddle_tpu_torch.distributed.engine import (ParallelConfig,
                                                         ParallelTrainStep)
        from paddle_tpu_torch.distributed.mesh import get_mesh

        self._layer = layer
        self._loss = loss
        self._opt = optimizer
        self._mesh = mesh or get_mesh()
        if self._mesh is None:
            raise ValueError("DistModel needs a mesh: pass mesh= or call "
                             "dist.set_mesh/init_mesh first")
        cfg = None
        if strategy is not None:
            sh = getattr(strategy, "sharding", None)
            stage = getattr(sh, "stage", 0) if sh is not None and \
                getattr(sh, "enable", False) else 0
            cfg = ParallelConfig(sharding_stage=stage)
        self._cfg = cfg
        self._mode = "train"
        self._train_step = None
        if loss is not None and optimizer is not None:
            self._train_step = ParallelTrainStep(
                layer, loss, optimizer, self._mesh, cfg)

    def train(self):
        self._mode = "train"
        self._layer.train()

    def eval(self):
        self._mode = "eval"
        self._layer.eval()

    def predict(self):
        self._mode = "predict"
        self._layer.eval()

    def __call__(self, *batch):
        if self._mode == "train":
            if self._train_step is None:
                raise RuntimeError(
                    "DistModel in train mode needs loss and optimizer")
            return Tensor._from_data(self._train_step(*batch))
        if self._mode == "eval" and self._loss is not None and \
                len(batch) > 1:
            out = self._layer(*batch[:-1])
            return self._loss(out, batch[-1])
        return self._layer(*batch)

    def state_dict(self, *a, **k):
        return self._layer.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layer.set_state_dict(*a, **k)

    def parameters(self, *a, **k):
        return self._layer.parameters(*a, **k)


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None,
              mesh: ProcessMesh = None) -> DistModel:
    """Map (layer, loader, loss, optimizer) onto the parallel step and
    return a DistModel (reference dist.to_static, auto_parallel/api.py:
    2096)."""
    return DistModel(layer, loader, loss, optimizer, strategy, mesh)


# ---------------------------------------------------------------------------
# eager propagation: what an op does with DistTensor operands
# ---------------------------------------------------------------------------
def _enable_eager_propagation():
    from paddle_tpu_torch.ops import registry

    registry._DIST_HOOK = (_dist_run, _dist_tag)


def _dist_run(compute, arguments: dict):
    """Run an op whose operands hold a DTensor: a plain tensor operand
    joins replicated (as a DTensor, so its backward is one too), and a
    Partial output is reduced at once (the JAX package's GSPMD
    semantics)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import Replicate as TR

    dm = next(v.device_mesh for v in _leaves(arguments.values())
              if is_dtensor(v))

    def join(v):
        if isinstance(v, torch.Tensor) and not is_dtensor(v):
            return DTensor.from_local(v, dm, [TR()] * dm.ndim,
                                      run_check=False)
        if isinstance(v, list):
            return [join(x) for x in v]
        return v

    for k, v in list(arguments.items()):
        arguments[k] = join(v)
    out = compute()
    multi = isinstance(out, (tuple, list))
    outs = []
    for o in (out if multi else [out]):
        if is_dtensor(o) and any(p.is_partial() for p in o.placements):
            o = o.redistribute(o.device_mesh,
                               [TR() if p.is_partial() else p
                                for p in o.placements])
        outs.append(o)
    return type(out)(outs) if multi else outs[0]


def _leaves(values):
    for v in values:
        if isinstance(v, (list, tuple)):
            yield from _leaves(v)
        else:
            yield v


def _dist_tag(tensors):
    """Each output Tensor's port mesh and placements."""
    for t in tensors:
        d = t._data
        if is_dtensor(d) and id(d.device_mesh) in _MESHES:
            t._process_mesh = _MESHES[id(d.device_mesh)][0]
            t._placements = _port_placements(d, d.dim())
