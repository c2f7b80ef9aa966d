"""Checkpoints: save a state dict of tensors as chunks plus a manifest,
and load any chunk layout back (port of the JAX package's
``distributed/checkpoint/__init__.py``).

The on-disk format is the JAX package's: ``metadata.json`` (per tensor:
global shape, logical dtype, chunks with their global offsets, files and
npz keys), ``objects.json`` (the non-numeric leaves, a scheduler's
``mode="min"`` and the like) and one ``data_<rank>.npz`` per process.
bfloat16 chunks are stored as uint16 views with the logical dtype in the
manifest. Python numbers are stored at their own width (a float as
float64, an int as int64; the JAX package, without x64, stores them as
float32 and int32), so a restored lr or count is the one that was saved.

One process writes each tensor whole, as one chunk at offset 0. In a
world of several ranks (the JAX package's multi-host format) each rank
writes the chunks of ITS shards at their global offsets into
``data_<rank>.npz`` and its part of the manifest; after a barrier rank 0
merges the parts into ``metadata.json``. A chunk that several ranks hold
(a replica) is written once, by the lowest rank that holds it; a leaf
with no layout is replicated, and rank 0 writes it. Every rank puts a
digest of each such leaf (shape, dtype and an exact checksum of its
bytes) into its part, and rank 0 fails the save when the ranks' digests
differ: a copy or a cast of a shard carries no layout, and would
otherwise be saved as rank 0's shard for all. The barriers are the
world's store barriers, never a gloo collective: an async save writes
from a thread that is not the main one.

Where a leaf's layout comes from: a :class:`~paddle_tpu_torch.
distributed.ParallelTrainStep` registers its model's parameters and its
optimizer's slots (:func:`register_layouts`), and a leaf that shares a
registered tensor's storage (``model.state_dict()`` and
``opt.state_dict()`` give detached views of them) carries that tensor's
:class:`~paddle_tpu_torch.distributed.redistribute.Layout` and this
rank's shard index; a view that permutes its dims (a transpose) carries
the layout permuted with them. A parameter's layout is its
``_dist_plan``'s, a slot's adds the ZeRO slice. The same lookup decides
what a rank loads: its shard of the stored global tensor, from any chunk
layout, so a restore at another layout is the reshard.

Loading fills the given state dict: a tensor leaf IN PLACE (a model's or
an optimizer's live tensors, on whatever device they are), any other
leaf by replacing it in the dict. The save is atomic at the directory
level (staged into ``<path>.tmp``, renamed into place). For step series
with commit markers, retention and auto-resume use
:class:`CheckpointManager`.
"""
from __future__ import annotations

import copy
import itertools
import json
import os
import shutil
import time
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.distributed.checkpoint.metadata import (
    LocalTensorMetadata, Metadata, TensorMetadata,
)
from paddle_tpu_torch.testing import faults as _faults

__all__ = ["save_state_dict", "load_state_dict", "Metadata",
           "CheckpointManager"]

_META_FILE = "metadata.json"
_OBJECTS_FILE = "objects.json"  # non-numeric leaves (scheduler modes &c)


def _data_file(rank: int) -> str:
    """One data file per process (the reference's {rank}_{id}.distcp)."""
    return f"data_{int(rank)}.npz"


def _world():
    """(rank, world size) of this process."""
    from paddle_tpu_torch.distributed import env

    return env.get_rank(), env.get_world_size()


def _fsync_path(path: str):
    """fsync a written file (or directory entry) so a committed
    checkpoint survives power loss, not just process death."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif v is None:
            continue
        else:
            out[key] = v
    return out


def _set_by_path(d, path, value):
    def key_of(dd, p):
        # keys may be non-str originally (e.g. int ids); match by str()
        for k in dd:
            if str(k) == p:
                return k
        return p

    parts = path.split("/")
    for p in parts[:-1]:
        d = d[key_of(d, p)]
    d[key_of(d, parts[-1])] = value


def _host_array(v):
    """(numpy array as stored, logical dtype) for a numeric leaf, or None
    for a leaf that goes to objects.json. Always a copy: an async save
    writes it after the caller's next in-place update, and a CPU tensor's
    ``.cpu()`` (or an array's ``asarray``) would share the live memory."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", memory_format=torch.contiguous_format,
                          copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _logical(t.dtype)
    try:
        arr = np.array(v)
    except (TypeError, ValueError):
        return None
    if arr.dtype.kind not in "biuf":
        return None
    if arr.dtype.name == "bfloat16":   # ml_dtypes' numpy bfloat16
        return np.ascontiguousarray(arr).view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


# ---------------------------------------------------------------------------
# where a leaf's shard lies (the layouts a ParallelTrainStep registers)
# ---------------------------------------------------------------------------
_sources = weakref.WeakSet()


def register_layouts(source) -> None:
    """Register ``source``, whose ``shard_layouts()`` yields ``(tensor,
    Layout, global shape, shard index, mesh ids)`` for each tensor it
    holds as this rank's shard (shard i of the layout lies on rank
    ``mesh ids[i]``; a :class:`~paddle_tpu_torch.distributed.
    ParallelTrainStep` registers itself). Held weakly."""
    _sources.add(source)


def _key(t: torch.Tensor):
    return (t.device, t.untyped_storage().data_ptr(), t.storage_offset(),
            t.dtype)


def _shard_index():
    """``{storage key: [(tensor, layout, global shape, index, ids)]}``
    over the registered sources, read now (slots may have been
    rebound)."""
    out = {}
    for src in list(_sources):
        for ent in src.shard_layouts():
            out.setdefault(_key(ent[0]), []).append(ent)
    return out


def _permutation(shape, stride, reg):
    """``perm`` with ``shape[i] == reg.shape[perm[i]]`` (and the strides
    alike) when a tensor of ``shape``/``stride`` views ``reg``'s elements
    with its dims permuted, else None."""
    rs, rt = tuple(reg.shape), tuple(reg.stride())
    if len(rs) != len(shape):
        return None
    for perm in itertools.permutations(range(len(rs))):
        if all(shape[i] == rs[perm[i]] and
               (shape[i] == 1 or stride[i] == rt[perm[i]])
               for i in range(len(rs))):
            return perm
    return None


def _shard_of(v, index_map):
    """``(layout, global shape, index, mesh ids)`` of leaf ``v`` when it
    is (a dim permutation of) a registered shard, else None
    (replicated)."""
    t = _torch_leaf(v)
    if t is None or index_map is None:
        return None
    for reg, lay, gshape, index, ids in index_map.get(_key(t), ()):
        perm = _permutation(tuple(t.shape), tuple(t.stride()), reg)
        if perm is None:
            continue
        if list(perm) != list(range(len(perm))):
            from paddle_tpu_torch.distributed.redistribute import Layout

            lay = Layout(lay.mesh_axes,
                         [lay.dim_placements[d] for d in perm])
            gshape = tuple(gshape[d] for d in perm)
        return lay, tuple(gshape), index, ids
    return None


def _torch_leaf(v) -> Optional[torch.Tensor]:
    if isinstance(v, torch.Tensor):
        return v
    d = getattr(v, "_data", None)
    return d if isinstance(d, torch.Tensor) else None


def _holders(lay, gshape, index, ids):
    """The ranks that hold the same chunk as shard ``index``."""
    mine = lay.shard_slices(gshape, index)
    return [r for i, r in enumerate(ids)
            if lay.shard_slices(gshape, i) == mine]


_DIGEST_CHUNK = 1 << 24   # bytes a checksum pass reads at a time
_DIGEST_MOD = 65521


def _digest(t: torch.Tensor) -> list:
    """Shape, dtype and a checksum of ``t``'s bytes (their sum and their
    sum weighted by position mod 65521, Fletcher's way), computed where
    ``t`` lies. Integer sums are exact, so ranks holding the same bytes
    agree on any device."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    s1 = torch.zeros((), dtype=torch.int64, device=b.device)
    s2 = torch.zeros((), dtype=torch.int64, device=b.device)
    for i in range(0, b.numel(), _DIGEST_CHUNK):
        c = b[i:i + _DIGEST_CHUNK].to(torch.int64)
        w = torch.arange(i, i + c.numel(), dtype=torch.int64,
                         device=b.device) % _DIGEST_MOD + 1
        s1 += c.sum()
        s2 += (c * w).sum()
    return [list(t.shape), _logical(t.dtype), int(s1), int(s2)]


def _collect(state_dict: Dict):
    """Device->host snapshot of a (possibly nested) state dict. Returns
    ``(arrays, tensors_meta, data_file, objects, replicas)``. This is
    the only part of a save that must block the train loop: the async
    CheckpointManager runs it inline and hands the result to a writer
    thread. One process stores each tensor whole; in a world of several
    ranks each rank copies only the chunks it is the lowest holder of,
    and ``replicas`` holds the :func:`_digest` of each tensor leaf with
    no layout (empty at world 1)."""
    rank, world = _world()
    index_map = _shard_index() if world > 1 else None
    arrays, tensors_meta, objects, replicas = {}, {}, {}, {}
    data_file = _data_file(rank if world > 1 else 0)
    for name, v in _flatten(state_dict).items():
        shard = _shard_of(v, index_map)
        t = _torch_leaf(v)
        writes = True
        offset = None
        if world > 1:
            if shard is not None:
                lay, gshape, index, ids = shard
                writes = min(_holders(lay, gshape, index, ids)) == rank
                offset = tuple(sl.start for sl in
                               lay.shard_slices(gshape, index))
            else:
                writes = rank == 0
                if t is not None:
                    replicas[name] = _digest(t)
        if not writes and t is not None:
            # a replica another rank writes: the manifest entry only
            tensors_meta[name] = TensorMetadata(
                tuple(shard[1]) if shard else tuple(t.shape),
                _logical(t.dtype), [])
            continue
        got = _host_array(v)
        if got is None:
            objects[name] = copy.deepcopy(v)
            continue
        arr, logical = got
        shape = tuple(int(s) for s in arr.shape)
        gshape = tuple(shard[1]) if shard else shape
        chunks = []
        if writes:
            key = f"{name}__c0"
            arrays[key] = arr
            chunks.append(LocalTensorMetadata(
                offset if offset is not None else (0,) * arr.ndim, shape,
                data_file, key))
        tensors_meta[name] = TensorMetadata(gshape, logical, chunks)
    return arrays, tensors_meta, data_file, objects, replicas


def _logical(dtype: torch.dtype) -> str:
    return "bfloat16" if dtype == torch.bfloat16 else \
        str(dtype).split(".")[-1]


# ---------------------------------------------------------------------------
# the world's store barrier (the writer may be a thread)
# ---------------------------------------------------------------------------
_save_seq = itertools.count(1)


def _namespace() -> str:
    """A fresh barrier namespace: the incarnation of the gang (the
    launcher's ``PADDLE_RESTART_COUNT``) and the number of saves so far,
    which every rank counts alike, since saves are collective."""
    return (f"r{os.environ.get('PADDLE_RESTART_COUNT', '0')}"
            f"_p{next(_save_seq)}")


def store_barrier(name: str, fail_key: Optional[str] = None,
                  timeout: float = 300.0) -> None:
    """Wait until every rank of the world has reached barrier ``name``
    (the world's store: the default group's, or ``PADDLE_STORE_DIR``'s).
    A rank whose part of the work failed posts ``fail_key``, and every
    rank waiting here then raises ``OSError`` naming it, instead of
    waiting out the timeout."""
    from paddle_tpu_torch.distributed.store import current_store

    store = current_store()
    _, world = _world()
    if store.add(f"{name}/enter", 1) >= world:
        store.set(f"{name}/done", b"1")
    deadline = time.monotonic() + timeout
    while store.try_get(f"{name}/done") is None:
        who = store.try_get(fail_key) if fail_key else None
        if who is not None:
            raise PeerFailed(f"rank {who.decode()} failed its part of "
                             f"the save (barrier {name!r})")
        if time.monotonic() > deadline:
            raise TimeoutError(f"barrier {name!r} not reached by every "
                               f"rank within {timeout}s")
        time.sleep(0.01)


class PeerFailed(OSError):
    """Another rank's part of a collective save failed."""


def post_failure(fail_key: str, err: BaseException) -> None:
    """Tell the ranks waiting in a barrier with ``fail_key`` that this
    rank's part failed with ``err`` (a :class:`PeerFailed`, which another
    rank posted already, is not posted again)."""
    if isinstance(err, PeerFailed):
        return
    from paddle_tpu_torch.distributed.store import current_store

    try:
        current_store().set(fail_key, str(_world()[0]))
    except Exception:
        pass  # the store is gone with the gang: nothing waits any more


def _default_barrier(tag: str, fail_key: Optional[str] = None):
    """The world's store barrier (the JAX package's
    ``sync_global_devices``; a gloo collective cannot run from an async
    writer thread)."""
    store_barrier(f"ckpt_{tag}", fail_key)


def _write_data(path: str, arrays: Dict, tensors_meta: Dict,
                data_file: str, barrier=None, objects=None, replicas=None):
    """Write this process's chunks and manifest into ``path`` (which
    already exists), fsyncing every file. In a world of several ranks
    each writes its ``data_<rank>.npz`` and ``metadata_part<rank>.json``
    (with ``replicas``, its digests of the leaves with no layout); after
    ``barrier(tag)`` rank 0 merges the parts into the manifest, failing
    if the ranks' digests of a leaf differ, and a second barrier holds
    every rank until it has."""
    rank, world = _world()
    if barrier is None:
        barrier = _default_barrier
    np.savez(os.path.join(path, data_file), **arrays)
    _fsync_path(os.path.join(path, data_file))
    if objects and rank == 0:
        # host-side non-numeric state is the same on every rank
        obj_file = os.path.join(path, _OBJECTS_FILE)
        with open(obj_file, "w") as f:
            json.dump(objects, f)
        _fsync_path(obj_file)
    _faults.fire(_faults.CKPT_DATA_WRITTEN)
    if world == 1:
        Metadata(tensors_meta).save(os.path.join(path, _META_FILE))
        _fsync_path(os.path.join(path, _META_FILE))
        return
    part_file = os.path.join(path, f"metadata_part{rank}.json")
    with open(part_file, "w") as f:
        json.dump({"tensors": {k: v.to_json()
                               for k, v in tensors_meta.items()},
                   "replicas": replicas or {}}, f)
    _fsync_path(part_file)
    barrier(f"save:{path}")
    if rank == 0:
        merged, digests = {}, {}
        for p in range(world):
            with open(os.path.join(path, f"metadata_part{p}.json")) as f:
                part = json.load(f)
            for name, d in part["replicas"].items():
                digests.setdefault(name, {}).setdefault(
                    json.dumps(d), []).append(p)
            for name, raw in part["tensors"].items():
                tm = TensorMetadata.from_json(raw)
                if name not in merged:
                    merged[name] = tm
                    continue
                have = {c.global_offset for c in merged[name].chunks}
                for c in tm.chunks:
                    if c.global_offset not in have:
                        merged[name].chunks.append(c)
                        have.add(c.global_offset)
        # a leaf saved as replicated that the ranks hold differently: a
        # copy or a cast of a shard (it carries no layout)
        split = sorted(n for n, ds in digests.items() if len(ds) > 1)
        if split:
            groups = sorted(digests[split[0]].values())
            raise ValueError(
                f"checkpoint at {path!r}: {split[:8]} have no layout, so "
                f"they are saved as replicated, but the ranks hold "
                f"different values (ranks grouped by value: {groups}); a "
                f"copy or a cast of a shard carries no layout: save the "
                f"state_dict's own tensors, or register the layout "
                f"(checkpoint.register_layouts)")
        # a leaf no rank wrote: held by some ranks only, with no layout
        # registered for it (a pipeline stage's layers)
        lost = sorted(n for n, tm in merged.items() if not tm.chunks)
        if lost:
            raise ValueError(
                f"checkpoint at {path!r}: no rank wrote {lost[:8]}; a leaf "
                f"that only some ranks hold needs its layout registered "
                f"(checkpoint.register_layouts)")
        Metadata(merged).save(os.path.join(path, _META_FILE))
        _fsync_path(os.path.join(path, _META_FILE))
    barrier(f"save_done:{path}")


def _is_ckpt(d):
    return os.path.exists(os.path.join(d, _META_FILE))


def save_state_dict(state_dict: Dict, path: str):
    """Write a (possibly nested) state dict under directory ``path``;
    every rank of a world calls it with its own shards.

    Atomic at the directory level: everything is staged into
    ``<path>.tmp`` and renamed into place (by rank 0, behind barriers)
    once every file is written and fsynced; an old checkpoint at
    ``path`` stays whole (briefly at ``<path>.old``) until the new one
    has landed."""
    arrays, tensors_meta, data_file, objects, replicas = _collect(state_dict)
    rank, world = _world()
    ns = _namespace()
    fail = f"ckpt_{ns}_failed"

    def barrier(tag):
        _default_barrier(f"{ns}_{tag}", fail)

    path = path.rstrip("/")
    tmp, old = path + ".tmp", path + ".old"
    try:
        if rank == 0:
            # the commit REPLACES ``path`` wholesale: refuse to destroy a
            # populated directory that is not a checkpoint
            for d in (path, old):
                if os.path.isdir(d) and not _is_ckpt(d) and os.listdir(d):
                    raise ValueError(
                        f"refusing to replace {d!r}: it exists, is not "
                        f"empty, and holds no {_META_FILE}; the atomic "
                        f"commit would delete its contents. Save to a "
                        f"fresh or checkpoint-holding path.")
            # a crash between the two commit renames leaves the only
            # complete checkpoint parked at <path>.old: put it back first
            if not os.path.isdir(path) and os.path.isdir(old) and \
                    _is_ckpt(old):
                os.rename(old, path)
            shutil.rmtree(tmp, ignore_errors=True)
            shutil.rmtree(old, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
        if world > 1:
            barrier("stage")
        _write_data(tmp, arrays, tensors_meta, data_file, barrier=barrier,
                    objects=objects, replicas=replicas)
        if rank == 0:
            _faults.fire(_faults.CKPT_BEFORE_COMMIT)
            if os.path.isdir(path):
                os.rename(path, old)
            os.replace(tmp, path)
            _fsync_path(os.path.dirname(os.path.abspath(path)) or ".")
            shutil.rmtree(old, ignore_errors=True)
        if world > 1:
            barrier("commit")
    except BaseException as e:
        if world > 1:
            post_failure(fail, e)
        raise


def _union_volume(boxes, shape) -> int:
    """Exact union volume of half-open (lo, hi) boxes (coordinate
    compression; a 1-byte mask for degenerate boundary sets)."""
    if not shape:
        return 1 if boxes else 0
    bounds = []
    for d, dim in enumerate(shape):
        bs = {0, dim}
        for lo, hi in boxes:
            bs.add(lo[d])
            bs.add(hi[d])
        bounds.append(sorted(bs))
    cell_shape = [len(b) - 1 for b in bounds]
    if int(np.prod(cell_shape)) > max(16_000_000, int(np.prod(shape))):
        mask = np.zeros(shape, dtype=bool)
        for lo, hi in boxes:
            mask[tuple(slice(l, h) for l, h in zip(lo, hi))] = True
        return int(mask.sum())
    idx = [{v: i for i, v in enumerate(b)} for b in bounds]
    hit = np.zeros(cell_shape, dtype=bool)
    for lo, hi in boxes:
        hit[tuple(slice(idx[d][lo[d]], idx[d][hi[d]])
                  for d in range(len(shape)))] = True
    vol = np.diff(bounds[0]).astype(np.int64)
    for b in bounds[1:]:
        vol = np.multiply.outer(vol, np.diff(b).astype(np.int64))
    return int(vol[hit].sum())


def _validate_tensor(name: str, tm: TensorMetadata, path: str):
    """Every referenced chunk file exists and the chunks tile the global
    shape: one clear error naming the tensor, never a partial restore."""
    for ch in tm.chunks:
        if not os.path.exists(os.path.join(path, ch.file)):
            raise ValueError(
                f"checkpoint at {path!r}: tensor {name!r} references "
                f"chunk file {ch.file!r} which is missing on disk; the "
                f"checkpoint is torn or incomplete")
    total = int(np.prod(tm.global_shape)) if tm.global_shape else 1
    seen, boxes = set(), []
    for ch in tm.chunks:
        if ch.global_offset in seen:
            continue
        seen.add(ch.global_offset)
        lo = tuple(int(o) for o in ch.global_offset)
        hi = tuple(min(o + l, d) for o, l, d in
                   zip(lo, ch.local_shape, tm.global_shape))
        if any(h <= l for l, h in zip(lo, hi)):
            continue
        boxes.append((lo, hi))
    covered = _union_volume(boxes, tm.global_shape)
    if covered < total:
        raise ValueError(
            f"checkpoint at {path!r}: chunks for tensor {name!r} cover "
            f"only {covered}/{total} elements of global shape "
            f"{tm.global_shape}; the manifest has a coverage hole")


def _assemble(get_npz, meta: TensorMetadata, name="?",
              region=None) -> np.ndarray:
    """The global slice ``region`` (a tuple of slices; the whole tensor
    by default) from the chunks, as stored (bf16 as uint16); raises
    unless the chunks tile it."""
    gshape = list(meta.global_shape)
    if region is None:
        region = tuple(slice(0, d) for d in gshape)
    starts = [0 if sl.start is None else int(sl.start) for sl in region]
    stops = [d if sl.stop is None else int(sl.stop)
             for sl, d in zip(region, gshape)]
    shape = [b - a for a, b in zip(starts, stops)]
    total = int(np.prod(shape)) if shape else 1
    out, copied, covered = None, [], 0
    for ch in meta.chunks:
        c_lo = list(ch.global_offset)
        c_hi = [a + n for a, n in zip(c_lo, ch.local_shape)]
        lo = [max(a, c) for a, c in zip(starts, c_lo)]
        hi = [min(b, c) for b, c in zip(stops, c_hi)]
        if shape and any(l >= h for l, h in zip(lo, hi)):
            continue
        try:
            chunk = get_npz(ch.file)[ch.key]
        except KeyError:
            raise ValueError(
                f"tensor {name!r}: chunk key {ch.key!r} is absent from "
                f"{ch.file!r}; the data file is torn or from a different "
                f"save than the manifest") from None
        if not shape:  # 0-d
            return chunk
        if out is None:
            out = np.empty(shape, dtype=chunk.dtype)
        dst = tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, starts))
        src = tuple(slice(l - c, h - c) for l, h, c in zip(lo, hi, c_lo))
        out[dst] = chunk[src]
        copied.append((tuple(d.start for d in dst),
                       tuple(d.stop for d in dst)))
        covered += int(np.prod([h - l for l, h in zip(lo, hi)]))
    if out is None:
        raise ValueError(f"tensor {name!r}: no saved chunks cover it")
    if covered >= total:
        # the sum can double-count overlapping chunks: confirm exactly
        covered = _union_volume(copied, shape)
    if covered < total:
        raise ValueError(
            f"tensor {name!r}: saved chunks cover only {covered}/{total} "
            f"elements (missing shard file?)")
    return out


def _to_torch(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def load_state_dict(state_dict: Dict, path: str, shards: Dict = None):
    """Fill ``state_dict`` from the checkpoint at ``path``: each tensor
    leaf in place (cast to its dtype, on its device), each other leaf
    replaced (a number keeps its Python type). A leaf that is a
    registered shard (:func:`register_layouts`: a ParallelTrainStep's
    parameters and slots) receives this rank's shard of the stored
    global tensor, from whatever chunks the checkpoint holds. ``shards``
    maps a tensor leaf's name to ``(layout, index)``: that leaf receives
    shard ``index`` of the stored global tensor under the
    :class:`~paddle_tpu_torch.distributed.redistribute.Layout` (the
    layout is validated against the stored shape, ``ValueError`` on a
    misfit). A leaf of the shard's shape is filled in place; a leaf of
    the global shape is rebound to the shard (``tensor.data``), so a
    model's parameter then holds its shard only."""
    shards = shards or {}
    rank, world = _world()
    if world == 1 and not os.path.isdir(path):
        # a crash between save_state_dict's two commit renames parks the
        # only complete checkpoint at <path>.old: put it back (one
        # process only: in a gang the rename would race the peers'
        # reads, and CheckpointManager recovers on rank 0)
        old = path.rstrip("/") + ".old"
        if os.path.isdir(old) and _is_ckpt(old):
            os.rename(old, path)
    meta = Metadata.load(os.path.join(path, _META_FILE))
    objects = {}
    obj_file = os.path.join(path, _OBJECTS_FILE)
    if os.path.exists(obj_file):
        with open(obj_file) as f:
            objects = json.load(f)
    npz = {}

    def get_npz(fname):
        if fname not in npz:
            npz[fname] = np.load(os.path.join(path, fname))
        return npz[fname]

    index_map = _shard_index() if _sources else None
    missing = []
    for name, v in _flatten(state_dict).items():
        if name in objects:
            _set_by_path(state_dict, name, objects[name])
            continue
        tm = meta.tensors.get(name)
        if tm is None:
            missing.append(name)
            continue
        shape = tuple(int(s) for s in (
            v.shape if isinstance(v, torch.Tensor) else np.shape(v)))
        sl = None
        if name in shards:
            lay, index = shards[name]
            lay.validate_shape(tm.global_shape)
            sl = lay.shard_slices(tm.global_shape, index)
            if shape not in (lay.local_shape(tm.global_shape),
                             tm.global_shape):
                raise ValueError(
                    f"shape mismatch for {name!r}: shard "
                    f"{lay.local_shape(tm.global_shape)} of checkpoint "
                    f"{tm.global_shape} vs target {shape}")
        else:
            mine = _shard_of(v, index_map)
            if mine is not None:
                lay, gshape, index, _ = mine
                if gshape != tuple(tm.global_shape):
                    raise ValueError(
                        f"shape mismatch for {name!r}: checkpoint "
                        f"{tm.global_shape} vs the shard's global shape "
                        f"{gshape}")
                sl = lay.shard_slices(gshape, index)
            elif shape != tm.global_shape:
                raise ValueError(
                    f"shape mismatch for {name!r}: checkpoint "
                    f"{tm.global_shape} vs target {shape}")
        _validate_tensor(name, tm, path)
        got = _to_torch(_assemble(get_npz, tm, name, sl), tm.dtype)
        if sl is not None:
            part = got.to(device=v.device, dtype=v.dtype)
            with torch.no_grad():
                if shape == tuple(part.shape):
                    v.copy_(part)
                else:
                    v.data = part.contiguous()
        elif isinstance(v, torch.Tensor):
            with torch.no_grad():
                v.copy_(got.to(v.device))
        else:
            val = got.numpy() if got.dtype != torch.bfloat16 else got
            if isinstance(v, (bool, int, float)):
                val = type(v)(val.item())
            elif isinstance(v, np.ndarray):
                val = np.asarray(val, dtype=v.dtype)
            _set_by_path(state_dict, name, val)
    if missing:
        raise KeyError(
            f"checkpoint at {path} is missing tensors: {missing[:8]}"
            + ("..." if len(missing) > 8 else ""))


from paddle_tpu_torch.distributed.checkpoint.manager import (  # noqa: E402
    CheckpointManager,
)
