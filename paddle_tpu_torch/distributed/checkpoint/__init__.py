"""Checkpoints: save a state dict of tensors as chunks plus a manifest,
and load any chunk layout back (port of the JAX package's
``distributed/checkpoint/__init__.py``, one process).

The on-disk format is the JAX package's: ``metadata.json`` (per tensor:
global shape, logical dtype, chunks with their global offsets, files and
npz keys), ``objects.json`` (the non-numeric leaves, a scheduler's
``mode="min"`` and the like) and ``data_0.npz``. bfloat16 chunks are
stored as uint16 views with the logical dtype in the manifest. A
single-process save writes each tensor whole, as one chunk at offset 0;
a load assembles any layout, so a checkpoint the JAX package wrote under
a mesh (a chunk per shard) loads here, and one written here loads there.
Python numbers are stored at their own width (a float as float64, an int
as int64; the JAX package, without x64, stores them as float32 and
int32), so a restored lr or count is the one that was saved.

Loading fills the given state dict: a tensor leaf IN PLACE (a model's or
an optimizer's live tensors, on whatever device they are), any other
leaf by replacing it in the dict. The save is atomic at the directory
level (staged into ``<path>.tmp``, renamed into place). For step series
with commit markers, retention and auto-resume use
:class:`CheckpointManager`.
"""
from __future__ import annotations

import copy
import json
import os
import shutil
from typing import Dict

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
_DATA_FILE = "data_0.npz"       # process 0's chunks


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
        return t.numpy(), str(t.dtype).split(".")[-1]
    try:
        arr = np.array(v)
    except (TypeError, ValueError):
        return None
    if arr.dtype.kind not in "biuf":
        return None
    if arr.dtype.name == "bfloat16":   # ml_dtypes' numpy bfloat16
        return np.ascontiguousarray(arr).view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _collect(state_dict: Dict):
    """Device->host snapshot of a (possibly nested) state dict: each
    tensor whole, as one chunk. Returns ``(arrays, tensors_meta,
    data_file, objects)``. This is the only part of a save that must
    block the train loop: the async CheckpointManager runs it inline and
    hands the result to a writer thread."""
    arrays, tensors_meta, objects = {}, {}, {}
    for name, v in _flatten(state_dict).items():
        got = _host_array(v)
        if got is None:
            objects[name] = copy.deepcopy(v)
            continue
        arr, logical = got
        key = f"{name}__c0"
        arrays[key] = arr
        shape = tuple(int(s) for s in arr.shape)
        tensors_meta[name] = TensorMetadata(shape, logical, [
            LocalTensorMetadata((0,) * arr.ndim, shape, _DATA_FILE, key)])
    return arrays, tensors_meta, _DATA_FILE, objects


def _write_data(path: str, arrays: Dict, tensors_meta: Dict,
                data_file: str, objects=None):
    """Write the chunks, objects and manifest into ``path`` (which
    already exists), fsyncing every file."""
    np.savez(os.path.join(path, data_file), **arrays)
    _fsync_path(os.path.join(path, data_file))
    if objects:
        obj_file = os.path.join(path, _OBJECTS_FILE)
        with open(obj_file, "w") as f:
            json.dump(objects, f)
        _fsync_path(obj_file)
    _faults.fire(_faults.CKPT_DATA_WRITTEN)
    Metadata(tensors_meta).save(os.path.join(path, _META_FILE))
    _fsync_path(os.path.join(path, _META_FILE))


def _is_ckpt(d):
    return os.path.exists(os.path.join(d, _META_FILE))


def save_state_dict(state_dict: Dict, path: str):
    """Write a (possibly nested) state dict under directory ``path``.

    Atomic at the directory level: everything is staged into
    ``<path>.tmp`` and renamed into place once every file is written and
    fsynced; an old checkpoint at ``path`` stays whole (briefly at
    ``<path>.old``) until the new one has landed."""
    arrays, tensors_meta, data_file, objects = _collect(state_dict)
    path = path.rstrip("/")
    tmp, old = path + ".tmp", path + ".old"
    # the commit REPLACES ``path`` wholesale: refuse to destroy a
    # populated directory that is not a checkpoint
    for d in (path, old):
        if os.path.isdir(d) and not _is_ckpt(d) and os.listdir(d):
            raise ValueError(
                f"refusing to replace {d!r}: it exists, is not empty, and "
                f"holds no {_META_FILE}; the atomic commit would delete "
                f"its contents. Save to a fresh or checkpoint-holding path.")
    # a crash between the two commit renames leaves the only complete
    # checkpoint parked at <path>.old: put it back first
    if not os.path.isdir(path) and os.path.isdir(old) and _is_ckpt(old):
        os.rename(old, path)
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(old, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    _write_data(tmp, arrays, tensors_meta, data_file, objects=objects)
    _faults.fire(_faults.CKPT_BEFORE_COMMIT)
    if os.path.isdir(path):
        os.rename(path, old)
    os.replace(tmp, path)
    _fsync_path(os.path.dirname(os.path.abspath(path)) or ".")
    shutil.rmtree(old, ignore_errors=True)


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


def _assemble(get_npz, meta: TensorMetadata, name="?") -> np.ndarray:
    """The whole tensor from its chunks, as stored (bf16 as uint16);
    raises unless the chunks tile it."""
    shape = list(meta.global_shape)
    total = int(np.prod(shape)) if shape else 1
    out, copied, covered = None, [], 0
    for ch in meta.chunks:
        lo = list(ch.global_offset)
        hi = [a + s for a, s in zip(lo, ch.local_shape)]
        hi = [min(h, d) for h, d in zip(hi, shape)]
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
        dst = tuple(slice(l, h) for l, h in zip(lo, hi))
        src = tuple(slice(0, h - l) for l, h in zip(lo, hi))
        out[dst] = chunk[src]
        copied.append((tuple(lo), tuple(hi)))
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
    replaced (a number keeps its Python type). ``shards`` maps a tensor
    leaf's name to ``(layout, index)``: that leaf receives shard
    ``index`` of the stored global tensor under the
    :class:`~paddle_tpu_torch.distributed.redistribute.Layout` (the
    layout is validated against the stored shape, ``ValueError`` on a
    misfit). A leaf of the shard's shape is filled in place; a leaf of
    the global shape is rebound to the shard (``tensor.data``), so a
    model's parameter then holds its shard only."""
    shards = shards or {}
    if not os.path.isdir(path):
        # a crash between save_state_dict's two commit renames parks the
        # only complete checkpoint at <path>.old: put it back
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
        elif shape != tm.global_shape:
            raise ValueError(
                f"shape mismatch for {name!r}: checkpoint "
                f"{tm.global_shape} vs target {shape}")
        _validate_tensor(name, tm, path)
        full = _to_torch(_assemble(get_npz, tm, name), tm.dtype)
        if sl is not None:
            part = full[sl].to(device=v.device, dtype=v.dtype)
            with torch.no_grad():
                if shape == tuple(part.shape):
                    v.copy_(part)
                else:
                    v.data = part.contiguous()
        elif isinstance(v, torch.Tensor):
            with torch.no_grad():
                v.copy_(full.to(v.device))
        else:
            val = full.numpy() if full.dtype != torch.bfloat16 else full
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
