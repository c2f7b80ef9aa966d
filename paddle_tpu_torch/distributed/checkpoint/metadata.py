"""Checkpoint metadata model (copied from the JAX package's
``distributed/checkpoint/metadata.py``, which holds no arrays).

Reference: python/paddle/distributed/checkpoint/metadata.py:43
(LocalTensorMetadata / LocalTensorIndex / Metadata with flat_mapping).
The TPU build keeps the same two-level model: per-tensor chunk metadata
(global offset + local shape) and a storage map from chunk to file/key.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Tuple


@dataclasses.dataclass
class LocalTensorMetadata:
    """One saved chunk of a (possibly sharded) global tensor."""

    global_offset: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    file: str
    key: str

    def to_json(self):
        return {"global_offset": list(self.global_offset),
                "local_shape": list(self.local_shape),
                "file": self.file, "key": self.key}

    @staticmethod
    def from_json(d):
        return LocalTensorMetadata(
            tuple(d["global_offset"]), tuple(d["local_shape"]),
            d["file"], d["key"])


@dataclasses.dataclass
class TensorMetadata:
    global_shape: Tuple[int, ...]
    dtype: str
    chunks: List[LocalTensorMetadata]

    def to_json(self):
        return {"global_shape": list(self.global_shape),
                "dtype": self.dtype,
                "chunks": [c.to_json() for c in self.chunks]}

    @staticmethod
    def from_json(d):
        return TensorMetadata(
            tuple(d["global_shape"]), d["dtype"],
            [LocalTensorMetadata.from_json(c) for c in d["chunks"]])


@dataclasses.dataclass
class Metadata:
    """Global checkpoint manifest (the reference's flat_mapping analog:
    keys are '/'-joined flat paths of the nested state dict)."""

    tensors: Dict[str, TensorMetadata]
    version: int = 1

    def save(self, path):
        with open(path, "w") as f:
            json.dump({"version": self.version,
                       "tensors": {k: v.to_json()
                                   for k, v in self.tensors.items()}}, f)

    @staticmethod
    def load(path) -> "Metadata":
        with open(path) as f:
            d = json.load(f)
        return Metadata(
            {k: TensorMetadata.from_json(v)
             for k, v in d["tensors"].items()}, d.get("version", 1))
