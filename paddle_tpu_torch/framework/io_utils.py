"""``paddle.save`` / ``paddle.load`` (port of
``paddle_tpu/framework/io_utils.py``).

The file is the JAX package's: a pickle of the object with every Tensor
(and every raw torch tensor, such as an optimizer's slots) replaced by a
numpy array, a bf16 Tensor by ``{"__bf16__": True, "data":
<its bits as a uint16 array>}``. Only numpy arrays, dicts, lists, tuples
and Python scalars go into it, so a file written by either package loads
in the other. A loaded array becomes a Tensor on the default place (the
card; the CPU after ``set_device("cpu")``).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from paddle_tpu_torch.core.place import _default_device
from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["save", "load"]

_BF16_TAG = "__bf16__"


def _to_picklable(obj):
    if isinstance(obj, (Tensor, torch.Tensor)):
        d = (obj._data if isinstance(obj, Tensor) else obj).detach()
        if d.dtype == torch.bfloat16:
            bits = d.cpu().contiguous().view(torch.int16).numpy()
            return {_BF16_TAG: True, "data": bits.view(np.uint16)}
        return d.cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_picklable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_picklable(v) for v in obj)
    return obj


def _from_picklable(obj):
    if isinstance(obj, dict):
        if obj.get(_BF16_TAG):
            arr = obj["data"]
            if arr.dtype == np.uint16:
                t = torch.from_numpy(np.ascontiguousarray(arr).view(
                    np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.asarray(arr, np.float32)).to(
                    torch.bfloat16)
            return Tensor._from_data(t.to(_default_device()))
        return {k: _from_picklable(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return Tensor(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_picklable(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_picklable(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_picklable(obj)
