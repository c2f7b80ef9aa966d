"""Dtype names <-> ``torch.dtype`` (the slice of ``core/dtype.py`` the
serving path needs). bf16 is first-class: the serving cache and the
Llama-3-8B weights run in it."""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["to_torch"]

_BY_NAME = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "fp16": torch.float16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def to_torch(dtype: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _BY_NAME[str(dtype).lower()]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None

