"""Data types (port of ``paddle_tpu/core/dtype.py``).

``DType`` is the framework dtype: a hashable name over a ``torch.dtype``
(and the numpy dtype where numpy has one; bfloat16 has none without
ml_dtypes, so a bf16 numpy array is known by its dtype's name).
:func:`to_torch` takes a ``DType``, a name (``"float32"``, ``"bf16"``,
``"fp32"``, ...), a numpy dtype, a Python type or a ``torch.dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DType", "dtype",
    "bool_", "uint8", "int8", "int16", "int32", "int64",
    "float16", "bfloat16", "float32", "float64",
    "complex64", "complex128",
    "convert_dtype", "get_default_dtype", "set_default_dtype",
    "is_floating_point", "is_integer", "is_complex", "promote_types",
    "to_torch",
]


class DType:
    """A framework dtype: ``name``, ``torch_dtype`` and ``np_dtype``
    (None for bfloat16)."""

    __slots__ = ("name", "np_dtype", "torch_dtype")

    _registry: dict = {}

    def __init__(self, name: str, np_dtype, torch_dtype):
        self.name = name
        self.np_dtype = None if np_dtype is None else np.dtype(np_dtype)
        self.torch_dtype = torch_dtype
        DType._registry[name] = self

    def __repr__(self):
        return f"paddle_tpu_torch.{self.name}"

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.name == other.name
        try:
            return convert_dtype(other) is self
        except (TypeError, ValueError):
            return NotImplemented

    @property
    def is_floating(self) -> bool:
        return self.name in ("float16", "bfloat16", "float32", "float64")

    @property
    def is_integer(self) -> bool:
        return self.name in ("uint8", "int8", "int16", "int32", "int64")

    @property
    def is_complex(self) -> bool:
        return self.name in ("complex64", "complex128")

    @property
    def itemsize(self) -> int:
        return self.torch_dtype.itemsize


bool_ = DType("bool", np.bool_, torch.bool)
uint8 = DType("uint8", np.uint8, torch.uint8)
int8 = DType("int8", np.int8, torch.int8)
int16 = DType("int16", np.int16, torch.int16)
int32 = DType("int32", np.int32, torch.int32)
int64 = DType("int64", np.int64, torch.int64)
float16 = DType("float16", np.float16, torch.float16)
bfloat16 = DType("bfloat16", None, torch.bfloat16)
float32 = DType("float32", np.float32, torch.float32)
float64 = DType("float64", np.float64, torch.float64)
complex64 = DType("complex64", np.complex64, torch.complex64)
complex128 = DType("complex128", np.complex128, torch.complex128)

dtype = DType

_STR_ALIASES = {
    "bool": bool_, "bool_": bool_,
    "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64,
    "float16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "float": float32,
    "float64": float64, "double": float64,
    "complex64": complex64, "complex128": complex128,
}
_BY_TORCH = {d.torch_dtype: d for d in DType._registry.values()}
# spellings to_torch also takes (the port's configs use them)
_TORCH_ONLY = {"fp32": torch.float32, "fp16": torch.float16}


def convert_dtype(d) -> DType:
    """Normalize a str / numpy dtype / torch dtype / Python type / DType
    into a DType."""
    if isinstance(d, DType):
        return d
    if isinstance(d, torch.dtype):
        if d in _BY_TORCH:
            return _BY_TORCH[d]
        raise ValueError(f"unsupported dtype: {d!r}")
    if isinstance(d, str):
        if d in _STR_ALIASES:
            return _STR_ALIASES[d]
        raise ValueError(f"unknown dtype string: {d!r}")
    if d is bool:
        return bool_
    if d is int:
        return int64
    if d is float:
        return float32
    try:
        name = np.dtype(d).name
    except TypeError:
        name = getattr(d, "name", None) or str(d)
    if name in _STR_ALIASES:
        return _STR_ALIASES[name]
    raise ValueError(f"unsupported dtype: {d!r}")


def to_torch(d) -> torch.dtype:
    """Anything :func:`convert_dtype` takes (and ``"fp32"``/``"fp16"``) as
    a ``torch.dtype``."""
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str) and d.lower() in _TORCH_ONLY:
        return _TORCH_ONLY[d.lower()]
    if isinstance(d, str):
        d = d.lower()
    return convert_dtype(d).torch_dtype


_default_dtype = float32


def set_default_dtype(d):
    global _default_dtype
    d = convert_dtype(d)
    if not d.is_floating:
        raise TypeError("default dtype must be floating point")
    _default_dtype = d


def get_default_dtype() -> DType:
    return _default_dtype


def is_floating_point(d) -> bool:
    return convert_dtype(d).is_floating


def is_integer(d) -> bool:
    return convert_dtype(d).is_integer


def is_complex(d) -> bool:
    return convert_dtype(d).is_complex


def promote_types(a, b) -> DType:
    """Binary type promotion, by torch's table (which agrees with the JAX
    package's for the pairs its tests hold)."""
    return convert_dtype(torch.promote_types(to_torch(a), to_torch(b)))
