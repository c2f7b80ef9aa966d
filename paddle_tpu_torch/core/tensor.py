"""The eager Tensor (port of ``paddle_tpu/core/tensor.py``).

A ``Tensor`` wraps a ``torch.Tensor`` in ``_data``; it does not subclass
it. Op methods (``t.matmul``, ``t.sum``, the operators) are bound onto the
class by the op registry (``paddle_tpu_torch/ops/registry.py``) at import.

Autograd rides on torch's engine:

* ``stop_gradient=False`` on a floating (or complex) tensor is
  ``_data.requires_grad``; an integer tensor may carry the flag and takes
  no part (the JAX package's ``_is_diff_dtype`` rule), so the flag is kept
  apart from ``requires_grad``.
* ``.grad`` is ``_data.grad``, wrapped; it can be set, and set to None.
* ``stop_gradient=True`` on an interior tensor cuts the graph there.

Input dtypes: a float64 array (no dtype given) becomes float32, as in the
JAX package; int64 stays int64 (the JAX package narrows it to int32, and
refuses values past int32's range). A bf16 numpy array (ml_dtypes, as the
JAX package's arrays give it) is known by its dtype's name.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.core import dtype as _dtype_mod
from paddle_tpu_torch.core.dtype import convert_dtype, to_torch
from paddle_tpu_torch.core.place import (Place, _default_device,
                                         place_of)

__all__ = ["Tensor", "to_tensor", "is_tensor"]

_DIFF_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64,
                torch.complex64, torch.complex128)


def _global(d: torch.Tensor) -> torch.Tensor:
    """A DistTensor's global value (its DTensor gathered); any other
    tensor as it is."""
    return d.full_tensor() if type(d).__name__ == "DTensor" else d


class Tensor:
    __slots__ = ("_data", "_stop_gradient", "_grad_wrap", "name",
                 "persistable", "_placements", "_process_mesh",
                 "__weakref__", "__dict__")

    _next_id = 0

    def __init__(self, data=None, dtype=None, place=None, stop_gradient=True,
                 name=None):
        if data is not None:
            dev = None
            if place is not None:
                dev = (place.torch_device() if isinstance(place, Place)
                       else _parse_place(place).torch_device())
            if isinstance(data, Tensor):
                data = data._data
            if isinstance(data, torch.Tensor):
                # a copy, as paddle.to_tensor makes (the wrapper's data is
                # never written in place, but the source may be)
                data = data.detach().to(
                    device=dev if dev is not None else data.device,
                    dtype=None if dtype is None else to_torch(dtype),
                    copy=True)
            else:
                data = _np_to_torch(data, dtype,
                                    dev if dev is not None
                                    else _default_device())
        self._data = data
        self._stop_gradient = True
        self._grad_wrap = None
        self.persistable = False
        self._placements = None
        self._process_mesh = None
        if name is None:
            name = f"tensor_{Tensor._next_id}"
            Tensor._next_id += 1
        self.name = name
        if not stop_gradient:
            self.stop_gradient = False

    @classmethod
    def _from_data(cls, data, stop_gradient=True, name=None):
        """Wrap a torch tensor as it is (an op output: its autograd state
        is torch's)."""
        t = cls.__new__(cls)
        t._data = data
        t._stop_gradient = stop_gradient
        t._grad_wrap = None
        t.persistable = False
        t._placements = None
        t._process_mesh = None
        t.name = name or f"tensor_{Tensor._next_id}"
        Tensor._next_id += 1
        return t

    # -- autograd state ------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, value):
        value = bool(value)
        d = self._data
        if value:
            if d is not None and d.requires_grad:
                # cut the graph here (the JAX engine's _producer stops)
                self._data = d.detach()
        elif d is not None and d.dtype in _DIFF_DTYPES and \
                not d.requires_grad:
            # a new leaf over the same storage: another Tensor wrapping
            # the same torch tensor keeps its own flag
            self._data = d.detach().requires_grad_(True)
        self._stop_gradient = value

    @property
    def grad(self) -> Optional["Tensor"]:
        d = self._data
        # an interior tensor has a .grad only as a backward(grad_targets=)
        # target; torch keeps none for it
        g = d.grad if d.is_leaf else self.__dict__.get("_interior_grad")
        if g is None:
            self._grad_wrap = None
            return None
        w = self._grad_wrap
        if w is None or w._data is not g:
            w = Tensor._from_data(g, stop_gradient=g.grad_fn is None)
            self._grad_wrap = w
        return w

    @grad.setter
    def grad(self, value):
        self._grad_wrap = None
        g = None if value is None else (
            value._data if isinstance(value, Tensor) else value)
        if self._data.is_leaf:
            self._data.grad = g
        else:
            self.__dict__["_interior_grad"] = g

    @property
    def is_leaf(self):
        return self._data.grad_fn is None

    # -- metadata ------------------------------------------------------
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def dim(self):
        return self._data.dim()

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def dtype(self):
        return convert_dtype(self._data.dtype)

    @property
    def place(self):
        return place_of(self._data.device)

    @property
    def T(self):
        from paddle_tpu_torch.ops.registry import API
        return API["transpose"](self, list(range(self.ndim))[::-1])

    @property
    def mT(self):
        from paddle_tpu_torch.ops.registry import API
        perm = list(range(self.ndim))
        perm[-2], perm[-1] = perm[-1], perm[-2]
        return API["transpose"](self, perm)

    # -- conversion ----------------------------------------------------
    def _moved(self, device):
        return Tensor._from_data(self._data.to(device),
                                 stop_gradient=self._stop_gradient)

    def cuda(self, device_id=None, blocking=True):
        index = torch.cuda.current_device() if device_id is None \
            else device_id
        return self._moved(Place("gpu", index).torch_device())

    def cpu(self):
        return self._moved(torch.device("cpu"))

    def pin_memory(self):
        return self

    def numpy(self):
        d = _global(self._data.detach()).resolve_conj()
        if d.dtype == torch.bfloat16:
            d = d.float()
        return d.cpu().numpy()

    def item(self):
        return _global(self._data.detach()).item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def astype(self, dt):
        from paddle_tpu_torch.ops.registry import API
        return API["cast"](self, dt)

    cast = astype

    def to(self, *args, **kwargs):
        """to(dtype) / to(place) / to('gpu:0')."""
        out = self
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, (str, _dtype_mod.DType, torch.dtype)) and \
                    _is_dtype_like(a):
                out = out.astype(a)
            elif isinstance(a, (str, Place, torch.device)):
                place = a if isinstance(a, Place) else _parse_place(a)
                out = out._moved(place.torch_device())
        return out

    def detach(self):
        return Tensor._from_data(self._data.detach(), stop_gradient=True)

    def clone(self):
        from paddle_tpu_torch.ops.registry import API
        return API["assign"](self)

    # -- autograd ------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph=False):
        from paddle_tpu_torch.autograd import engine
        engine.backward([self], [grad_tensor], retain_graph=retain_graph)

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """``hook(grad Tensor) -> Tensor | None``; fires when this tensor's
        gradient is computed (a leaf's before it accumulates)."""
        if not self._data.requires_grad:
            raise RuntimeError("register_hook on a tensor that does not "
                               "take part in autograd (stop_gradient)")

        def raw(g):
            out = hook(Tensor._from_data(g, stop_gradient=g.grad_fn is None))
            return None if out is None else out._data

        self._data.register_hook(raw)
        return hook

    # -- in-place helpers (rebind, as the JAX package does) -------------
    def _rebind(self, data):
        data = data.detach()
        if not self._stop_gradient and data.dtype in _DIFF_DTYPES:
            data.requires_grad_(True)
        self._data = data
        return self

    def set_value(self, value):
        """Rebind to a copy of ``value`` in this tensor's device, dtype and
        shape (a copy: the port's optimizers update data in place, so the
        source must not share it)."""
        d = self._data
        if isinstance(value, Tensor):
            value = value._data
        if isinstance(value, torch.Tensor):
            value = value.detach().to(d.device, d.dtype, copy=True)
        else:
            value = _np_to_torch(value, None, d.device).to(d.dtype)
        return self._rebind(value.reshape(d.shape))

    def copy_(self, other, *_):
        return self.set_value(other)

    def fill_(self, value):
        return self._rebind(torch.full_like(self._data, value))

    def zero_(self):
        return self._rebind(torch.zeros_like(self._data))

    # -- dist metadata -------------------------------------------------
    @property
    def process_mesh(self):
        return self._process_mesh

    @property
    def placements(self):
        return self._placements

    def is_dist(self):
        return self._process_mesh is not None

    # -- python protocol -------------------------------------------------
    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __repr__(self):
        grad_str = "" if self.stop_gradient else ", stop_gradient=False"
        return (
            f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
            f"place={self.place}{grad_str},\n"
            f"       {np.array2string(self.numpy(), threshold=40, precision=6)})"
        )

    def __bool__(self):
        return bool(self._data.detach())

    def _scalar_data(self):
        """The data of a 0-d tensor; any other raises the JAX package's
        ``TypeError`` (torch would take any one-element tensor)."""
        d = self._data
        if d.dim() != 0:
            raise TypeError("Only scalar arrays can be converted to Python "
                            f"scalars; got arr.ndim={d.dim()}")
        return d.detach()

    def __int__(self):
        return int(self._scalar_data())

    __index__ = __int__

    def __float__(self):
        return float(self._scalar_data())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __hash__(self):
        return id(self)

    def __deepcopy__(self, memo):
        new = Tensor._from_data(self._data.detach().clone(),
                                stop_gradient=True)
        new.__class__ = type(self)
        new.stop_gradient = self._stop_gradient
        new.persistable = self.persistable
        memo[id(self)] = new
        return new

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return repr(self)

    # indexing / arithmetic dunders are bound by ops.registry at import.


def _is_dtype_like(a) -> bool:
    try:
        convert_dtype(a)
        return True
    except (ValueError, TypeError):
        return False


def _parse_place(s) -> Place:
    if isinstance(s, torch.device):
        return place_of(s)
    t, _, i = str(s).partition(":")
    return Place(t, int(i) if i else 0)


def _np_to_torch(data, dtype, device) -> torch.Tensor:
    """numpy / Python data as a torch tensor on ``device``. With no dtype:
    float64 -> float32 and complex128 -> complex64 (the JAX package's
    rule), int64 kept (the port's), bf16 by its dtype's name."""
    arr = np.asarray(data)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        if dtype is None:
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            elif arr.dtype == np.complex128:
                arr = arr.astype(np.complex64)
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=None if dtype is None
                else to_torch(dtype), copy=True)


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """Parity with ``paddle.to_tensor``; lands on ``place`` or the default
    place (the card; see :mod:`paddle_tpu_torch.core.place`)."""
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)


def is_tensor(x) -> bool:
    return isinstance(x, Tensor)
