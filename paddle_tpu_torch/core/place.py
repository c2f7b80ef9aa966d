"""Device placement (port of ``paddle_tpu/core/place.py``).

A ``Place`` names a logical device, ``("gpu", i)`` or ``("cpu", 0)``;
:meth:`Place.torch_device` resolves it through
:func:`~paddle_tpu_torch.core.device.resolve_device`. The default place is
the CUDA device: with no GPU, creating a Tensor on the default place
raises until ``set_device("cpu")`` (or ``place=CPUPlace()``) asks for the
CPU. The JAX package falls back to the CPU quietly; the port does not.
The port runs on CUDA: ``TPUPlace`` and ``set_device("tpu")`` raise.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.device import resolve_device

__all__ = [
    "Place", "CUDAPlace", "CPUPlace", "TPUPlace", "CustomPlace",
    "set_device", "get_device", "get_all_devices", "device_count",
    "is_compiled_with_cuda", "is_compiled_with_tpu",
]

_NO_TPU = ("the port runs on CUDA, not on a TPU: use CUDAPlace / "
           "set_device('gpu') (or the CPU)")


class Place:
    """A logical device: ``(device_type, device_id)``, ``device_type``
    ``"gpu"`` (Paddle's name for a CUDA card) or ``"cpu"``."""

    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type == "cuda":
            device_type = "gpu"
        if device_type == "tpu":
            raise ValueError(_NO_TPU)
        self.device_type = device_type
        self.device_id = int(device_id)

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def is_gpu_place(self) -> bool:
        return self.device_type == "gpu"

    def is_cpu_place(self) -> bool:
        return self.device_type == "cpu"

    def torch_device(self) -> torch.device:
        """The ``torch.device``; a GPU place raises without a GPU."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if self.device_type == "gpu":
            return resolve_device(f"cuda:{self.device_id}")
        raise ValueError(f"unsupported place {self!r} (want gpu or cpu)")


def CUDAPlace(device_id: int = 0) -> Place:
    return Place("gpu", device_id)


def CPUPlace() -> Place:
    return Place("cpu", 0)


def TPUPlace(device_id: int = 0) -> Place:
    raise ValueError(_NO_TPU)


def CustomPlace(device_type: str, device_id: int = 0) -> Place:
    return Place(device_type, device_id)


def place_of(device: torch.device) -> Place:
    return CPUPlace() if device.type == "cpu" else CUDAPlace(
        device.index or 0)


_current_place: Place | None = None
_current_device: torch.device | None = None


def _default_place() -> Place:
    """The place set by :func:`set_device`, else the CUDA device (raises
    without a GPU)."""
    if _current_place is None:
        return place_of(resolve_device(None))
    return _current_place


def _default_device() -> torch.device:
    """``torch.device`` of the default place (what creation ops use)."""
    if _current_device is None:
        return resolve_device(None)
    return _current_device


def set_device(device: str) -> Place:
    """``set_device("gpu")``, ``set_device("gpu:1")`` or
    ``set_device("cpu")`` (``"cuda"`` is taken for ``"gpu"``)."""
    global _current_place, _current_device
    dev_type, _, idx = str(device).partition(":")
    if dev_type == "tpu":
        raise ValueError(_NO_TPU)
    place = Place(dev_type, int(idx) if idx else 0)
    tdev = place.torch_device()  # validates
    _current_place, _current_device = place, tdev
    return place


def get_device() -> str:
    p = _default_place()
    return f"{p.device_type}:{p.device_id}"


def get_all_devices():
    if not torch.cuda.is_available():
        return ["cpu"]
    return [f"gpu:{i}" for i in range(torch.cuda.device_count())]


def device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


def is_compiled_with_tpu() -> bool:
    return False
