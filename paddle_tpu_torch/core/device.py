"""Device resolution (the port's counterpart of ``core/place.py``).

One rule for every entry point: run on the CUDA device unless the caller
asks for the CPU. With no GPU and no explicit ``device="cpu"`` the
entry point raises; it never carries on quietly on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); ``"cpu"`` -> the CPU;
    any CUDA spelling -> that CUDA device (raises without a GPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               f"device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (want 'cuda' or "
                         f"'cpu')")
    return dev
