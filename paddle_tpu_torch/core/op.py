"""Port functions that count as one operator for a torch function mode.

The JAX package casts for ``amp.auto_cast`` at its op registry, where an
op such as ``rms_norm`` is one call; so does the port's registry for a
Tensor API op. Code on raw torch tensors (the Llama modules) is cast by
a ``torch.overrides.TorchFunctionMode``, which sees torch functions.
:func:`op` makes a port function one such call: under
an active mode the mode sees the function itself (by its ``__name__``,
which is the JAX op's name), and inside it the mode is off, as a mode's
handler runs. With no mode active the check costs one C call."""
from __future__ import annotations

import functools

import torch
from torch.overrides import handle_torch_function, has_torch_function

__all__ = ["op"]


def op(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        tensors = tuple(a for a in args if isinstance(a, torch.Tensor))
        if has_torch_function(tensors):
            return handle_torch_function(wrapper, tensors, *args, **kwargs)
        return fn(*args, **kwargs)
    return wrapper
