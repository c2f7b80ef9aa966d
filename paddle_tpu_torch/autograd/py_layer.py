"""PyLayer: user-defined forward and backward (port of
``paddle_tpu/autograd/py_layer.py``) as a ``torch.autograd.Function``.

The user's forward runs without recording and sees Tensors; the user's
backward runs without recording too, so it cannot be differentiated
again: ``create_graph=True`` through a PyLayer raises the reference's
``NotImplementedError``.
"""
from __future__ import annotations

from typing import List

import torch

from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext", "once_differentiable"]


class PyLayerContext:
    def __init__(self):
        self._saved: List[Tensor] = []

    def save_for_backward(self, *tensors):
        self._saved = list(tensors)

    def saved_tensor(self):
        return list(self._saved)

    def mark_not_inplace(self, *a):  # API parity no-ops
        pass

    def mark_non_differentiable(self, *a):
        pass

    def set_materialize_grads(self, v):
        pass


class _Function(torch.autograd.Function):
    """Carries one ``PyLayer.apply``: ``run`` holds the user's layer, its
    context and arguments; the tensor inputs are the differentiable
    Tensors' data, in forward-argument order."""

    @staticmethod
    def forward(ctx, run, *datas):
        ctx.run = run
        return run.forward()

    @staticmethod
    def backward(ctx, *grads):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                f"create_graph=True through node {ctx.run.cls.__name__!r} "
                "is not supported: its backward is an opaque closure "
                "(PyLayer or custom vjp) with no differentiable "
                "re-derivation. Express the computation with "
                "differentiable paddle ops, or use create_graph=False.")
        return (None,) + ctx.run.backward(grads)


class _Run:
    def __init__(self, cls, args, kwargs, n_diff):
        self.cls = cls
        self.args = args
        self.kwargs = kwargs
        self.pyctx = PyLayerContext()
        self.n_diff = n_diff
        self.structure = None

    def forward(self):
        outputs = self.cls.forward(self.pyctx, *self.args, **self.kwargs)
        multi = isinstance(outputs, (tuple, list))
        out_list = list(outputs) if multi else [outputs]
        self.structure = (multi, out_list)
        return tuple(o._data for o in out_list if isinstance(o, Tensor))

    def backward(self, grads):
        with torch.no_grad():
            in_grads = self.cls.backward(
                self.pyctx, *[Tensor._from_data(g) for g in grads])
        if not isinstance(in_grads, (tuple, list)):
            in_grads = (in_grads,)
        out = [g._data if isinstance(g, Tensor) else g for g in in_grads]
        out = (out + [None] * self.n_diff)[:self.n_diff]
        return tuple(out)


class PyLayer:
    """Subclass with ``forward(ctx, *args)`` and ``backward(ctx, *grads)``
    staticmethods; call via ``MyLayer.apply(*args)``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        diff_inputs = [
            a for a in list(args) + list(kwargs.values())
            if isinstance(a, Tensor) and not a.stop_gradient
            and a._data.requires_grad]
        run = _Run(cls, args, kwargs, len(diff_inputs))
        if not (torch.is_grad_enabled() and diff_inputs):
            with torch.no_grad():
                run.forward()
            multi, out_list = run.structure
            return tuple(out_list) if multi else out_list[0]
        datas = _Function.apply(run, *[t._data for t in diff_inputs])
        multi, out_list = run.structure
        it = iter(datas)
        for o in out_list:
            if isinstance(o, Tensor):
                o._data = next(it)
                o._stop_gradient = False
        return tuple(out_list) if multi else out_list[0]

    # paddle naming parity
    once_differentiable = staticmethod(lambda f: f)


def once_differentiable(f):
    """API parity: a PyLayer's backward is already differentiable once."""
    return f
