"""Autograd engine (port of ``paddle_tpu/autograd/engine.py``) on
``torch.autograd``.

The JAX package records a tape of vjp closures and runs its own
in-degree backward; here every op's graph is torch's (the registry's
emitters are torch functions), so :func:`backward` hands the roots to
``torch.autograd.backward`` (or ``torch.autograd.grad`` when
``grad_targets`` restricts what accumulates) and keeps the reference's
contract around it: the root rules and their errors, the ``RuntimeError``
of a second backward without ``retain_graph``, post-backward callbacks,
and grad mode (``no_grad``, ``enable_grad``, ``set_grad_enabled``).

``create_graph`` through a node that cannot do it exists in the port only
as a :class:`~paddle_tpu_torch.autograd.PyLayer`, which raises the
reference's ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List

import torch

__all__ = [
    "backward", "no_grad", "enable_grad", "is_grad_enabled",
    "set_grad_enabled", "register_post_backward_callback",
]

# Callbacks fired once after each backward() (and paddle.grad) finishes —
# the seam where the reference's EagerReducer finalizes gradient buckets.
_post_backward_callbacks: List[Callable] = []

_SECOND_BACKWARD = (
    "Trying to run backward through the graph a second time, but the "
    "saved residuals have already been freed. Pass retain_graph=True to "
    "the first backward() if you need to backward through this graph "
    "again.")


def register_post_backward_callback(fn: Callable):
    """Register fn() to run at the end of every backward(). Returns a
    remover handle."""
    _post_backward_callbacks.append(fn)

    def remove():
        try:
            _post_backward_callbacks.remove(fn)
        except ValueError:
            pass

    return remove


def _fire_callbacks():
    for cb in list(_post_backward_callbacks):
        cb()


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    torch._C._set_grad_enabled(bool(mode))


class _NoGrad(contextlib.ContextDecorator):
    def __init__(self, mode: bool):
        self._mode = mode

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch._C._set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch._C._set_grad_enabled(self._prev)
        return False


def no_grad():
    """Context manager / decorator disabling recording (paddle.no_grad)."""
    return _NoGrad(False)


def enable_grad():
    return _NoGrad(True)


@contextlib.contextmanager
def translate_errors():
    """torch's error for a graph already freed, as the reference's."""
    try:
        yield
    except RuntimeError as e:
        if "backward through the graph a second time" in str(e):
            raise RuntimeError(_SECOND_BACKWARD) from None
        raise


def _roots(tensors, grad_tensors):
    """(root datas, seed grads) of the tensors that take part, by the
    reference's rules: a non-scalar root needs a grad."""
    from paddle_tpu_torch.core.tensor import Tensor

    if isinstance(tensors, Tensor):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif isinstance(grad_tensors, Tensor):
        grad_tensors = [grad_tensors]
    datas, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        if t.stop_gradient or not t._data.requires_grad:
            continue
        d = t._data
        if g is None:
            if d.numel() != 1:
                raise RuntimeError(
                    "grad must be provided for non-scalar backward root "
                    f"(shape {tuple(d.shape)})")
            g = torch.ones_like(d)
        elif isinstance(g, Tensor):
            g = g._data
        else:
            g = torch.as_tensor(g, dtype=d.dtype, device=d.device)
        datas.append(d)
        seeds.append(g)
    return datas, seeds


def backward(tensors, grad_tensors=None, retain_graph=False,
             create_graph=False, grad_targets=None):
    """Reverse accumulation from ``tensors`` into the ``.grad`` of every
    leaf that takes part, or, with ``grad_targets``, into those tensors
    only (leaf or interior; an interior target's ``.grad`` is set on its
    wrapper)."""
    datas, seeds = _roots(tensors, grad_tensors)
    if datas:
        with translate_errors():
            if grad_targets is None:
                torch.autograd.backward(datas, seeds,
                                        retain_graph=retain_graph,
                                        create_graph=create_graph)
            else:
                targets = [t for t in grad_targets
                           if t is not None and t._data.requires_grad]
                grads = torch.autograd.grad(
                    datas, [t._data for t in targets], seeds,
                    retain_graph=retain_graph, create_graph=create_graph,
                    allow_unused=True)
                for t, g in zip(targets, grads):
                    if g is not None:
                        prev = t.grad
                        t.grad = g if prev is None else prev._data + g
    _fire_callbacks()
