"""Functional and higher-order autodiff (port of
``paddle_tpu/autograd/functional.py``) on ``torch.autograd``.

:func:`grad` never touches ``.grad``; interior tensors may be inputs;
``create_graph=True`` gives gradients that take a further :func:`grad`
(the double-grad contract). :func:`vjp`, :func:`jvp`, :func:`jacobian`
and :func:`hessian` run the Tensor function on fresh leaves, through
``torch.autograd.functional`` (jvp by the double-vjp trick).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.autograd import engine
from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["grad", "jacobian", "hessian", "vjp", "jvp", "Jacobian",
           "Hessian"]


def grad(outputs, inputs, grad_outputs=None, retain_graph=False,
         create_graph=False, allow_unused=False, no_grad_vars=None):
    """paddle.grad: grads of ``outputs`` wrt ``inputs`` (leaf or interior)
    without touching any ``.grad``."""
    outputs = [outputs] if isinstance(outputs, Tensor) else list(outputs)
    inputs = [inputs] if isinstance(inputs, Tensor) else list(inputs)
    if grad_outputs is not None and not isinstance(grad_outputs,
                                                   (list, tuple)):
        grad_outputs = [grad_outputs]
    datas, seeds = engine._roots(outputs, grad_outputs)
    live = [i for i, t in enumerate(inputs) if t._data.requires_grad]
    results = [None] * len(inputs)
    if datas and live:
        with engine.translate_errors():
            gs = torch.autograd.grad(
                datas, [inputs[i]._data for i in live], seeds,
                retain_graph=retain_graph or create_graph,
                create_graph=create_graph, allow_unused=True)
        for i, g in zip(live, gs):
            if g is not None:
                results[i] = Tensor._from_data(
                    g, stop_gradient=g.grad_fn is None)
    engine._fire_callbacks()
    for i, r in enumerate(results):
        if r is None and not allow_unused:
            raise ValueError(
                f"The {i}-th input does not appear in the backward "
                "graph of the given outputs. Pass allow_unused=True "
                "to get None for unreachable inputs (reference "
                "contract: python/paddle/base/dygraph/base.py grad)")
    return results


def _functionalize(func):
    """A Tensor -> Tensor function as a torch-tensor function."""

    def fn(*datas):
        ins = [Tensor._from_data(d, stop_gradient=not d.requires_grad)
               for d in datas]
        out = func(*ins) if len(ins) > 1 else func(ins[0])
        if isinstance(out, (tuple, list)):
            return tuple(o._data for o in out)
        return out._data

    return fn


def _unpack(xs):
    single = isinstance(xs, Tensor)
    datas = [xs._data] if single else [x._data for x in xs]
    return single, tuple(d.detach() for d in datas)


def _wrap(out):
    if isinstance(out, (tuple, list)):
        return tuple(Tensor._from_data(o.detach()) for o in out)
    return Tensor._from_data(out.detach())


def vjp(func, xs, v=None):
    """(outputs, vjp result) — reference: incubate/autograd/functional.py."""
    single, datas = _unpack(xs)
    ins = tuple(d.requires_grad_(True) for d in (x.clone() for x in datas))
    with torch.enable_grad():
        out = _functionalize(func)(*ins)
    outs = out if isinstance(out, tuple) else (out,)
    if v is None:
        vs = tuple(torch.ones_like(o) for o in outs)
    else:
        vs = (v._data,) if isinstance(v, Tensor) else tuple(
            t._data for t in v)
    gs = torch.autograd.grad(outs, ins, vs, allow_unused=True)
    grads = [Tensor._from_data(torch.zeros_like(d) if g is None else g)
             for d, g in zip(datas, gs)]
    return _wrap(out), grads[0] if single else grads


def jvp(func, xs, v=None):
    single, datas = _unpack(xs)
    if v is None:
        tangents = tuple(torch.ones_like(d) for d in datas)
    else:
        vs = [v] if isinstance(v, Tensor) else list(v)
        tangents = tuple(t._data for t in vs)
    out, tang = torch.autograd.functional.jvp(
        _functionalize(func), datas, tangents)
    return _wrap(out), _wrap(tang)


def jacobian(func, xs, batch_axis=None):
    """Dense Jacobian (lazy in the reference, eager here):
    output shape + input shape."""
    single, datas = _unpack(xs)
    jac = torch.autograd.functional.jacobian(_functionalize(func), datas)
    if single:
        jac = jac[0] if isinstance(jac, tuple) else jac
        return _wrap(jac)
    return [_wrap(j) for j in jac]


def hessian(func, xs, batch_axis=None):
    single, datas = _unpack(xs)
    hes = torch.autograd.functional.hessian(_functionalize(func), datas)
    if single:
        h = hes[0][0] if isinstance(hes, tuple) else hes
        return _wrap(h)
    return [[_wrap(c) for c in row] for row in hes]


class Jacobian:
    def __init__(self, func, xs, is_batched=False):
        self._value = jacobian(func, xs)

    def __getitem__(self, idx):
        return self._value[idx]

    @property
    def value(self):
        return self._value


class Hessian(Jacobian):
    def __init__(self, func, xs, is_batched=False):
        self._value = hessian(func, xs)
