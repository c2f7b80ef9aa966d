"""Yaml-driven operator registry (port of ``paddle_tpu/ops/registry.py``).

``ops.yaml`` declares the op surface; each op's *emitter* is a torch
function on raw tensors (the port's counterpart of a jnp emitter). The
registry wraps emitters with

  * eager dispatch (Tensor in / Tensor out),
  * autograd: none of its own. Gradients come from torch's autograd
    through the emitter; an op declared ``diff: false`` runs under
    ``no_grad`` when an input takes part in autograd,
  * Tensor method and operator binding, with the reflected operators,
  * in-place variants (``add_`` ...) that compute out of place and rebind
    the Tensor's data, as the JAX package does, so torch's graph keeps
    the value from before the op (torch's own in-place ops would raise
    on a saved tensor that was modified, where the JAX package does not),
  * the ``FLAGS_check_nan_inf`` check,
  * two seams: ``_AMP_HOOK`` (``amp.auto_cast`` casts the inputs here, and
    the emitter then runs with torch function modes off, so nothing is
    cast twice) and ``_PROFILER_HOOK`` (a recording window's
    ``op::<name>`` scope).
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Sequence

import torch

from paddle_tpu_torch.core import flags
from paddle_tpu_torch.core.tensor import _DIFF_DTYPES, Tensor

__all__ = ["OpDef", "register_emitter", "build_registry", "get_op", "OPS",
           "API", "rebind_inplace", "set_amp_hook", "set_profiler_hook"]


class OpDef:
    __slots__ = (
        "name", "emitter", "tensor_args", "list_args", "methods", "magic",
        "inplace", "diff", "sig",
    )

    def __init__(self, name, emitter, tensor_args, list_args, methods, magic,
                 inplace, diff):
        self.name = name
        self.emitter = emitter
        self.tensor_args = tuple(tensor_args)
        self.list_args = frozenset(list_args)
        self.methods = methods or []
        self.magic = magic or []
        self.inplace = inplace
        self.diff = diff
        self.sig = inspect.signature(emitter)


# emitter functions registered by the emitter modules, keyed by op name
_EMITTERS: Dict[str, Callable] = {}
# built OpDefs
OPS: Dict[str, OpDef] = {}
# public functional API (op name -> wrapped callable)
API: Dict[str, Callable] = {}


def register_emitter(name=None):
    """Decorator marking a torch function as the emitter for op ``name``."""

    def deco(fn):
        _EMITTERS[name or fn.__name__] = fn
        return fn

    if callable(name):
        fn, name = name, name.__name__
        _EMITTERS[name] = fn
        return fn
    return deco


def _check_nan_inf(name, outs):
    """FLAGS_check_nan_inf: every floating op output is checked."""
    for o in outs:
        if isinstance(o, torch.Tensor) and (
                o.is_floating_point() or o.is_complex()) and \
                not bool(torch.isfinite(o).all()):
            raise FloatingPointError(f"op {name!r} produced nan/inf")


# AMP hook: set by paddle_tpu_torch.amp at import.
# Signature: cast_for_op(op_name, datas_list) -> datas_list or None (None:
# no auto_cast is active, run as is). Called once per op with the data of
# every tensor argument.
_AMP_HOOK = None


def set_amp_hook(fn):
    global _AMP_HOOK
    _AMP_HOOK = fn


# Profiler hook: set by paddle_tpu_torch.profiler while a window records.
# fn(scope_name) -> context manager.
_PROFILER_HOOK = None


def set_profiler_hook(fn):
    global _PROFILER_HOOK
    _PROFILER_HOOK = fn


def _unwrap(v):
    if isinstance(v, Tensor):
        return v._data
    if isinstance(v, (list, tuple)):
        return type(v)(x._data if isinstance(x, Tensor) else x for x in v)
    return v


# (run, tag) of the semi-auto API once a DistTensor exists
# (``distributed/api.py``): ``run(compute, arguments)`` computes an op
# whose operands hold a DTensor, ``tag(outputs)`` gives its output
# Tensors their mesh and placements
_DIST_HOOK = None


def _any_dtensor(values) -> bool:
    for v in values:
        if isinstance(v, (list, tuple)):
            if _any_dtensor(v):
                return True
        elif type(v).__name__ == "DTensor":
            return True
    return False


def make_api(opdef: OpDef) -> Callable:
    """Build the eager wrapper for one op."""

    emitter = opdef.emitter
    name = opdef.name
    targs = opdef.tensor_args
    tset = frozenset(targs)
    list_args = opdef.list_args
    diff = opdef.diff
    params = [p.name for p in opdef.sig.parameters.values()
              if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    pset = frozenset(p.name for p in opdef.sig.parameters.values())
    n_params = len(params)
    scope = "op::" + name

    def run_emitter(call_args):
        hook = _AMP_HOOK
        if hook is None:
            return emitter(**call_args)
        # one cast site per op: every tensor argument through the hook
        flat, where = [], []
        for an in targs:
            v = call_args.get(an)
            if an in list_args and v:
                where.append((an, len(flat), len(v)))
                flat.extend(v)
            elif isinstance(v, torch.Tensor):
                where.append((an, len(flat), None))
                flat.append(v)
        cast = hook(name, flat) if flat else None
        if cast is None:
            return emitter(**call_args)
        for an, i, n in where:
            call_args[an] = cast[i] if n is None else list(cast[i:i + n])
        if torch._C._is_torch_function_mode_enabled():
            with torch._C.DisableTorchFunction():
                return emitter(**call_args)
        return emitter(**call_args)

    def api(*args, **kwargs):
        hook = _PROFILER_HOOK  # snapshot: stop() may clear it concurrently
        if hook is not None:
            with hook(scope):
                return _api_impl(args, kwargs)
        return _api_impl(args, kwargs)

    def _api_impl(args, kwargs):
        if len(args) > n_params:
            raise TypeError(f"{name}() takes {n_params} positional "
                            f"arguments but {len(args)} were given")
        arguments = dict(zip(params, args))
        for k, v in kwargs.items():
            if k in arguments or k not in pset:
                raise TypeError(f"{name}() got an unexpected or repeated "
                                f"argument {k!r}")
            arguments[k] = v

        any_grad = False
        for k, v in arguments.items():
            if isinstance(v, Tensor):
                d = v._data
                if k in tset:
                    any_grad = any_grad or d.requires_grad
                elif d.requires_grad:
                    # a Tensor passed as an attribute is a constant, as in
                    # the JAX package (its vjp sees only the tensor args)
                    d = d.detach()
                arguments[k] = d
            elif isinstance(v, (list, tuple)) and k in list_args:
                datas = []
                for item in v:
                    if isinstance(item, Tensor):
                        d = item._data
                        any_grad = any_grad or d.requires_grad
                        datas.append(d)
                    else:
                        datas.append(item)
                arguments[k] = datas
            elif isinstance(v, (list, tuple)):
                arguments[k] = _unwrap(v)

        grad_on = any_grad and torch.is_grad_enabled()
        want_grad = diff and grad_on

        def compute():
            if grad_on and not diff:
                with torch.no_grad():
                    return run_emitter(arguments)
            return run_emitter(arguments)

        dist = _DIST_HOOK if _DIST_HOOK is not None and \
            _any_dtensor(arguments.values()) else None
        out = compute() if dist is None else dist[0](compute, arguments)
        multi = isinstance(out, (tuple, list))
        outs = list(out) if multi else [out]
        if flags.flag("check_nan_inf"):
            _check_nan_inf(name, outs)
        sg = not want_grad
        out_tensors = [Tensor._from_data(o, stop_gradient=sg) for o in outs]
        if dist is not None:
            dist[1](out_tensors)
        return tuple(out_tensors) if multi else out_tensors[0]

    api.__name__ = name
    api.__qualname__ = name
    api.__doc__ = emitter.__doc__
    api._opdef = opdef
    return api


def rebind_inplace(self, out):
    """Rebind ``self`` to the result of an out-of-place op. The recorded
    op keeps the value from before (torch's graph holds the old data).
    A leaf that requires grad may not be written (the JAX package's
    error); under ``no_grad`` it may, and it stays a leaf."""
    d = self._data
    if torch.is_grad_enabled() and out._data.requires_grad and \
            d.requires_grad and d.grad_fn is None:
        raise RuntimeError(
            "a leaf Tensor that requires grad is being used in an "
            "in-place operation; detach() it first or wrap in no_grad()")
    new = out._data
    self._stop_gradient = out._stop_gradient and self._stop_gradient
    if not self._stop_gradient and not new.requires_grad and \
            new.dtype in _DIFF_DTYPES and new is not d:
        # under no_grad: the tensor stays a leaf that takes part
        new = new.detach().requires_grad_(True)
    self._data = new
    self._grad_wrap = None
    return self


def _make_inplace(opdef, api):
    def inplace(self, *args, **kwargs):
        return rebind_inplace(self, api(self, *args, **kwargs))

    inplace.__name__ = opdef.name + "_"
    return inplace


_MAGIC_REFLECTED = {
    "__add__": "__radd__", "__sub__": "__rsub__", "__mul__": "__rmul__",
    "__truediv__": "__rtruediv__", "__floordiv__": "__rfloordiv__",
    "__mod__": "__rmod__", "__pow__": "__rpow__", "__matmul__": "__rmatmul__",
}


def _as_operand(other, like: Tensor) -> Tensor:
    """The left operand of a reflected operator as a Tensor of ``like``'s
    dtype (the JAX package's ``Tensor(other, dtype=self.dtype)``), on
    ``like``'s device."""
    d = like._data
    if isinstance(other, (bool, int, float, complex)):
        return Tensor._from_data(torch.full((), other, dtype=d.dtype,
                                            device=d.device))
    return Tensor(other, dtype=d.dtype, place=like.place)


def build_registry(yaml_entries: Sequence[dict]):
    """Instantiate OpDefs from the yaml manifest + registered emitters,
    export the functional API, and bind Tensor methods."""
    for ent in yaml_entries:
        name = ent["op"]
        if name not in _EMITTERS:
            raise RuntimeError(
                f"ops.yaml declares {name!r} but no emitter is registered")
        emitter = _EMITTERS[name]
        params = list(inspect.signature(emitter).parameters)
        targs = ent.get("tensor_args")
        if targs is None:
            targs = [params[0]] if params else []
        list_args = [a[1:] for a in targs if a.startswith("*")]
        targs = [a.lstrip("*") for a in targs]
        opdef = OpDef(
            name=name,
            emitter=emitter,
            tensor_args=targs,
            list_args=list_args,
            methods=ent.get("methods", [name]),
            magic=ent.get("magic", []),
            inplace=ent.get("inplace", False),
            diff=ent.get("diff", True),
        )
        OPS[name] = opdef
        api = make_api(opdef)
        API[name] = api
        _bind_tensor(opdef, api)
    return API


def _bind_tensor(opdef: OpDef, api: Callable):
    for m in opdef.methods:
        if m and not hasattr(Tensor, m):
            setattr(Tensor, m, api)
    for mg in opdef.magic:
        setattr(Tensor, mg, api)
        refl = _MAGIC_REFLECTED.get(mg)
        if refl:
            def reflected(self, other, _api=api):
                return _api(other if isinstance(other, Tensor)
                            else _as_operand(other, self), self)
            setattr(Tensor, refl, reflected)
    if opdef.inplace:
        setattr(Tensor, opdef.name + "_", _make_inplace(opdef, api))


def get_op(name: str) -> Callable:
    return API[name]
