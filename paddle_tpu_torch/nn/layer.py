"""Layer, the module base class of the Tensor API (port of
``paddle_tpu/nn/layer.py``).

Parameters, sublayers and buffers register by attribute assignment;
``state_dict``, forward pre- and post-hooks and the train/eval mode are
the JAX package's. A :class:`Parameter` is a port :class:`~paddle_tpu_torch.
core.tensor.Tensor` over a torch leaf; in-place ops and ``set_value``
rebind its data and keep the object, so an optimizer given
``layer.parameters()`` follows every update. Parameters are made on the
default place (the card; the CPU after ``set_device("cpu")``).

This is the port's ``nn.Layer``; the port's ``LlamaForCausalLM`` stays a
``torch.nn.Module`` (ROADMAP, by design), which the serving engine, the
``TrainStep`` and the CUDA graphs rest on.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Iterator, Optional, Tuple

import torch

from paddle_tpu_torch.core.dtype import (convert_dtype, get_default_dtype,
                                         to_torch)
from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["Layer", "Parameter", "Sequential", "LayerList", "ParameterList",
           "LayerDict", "Identity"]


class Parameter(Tensor):
    """A trainable Tensor (``stop_gradient=False`` unless ``trainable`` is
    False), persistable. A torch tensor given as ``data`` is taken as it
    is (an initializer's fresh draw), anything else is copied."""

    def __init__(self, data, trainable=True, name=None):
        if isinstance(data, torch.Tensor):
            super().__init__(None, name=name)
            self._data = data.detach()
        else:
            super().__init__(data, name=name)
        if trainable:
            self.stop_gradient = False
        self.persistable = True

    @property
    def trainable(self):
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, v):
        self.stop_gradient = not v


class Layer:
    def __init__(self, name_scope: Optional[str] = None, dtype=None):
        object.__setattr__(self, "_parameters", OrderedDict())
        object.__setattr__(self, "_sub_layers", OrderedDict())
        object.__setattr__(self, "_buffers", OrderedDict())
        self._non_persistable_buffer_names = set()
        self._forward_pre_hooks = OrderedDict()
        self._forward_post_hooks = OrderedDict()
        self.training = True
        self._dtype = convert_dtype(dtype) if dtype else get_default_dtype()
        self._name_scope = name_scope or self.__class__.__name__.lower()

    # -- registration ---------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ before assigning "
                                   "params")
            _strip(self, name)
            params[name] = value
        elif isinstance(value, Layer):
            _strip(self, name)
            layers[name] = value
        elif buffers is not None and name in buffers:
            buffers[name] = value
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    def __delattr__(self, name):
        if not _strip(self, name):
            object.__delattr__(self, name)

    def create_parameter(self, shape, dtype=None, default_initializer=None,
                         attr=None, is_bias=False):
        """A new :class:`Parameter` of ``shape`` from ``attr``'s
        initializer, else ``default_initializer``, else the global one,
        else ``Constant(0)`` for a bias and ``XavierUniform`` for a
        weight; every random initializer takes one key."""
        from paddle_tpu_torch.nn import initializer as init

        dtype = convert_dtype(dtype) if dtype else self._dtype
        if default_initializer is None and attr is not None:
            default_initializer = getattr(attr, "initializer", None)
        if default_initializer is None:
            gi = init._GLOBAL_INITIALIZER
            default_initializer = (
                gi.get("bias") or init.Constant(0.0)) if is_bias else (
                gi.get("weight") or init.XavierUniform())
        p = Parameter(default_initializer(shape, dtype))
        if attr is not None:
            if getattr(attr, "learning_rate", None) is not None:
                p.optimize_attr = {"learning_rate": attr.learning_rate}
            if getattr(attr, "trainable", True) is False:
                p.trainable = False
        return p

    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        _strip(self, name)
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        return tensor

    # -- traversal ------------------------------------------------------
    def named_parameters(self, prefix="", include_sublayers=True
                         ) -> Iterator[Tuple[str, Parameter]]:
        seen = set()
        for name, layer in self.named_sublayers(prefix=prefix,
                                                include_self=True):
            for pname, p in layer._parameters.items():
                if p is not None and id(p) not in seen:
                    seen.add(id(p))
                    yield (f"{name}.{pname}" if name else pname), p
            if not include_sublayers:
                break

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        if layers_set is None:
            layers_set = set()
        if id(self) in layers_set:
            return
        layers_set.add(id(self))
        if include_self:
            yield prefix, self
        for name, layer in self._sub_layers.items():
            if layer is None:
                continue
            sub_prefix = f"{prefix}.{name}" if prefix else name
            yield from layer.named_sublayers(prefix=sub_prefix,
                                             include_self=True,
                                             layers_set=layers_set)

    def sublayers(self, include_self=False):
        return [lyr for _, lyr in
                self.named_sublayers(include_self=include_self)]

    def children(self):
        return iter(lyr for lyr in self._sub_layers.values()
                    if lyr is not None)

    def named_children(self):
        return iter((n, lyr) for n, lyr in self._sub_layers.items()
                    if lyr is not None)

    def named_buffers(self, prefix="", include_sublayers=True):
        for name, layer in self.named_sublayers(prefix=prefix,
                                                include_self=True):
            for bname, b in layer._buffers.items():
                if b is not None:
                    yield (f"{name}.{bname}" if name else bname), b

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers()]

    def apply(self, fn: Callable):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # -- state dict -----------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = destination if destination is not None else OrderedDict()
        for name, p in self.named_parameters():
            dest[structured_name_prefix + name] = p
        for name, layer in self.named_sublayers(include_self=True):
            for bname, b in layer._buffers.items():
                if b is None or \
                        bname in layer._non_persistable_buffer_names:
                    continue
                full = f"{name}.{bname}" if name else bname
                dest[structured_name_prefix + full] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry into the Tensor of the same key (its device and
        dtype kept; the objects stay, so an optimizer still holds them).
        Returns ``(missing, unexpected)`` keys."""
        own = self.state_dict()
        missing, unexpected = [], []
        for k, v in state_dict.items():
            if k in own:
                own[k].set_value(v)
            else:
                unexpected.append(k)
        for k in own:
            if k not in state_dict:
                missing.append(k)
        return missing, unexpected

    load_dict = set_state_dict

    # -- modes ----------------------------------------------------------
    def train(self):
        for layer in self.sublayers(include_self=True):
            layer.training = True
        return self

    def eval(self):
        for layer in self.sublayers(include_self=True):
            layer.training = False
        return self

    # -- conversion ------------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None):
        """Cast the floating parameters and buffers to ``dtype`` and move
        every parameter and buffer to ``device`` (a place or a name), each
        Tensor rebound in place."""
        from paddle_tpu_torch.core.place import Place
        from paddle_tpu_torch.core.tensor import _parse_place

        dev = None
        if device is not None:
            place = device if isinstance(device, Place) else \
                _parse_place(device)
            dev = place.torch_device()
        dt = None if dtype is None else to_torch(convert_dtype(dtype))
        for t in self.parameters() + self.buffers():
            d = t._data
            if dt is not None and t.dtype.is_floating:
                d = d.to(dt)
            if dev is not None:
                d = d.to(dev)
            if d is not t._data:
                t._rebind(d)
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    # -- hooks -----------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        handle = _HookHandle(self._forward_pre_hooks)
        self._forward_pre_hooks[handle.id] = hook
        return handle

    def register_forward_post_hook(self, hook):
        handle = _HookHandle(self._forward_post_hooks)
        self._forward_post_hooks[handle.id] = hook
        return handle

    # -- call ------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            result = hook(self, inputs)
            if result is not None:
                inputs = result if isinstance(result, tuple) else (result,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            result = hook(self, inputs, outputs)
            if result is not None:
                outputs = result
        return outputs

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    def full_name(self):
        return self._name_scope

    def extra_repr(self):
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, layer in self._sub_layers.items():
            mod_str = repr(layer)
            mod_str = "\n  ".join(mod_str.split("\n"))
            lines.append(f"({name}): {mod_str}")
        main = self.__class__.__name__ + "("
        if extra:
            main += extra
        if lines:
            main += "\n  " + "\n  ".join(lines) + "\n"
        return main + ")"


def _strip(layer, name):
    found = False
    for store in ("_parameters", "_sub_layers", "_buffers"):
        d = layer.__dict__.get(store)
        if d is not None and name in d:
            del d[name]
            found = True
    return found


class _HookHandle:
    _next = 0

    def __init__(self, store):
        self.id = _HookHandle._next
        _HookHandle._next += 1
        self._store = store

    def remove(self):
        self._store.pop(self.id, None)


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            for name, layer in layers[0]:
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._sub_layers.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            for i, lyr in enumerate(sublayers):
                self.add_sublayer(str(i), lyr)

    def append(self, layer):
        self.add_sublayer(str(len(self._sub_layers)), layer)
        return self

    def extend(self, layers):
        for lyr in layers:
            self.append(lyr)
        return self

    def insert(self, index, layer):
        items = list(self._sub_layers.values())
        items.insert(index, layer)
        self._sub_layers.clear()
        for i, lyr in enumerate(items):
            self._sub_layers[str(i)] = lyr

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._sub_layers.values())[idx])
        return self._sub_layers[str(idx if idx >= 0 else
                                    len(self._sub_layers) + idx)]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def append(self, p):
        self.add_parameter(str(len(self._parameters)), p)
        return self

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for k, v in items:
            self.add_sublayer(k, v)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._sub_layers[key]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def keys(self):
        return self._sub_layers.keys()

    def items(self):
        return self._sub_layers.items()

    def values(self):
        return self._sub_layers.values()


class Identity(Layer):
    def __init__(self, *a, **k):
        super().__init__()

    def forward(self, x):
        return x
