"""Weight initializers (port of ``paddle_tpu/nn/initializer.py``).

Each call returns a torch tensor of ``shape`` on the default place. A
random initializer takes exactly one key from the global generator and
draws in f32, then casts, as the JAX package does; ``Constant``,
``Assign``, ``Dirac`` and ``Bilinear`` take none. ``Uniform``,
``XavierUniform`` and ``KaimingUniform`` are bit-identical to the JAX
package's under one seed; the normal ones share its uniforms and its
``erf_inv`` polynomial (within an ulp or so, see
:mod:`paddle_tpu_torch.ops.random_ops`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.core import generator as gen
from paddle_tpu_torch.core.dtype import to_torch
from paddle_tpu_torch.core.place import _default_device
from paddle_tpu_torch.ops import threefry
from paddle_tpu_torch.ops.random_ops import (normal_bits,
                                             truncated_normal_bits)

__all__ = [
    "Bilinear", "set_global_initializer",
    "Constant", "Normal", "TruncatedNormal", "Uniform", "XavierNormal",
    "XavierUniform", "KaimingNormal", "KaimingUniform", "Assign", "Dirac",
    "Orthogonal", "calculate_gain",
]


def _scaled(x, std, mean, dtype):
    """``x * std + mean`` as XLA:CPU computes it in f32 (one fused
    multiply-add), cast to ``dtype``."""
    std = float(torch.tensor(std, dtype=torch.float32))
    mean = float(torch.tensor(mean, dtype=torch.float32))
    return (x.double() * std + mean).float().to(to_torch(dtype))


class Initializer:
    def __call__(self, shape, dtype="float32"):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32"):
        return torch.full(tuple(shape), self.value, dtype=to_torch(dtype),
                          device=_default_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32"):
        x = normal_bits(gen.active_key(), tuple(shape),
                        device=_default_device())
        return _scaled(x, self.std, self.mean, dtype)


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype="float32"):
        x = truncated_normal_bits(gen.active_key(), self.a, self.b,
                                  tuple(shape), _default_device())
        return _scaled(x, self.std, self.mean, dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32"):
        x = threefry.uniform(gen.active_key(), tuple(shape), self.low,
                             self.high, device=_default_device())
        return x.to(to_torch(dtype))


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # the Linear weight's layout, [in, out]
        return shape[0], shape[1]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    # a conv weight's layout, [out, in, *k]
    return shape[1] * receptive, shape[0] * receptive


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32"):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        x = normal_bits(gen.active_key(), tuple(shape),
                        device=_default_device())
        return _scaled(x, std, 0.0, dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32"):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        x = threefry.uniform(gen.active_key(), tuple(shape), -limit,
                             limit, device=_default_device())
        return x.to(to_torch(dtype))


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32"):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        std = gain / math.sqrt(fi)
        x = normal_bits(gen.active_key(), tuple(shape),
                        device=_default_device())
        return _scaled(x, std, 0.0, dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32"):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        x = threefry.uniform(gen.active_key(), tuple(shape), -limit,
                             limit, device=_default_device())
        return x.to(to_torch(dtype))


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32"):
        from paddle_tpu_torch.core.tensor import Tensor

        v = self.value
        if isinstance(v, Tensor):
            v = v.numpy()
        elif isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        arr = torch.from_numpy(np.array(v)).to(_default_device(),
                                               to_torch(dtype))
        return arr.reshape(tuple(shape))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype="float32"):
        arr = np.zeros(tuple(shape), dtype=np.float32)
        oc, ic = shape[0], shape[1]
        mins = min(oc // self.groups, ic)
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(mins):
                idx = (g * (oc // self.groups) + i, i, *centers)
                arr[idx] = 1.0
        return torch.from_numpy(arr).to(_default_device(), to_torch(dtype))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32"):
        rows = shape[0]
        cols = 1
        for s in shape[1:]:
            cols *= s
        flat = normal_bits(gen.active_key(),
                           (max(rows, cols), min(rows, cols)),
                           device=_default_device())
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols].reshape(tuple(shape))).to(
            to_torch(dtype))


def calculate_gain(nonlinearity, param=None):
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    return 1.0


class Bilinear(Initializer):
    """The bilinear-interpolation kernel for transposed convs: an
    upsampling layer starts as an exact bilinear interpolator."""

    def __call__(self, shape, dtype="float32"):
        shape = [int(s) for s in shape]
        if len(shape) < 3:
            raise ValueError("Bilinear init needs a conv kernel shape")
        k = shape[-1]
        f = int(np.ceil(k / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        grid = (1 - np.abs(np.arange(k) / f - c))
        kern2d = np.outer(grid, grid) if len(shape) >= 4 else grid
        w = np.zeros(shape, np.float32)
        for i in range(min(shape[0], shape[1])):
            w[i, i] = kern2d
        return torch.from_numpy(w).to(_default_device(), to_torch(dtype))


_GLOBAL_INITIALIZER = {}


def set_global_initializer(weight_init, bias_init=None):
    """The defaults ``create_parameter`` falls back to when no attr or
    initializer is given; every call replaces both (None resets)."""
    _GLOBAL_INITIALIZER.clear()
    if weight_init is not None:
        _GLOBAL_INITIALIZER["weight"] = weight_init
        if bias_init is not None:
            _GLOBAL_INITIALIZER["bias"] = bias_init
