"""Normalization layers (port of ``paddle_tpu/nn/norm.py``).

BatchNorm keeps its running statistics as buffers: the op returns
``(out, batch_mean, batch_var)`` and the layer rebinds the buffers'
data after each training call, keeping the Tensor objects. ``RMSNorm``
here is the Tensor API's layer; the port's Llama keeps a
``torch.nn.Module`` of its own (``models/llama.py``). ``rms_norm`` is the
raw function that module calls.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.ops.nn_ops import rms_norm  # noqa: F401

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "RMSNorm", "GroupNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LocalResponseNorm", "SpectralNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.use_global_stats = use_global_stats
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=init.Constant(1.0))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter([num_features], attr=bias_attr,
                                              is_bias=True)
        self.register_buffer("_mean", Tensor(
            init.Constant(0.0)([num_features], self._dtype)))
        self.register_buffer("_variance", Tensor(
            init.Constant(1.0)([num_features], self._dtype)))

    def forward(self, x):
        training = self.training and not self.use_global_stats
        out, mean, var = ops.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=training, momentum=self.momentum, epsilon=self.epsilon)
        if training:
            from paddle_tpu_torch.autograd import no_grad

            m = self.momentum
            with no_grad():
                new_mean = self._mean * m + mean.detach() * (1 - m)
                new_var = self._variance * m + var.detach() * (1 - m)
            # the buffers keep their Tensor objects
            self._mean._data = new_mean._data
            self._variance._data = new_var._data
        return out

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BN; on one card the same as BatchNorm (the
    cross-replica statistics come with slice D)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            out = SyncBatchNorm(layer.num_features, layer.momentum,
                                layer.epsilon)
            if layer.weight is not None:
                out.weight.set_value(layer.weight)
                out.bias.set_value(layer.bias)
            out._mean.set_value(layer._mean)
            out._variance.set_value(layer._variance)
        for name, sub in list(layer._sub_layers.items()):
            out._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = (None if weight_attr is False else
                       self.create_parameter(
                           self.normalized_shape, attr=weight_attr,
                           default_initializer=init.Constant(1.0)))
        self.bias = (None if bias_attr is False else
                     self.create_parameter(self.normalized_shape,
                                           attr=bias_attr, is_bias=True))

    def forward(self, x):
        return ops.layer_norm(x, self.weight, self.bias,
                              epsilon=self.epsilon,
                              normalized_shape=self.normalized_shape)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(Layer):
    """RMSNorm over the registry's ``rms_norm`` (normalised in f32, cast
    back to the input's dtype)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=init.Constant(1.0))

    def forward(self, x):
        return ops.rms_norm(x, self.weight, epsilon=self.epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.weight = (None if weight_attr is False else
                       self.create_parameter(
                           [num_channels], attr=weight_attr,
                           default_initializer=init.Constant(1.0)))
        self.bias = (None if bias_attr is False else
                     self.create_parameter([num_channels], attr=bias_attr,
                                           is_bias=True))

    def forward(self, x):
        return ops.group_norm(x, self.num_groups, self.weight, self.bias,
                              epsilon=self.epsilon)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = (None if weight_attr is False else
                       self.create_parameter(
                           [num_features],
                           default_initializer=init.Constant(1.0)))
        self.bias = (None if bias_attr is False else
                     self.create_parameter([num_features], is_bias=True))

    def forward(self, x):
        return ops.instance_norm(x, self.weight, self.bias,
                                 epsilon=self.epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k)

    def forward(self, x):
        return ops.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None, dtype="float32"):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.epsilon = epsilon
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.weight_u = self.create_parameter(
            [h], default_initializer=init.Normal(0.0, 1.0))
        self.weight_u.stop_gradient = True
        self.weight_v = self.create_parameter(
            [w], default_initializer=init.Normal(0.0, 1.0))
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        # the power iteration runs on the data, outside autograd, as the
        # JAX package's does on raw arrays: sigma is a constant of the
        # gradient
        w = weight._data.detach()
        if self.dim != 0:
            perm = [self.dim] + [i for i in range(w.dim()) if i != self.dim]
            w = w.permute(perm)
        h = w.shape[0]
        wm = w.reshape(h, -1)
        u, v = self.weight_u._data.detach(), self.weight_v._data.detach()
        for _ in range(self.power_iters):
            v = wm.T @ u
            v = v / (torch.linalg.norm(v) + self.epsilon)
            u = wm @ v
            u = u / (torch.linalg.norm(u) + self.epsilon)
        self.weight_u._data = u
        self.weight_v._data = v
        sigma = u @ wm @ v
        return weight / Tensor._from_data(sigma)
