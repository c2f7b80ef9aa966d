"""Activation layers (port of ``paddle_tpu/nn/activation.py``), over the
port's registry ops."""
from __future__ import annotations

from paddle_tpu_torch import ops
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Silu", "Swish", "Mish",
           "Softplus", "Softsign", "Hardswish", "Hardsigmoid", "Hardtanh",
           "LeakyReLU", "ELU", "SELU", "CELU", "PReLU", "GLU", "Tanh",
           "Tanhshrink", "Hardshrink", "Softshrink", "ThresholdedReLU",
           "Softmax", "LogSoftmax", "Maxout", "LogSigmoid"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return ops.relu(x)


class ReLU6(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return ops.relu6(x)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return ops.gelu(x, approximate=self.approximate)


class Sigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return ops.sigmoid(x)


class LogSigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return ops.log(ops.sigmoid(x))


class Silu(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return ops.silu(x)


class Swish(Silu):
    pass


class Mish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return ops.mish(x)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return ops.softplus(x, self.beta, self.threshold)


class Softsign(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return ops.softsign(x)


class Hardswish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return ops.hardswish(x)


class Hardsigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return ops.hardsigmoid(x)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return ops.hardtanh(x, self.min, self.max)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return ops.leaky_relu(x, self.negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return ops.elu(x, self.alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale, self.alpha = scale, alpha

    def forward(self, x):
        return ops.selu(x, self.scale, self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return ops.celu(x, self.alpha)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        from paddle_tpu_torch.nn import initializer as I
        self.weight = self.create_parameter(
            [num_parameters], default_initializer=I.Constant(init))

    def forward(self, x):
        w = self.weight
        if w.size > 1 and x.ndim > 1:
            shape = [1, w.size] + [1] * (x.ndim - 2)
            w = ops.reshape(w, shape)
        return ops.prelu(x, w)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return ops.glu(x, self.axis)


class Tanh(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return ops.tanh(x)


class Tanhshrink(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return ops.tanhshrink(x)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return ops.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return ops.softshrink(x, self.threshold)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return ops.thresholded_relu(x, self.threshold)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return ops.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return ops.log_softmax(x, self.axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups = groups
        self.axis = axis

    def forward(self, x):
        c = x.shape[self.axis]
        g = self.groups
        shape = list(x.shape)
        shape[self.axis] = c // g
        shape.insert(self.axis + 1, g)
        return ops.max(ops.reshape(x, shape), axis=self.axis + 1)
