"""Conv and pooling layers (port of ``paddle_tpu/nn/conv_pool.py``), over
the port's registry ops. A conv weight draws ``KaimingUniform`` by
default, a transposed conv's ``XavierUniform``."""
from __future__ import annotations

from paddle_tpu_torch import ops
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose", "MaxPool1D",
           "MaxPool2D", "AvgPool1D", "AvgPool2D", "AdaptiveAvgPool2D",
           "AdaptiveMaxPool2D"]


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


class _ConvND(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, nd)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        fan_in = in_channels // groups
        for k in self.kernel_size:
            fan_in *= k
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *self.kernel_size],
            attr=weight_attr,
            default_initializer=(getattr(weight_attr, "initializer", None)
                                 if weight_attr else
                                 init.KaimingUniform(fan_in=fan_in)))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                              is_bias=True)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class Conv2D(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return ops.conv2d(x, self.weight, self.bias, stride=self.stride,
                          padding=self.padding, dilation=self.dilation,
                          groups=self.groups)


class Conv1D(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return ops.conv1d(x, self.weight, self.bias, stride=self.stride,
                          padding=self.padding, dilation=self.dilation,
                          groups=self.groups)


class Conv3D(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return ops.conv3d(x, self.weight, self.bias, stride=self.stride,
                          padding=self.padding, dilation=self.dilation,
                          groups=self.groups)


class Conv2DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        ks = _ntuple(kernel_size, 2)
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = dilation
        self.groups = groups
        self.weight = self.create_parameter(
            [in_channels, out_channels // groups, *ks], attr=weight_attr)
        self.bias = (None if bias_attr is False else
                     self.create_parameter([out_channels], is_bias=True))

    def forward(self, x, output_size=None):
        return ops.conv2d_transpose(
            x, self.weight, self.bias, stride=self.stride,
            padding=self.padding, output_padding=self.output_padding,
            dilation=self.dilation, groups=self.groups)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode

    def forward(self, x):
        return ops.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                              self.ceil_mode)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive

    def forward(self, x):
        return ops.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                              self.ceil_mode, self.exclusive)


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        return ops.max_pool1d(x, *self.args)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, exclusive)

    def forward(self, x):
        return ops.avg_pool1d(x, *self.args)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return ops.adaptive_avg_pool2d(x, self.output_size)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return ops.adaptive_max_pool2d(x, self.output_size)
