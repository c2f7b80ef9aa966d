"""Common layers: Linear, Embedding, the dropouts, Flatten, padding,
upsampling (port of ``paddle_tpu/nn/common.py``). Each wraps the port's
registry ops; the dropouts take one key from the global generator per
call in training (none in eval or at ``p == 0``)."""
from __future__ import annotations

from paddle_tpu_torch import ops
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Flatten", "Pad1D", "Pad2D", "Pad3D", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "Unfold",
           "PixelShuffle", "CosineSimilarity", "PairwiseDistance", "Bilinear"]


class Linear(Layer):
    """``x @ weight + bias`` with the weight laid out [in_features,
    out_features] (paddle's convention)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return ops.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=(getattr(weight_attr, "initializer", None)
                                 if weight_attr else init.Normal(0.0, 1.0)))
        if padding_idx is not None:
            w = self.weight._data.detach().clone()
            w[padding_idx] = 0.0
            self.weight._rebind(w)

    def forward(self, x):
        return ops.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return ops.dropout(x, p=self.p, training=self.training,
                           mode=self.mode, axis=self.axis)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return ops.dropout(x, p=self.p, training=self.training,
                           axis=[0, 1])


class Dropout3D(Dropout2D):
    pass


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        from paddle_tpu_torch.core import generator as gen
        from paddle_tpu_torch.core.tensor import Tensor
        from paddle_tpu_torch.ops.random_ops import bernoulli_bits

        alpha = 1.6732632423543772
        scale = 1.0507009873554805
        alpha_p = -alpha * scale
        keep = 1.0 - self.p
        a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * alpha_p * (1 - keep)
        mask = bernoulli_bits(gen.active_key(), keep, tuple(x.shape),
                              x._data.device)
        mask_t = Tensor._from_data(mask)
        return ops.where(mask_t, x, ops.full_like(x, alpha_p)) * a + b


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return ops.flatten(x, self.start_axis, self.stop_axis)


class _PadND(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format=None,
                 name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value

    def forward(self, x):
        return ops.pad(x, self.padding, mode=self.mode, value=self.value)


class Pad1D(_PadND):
    pass


class Pad2D(_PadND):
    pass


class Pad3D(_PadND):
    pass


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners

    def forward(self, x):
        return ops.interpolate(x, size=self.size,
                               scale_factor=self.scale_factor,
                               mode=self.mode,
                               align_corners=self.align_corners)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, mode="nearest")


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, mode="bilinear",
                         align_corners=True)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return ops.unfold(x, *self.args)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return ops.pixel_shuffle(x, self.upscale_factor)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return ops.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        d = x - y + self.epsilon
        return ops.norm(d, p=self.p, axis=-1, keepdim=self.keepdim)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = (None if bias_attr is False else
                     self.create_parameter([1, out_features], is_bias=True))

    def forward(self, x1, x2):
        o, i, j = self.weight.shape
        tmp = ops.matmul(
            x1, ops.reshape(ops.transpose(self.weight, [1, 0, 2]), [i, o * j]))
        tmp = ops.reshape(tmp, [x1.shape[0], o, j])
        out = ops.sum(tmp * ops.unsqueeze(x2, 1), axis=-1)
        if self.bias is not None:
            out = out + self.bias
        return out
