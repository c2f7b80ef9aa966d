"""paddle_tpu_torch.nn.functional (port of
``paddle_tpu/nn/functional/__init__.py``): the op registry's functional
names (the JAX package's ``_F_OPS``), the attention entry points, the
vision and sequence-loss functionals and the long-tail functionals of
:mod:`~paddle_tpu_torch.nn.functional.extras`. Tensor in, Tensor out."""
import torch

from paddle_tpu_torch.core.dtype import to_torch
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops.registry import API as _API

_F_OPS = [
    # activations
    "relu", "relu6", "gelu", "sigmoid", "silu", "swish", "mish", "softplus",
    "softsign", "hardswish", "hardsigmoid", "hardtanh", "leaky_relu", "elu",
    "selu", "celu", "prelu", "glu", "tanhshrink", "hardshrink", "softshrink",
    "thresholded_relu", "softmax", "log_softmax", "gumbel_softmax", "tanh",
    # linear/conv/pool
    "linear", "embedding", "conv1d", "conv2d", "conv3d", "conv2d_transpose",
    "max_pool1d", "max_pool2d", "avg_pool1d", "avg_pool2d",
    "adaptive_avg_pool2d", "adaptive_max_pool2d", "unfold", "pixel_shuffle",
    "interpolate", "pad",
    # norms
    "batch_norm", "layer_norm", "rms_norm", "group_norm", "instance_norm",
    "local_response_norm", "normalize",
    # dropout
    "dropout",
    # losses
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "mse_loss",
    "l1_loss", "smooth_l1_loss", "kl_div", "hinge_loss",
    "margin_ranking_loss", "cosine_similarity", "cosine_embedding_loss",
    "sigmoid_focal_loss",
    # misc
    "one_hot",
]

globals().update({k: _API[k] for k in _F_OPS})

from paddle_tpu_torch.nn.functional.flash_attention import (  # noqa: E402
    flash_attention, flash_attn_unpadded, scaled_dot_product_attention,
)



def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, data_format="NCHW", name=None):
    return _API["interpolate"](x, size=size, scale_factor=scale_factor,
                               mode=mode, align_corners=align_corners)


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    """mask[..., j] = j < lengths[...]; ``maxlen`` defaults to the
    largest length (read on the host)."""
    ldata = lengths._data if isinstance(lengths, Tensor) \
        else torch.as_tensor(lengths)
    m = int(maxlen) if maxlen is not None else int(ldata.max())
    mask = torch.arange(m, device=ldata.device)[None, :] < ldata[..., None]
    return Tensor._from_data(mask.to(to_torch(dtype)))


def label_smooth(label, prior_dist=None, epsilon=0.1):
    n = label.shape[-1]
    if prior_dist is not None:
        return label * (1 - epsilon) + epsilon * prior_dist
    return label * (1 - epsilon) + epsilon / n


def affine_grid(theta, out_shape, align_corners=True, name=None):
    if isinstance(out_shape, Tensor):
        out_shape = [int(v) for v in out_shape.numpy()]
    return _API["affine_grid"](theta, out_shape,
                               align_corners=align_corners)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    return _API["grid_sample"](x, grid, mode=mode,
                               padding_mode=padding_mode,
                               align_corners=align_corners)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC loss with warp-ctc's semantics: ``log_probs`` are UNSCALED
    logits [T, B, C] (the softmax is taken inside); ``"mean"`` divides
    each loss by its label length (at least 1) and averages."""
    loss = _API["warpctc"](log_probs, labels, input_lengths,
                           label_lengths, blank=blank,
                           norm_by_times=norm_by_times)
    if reduction == "mean":
        ll = label_lengths if isinstance(label_lengths, Tensor) \
            else Tensor(label_lengths, place=loss.place)
        return (loss / ll.astype(loss.dtype).clip(min=1)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-T loss: ``input`` [B, Tmax, Umax+1, D] unscaled joint-network
    outputs."""
    loss = _API["rnnt"](input, label, input_lengths, label_lengths,
                        blank=blank, fastemit_lambda=fastemit_lambda)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


__all__ = _F_OPS + ["upsample", "flash_attention", "sequence_mask",
                    "label_smooth", "affine_grid", "grid_sample",
                    "ctc_loss", "rnnt_loss", "flash_attn_unpadded",
                    "scaled_dot_product_attention"]

# the long-tail functionals
from paddle_tpu_torch.nn.functional import extras as _f_extras  # noqa: E402

globals().update(_f_extras.EXPORTS)
__all__ = list(dict.fromkeys(__all__ + list(_f_extras.EXPORTS)))
