"""paddle_tpu_torch.nn.functional: the op registry's functional names
(the JAX package's ``_F_OPS``, as far as the port has them) and the
attention entry points. Tensor in, Tensor out."""
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

__all__ = _F_OPS + ["flash_attention", "flash_attn_unpadded",
                    "scaled_dot_product_attention"]
