"""Incubating layers and functions: the fused layers and
``incubate.nn.functional``."""
from paddle_tpu_torch.incubate.nn import functional  # noqa: F401
from paddle_tpu_torch.incubate.nn.layer import (  # noqa: F401
    FusedBiasDropoutResidualLayerNorm, FusedDropout, FusedDropoutAdd,
    FusedEcMoe, FusedFeedForward, FusedLinear, FusedMultiHeadAttention,
    FusedMultiTransformer, FusedTransformerEncoderLayer,
)
